// The float32 chain between the two products of the fused AMR attention
// kernels (attn_fused_lut.cu, attn_fused_inject.cu): the rescaled and masked
// scores, the softmax, and the int8 re-quantization of the probabilities.
//
// Every step is written out in the order of the plain version
// (kernels/attn_fused/ref.py, softmax_requant), with the rounding of each
// operation explicit (__fmul_rn and friends: nothing contracts into an FMA),
// so the kernels and their plain version agree bit for bit:
//
//   s    = float(acc) * sq * sk / scale;  s = keep ? s : NEG_INF
//   max  = the row's max (exact in any order)
//   e    = expf(s - max)        (the accurate expf that torch.exp runs on the
//                                card; the build has no --use_fast_math)
//   sum  = the row sum in a fixed order: lane j of a warp adds columns j,
//          j + 32, j + 64, ... in increasing order, then an xor-16/8/4/2/1
//          butterfly joins the 32 lane sums.  Float addition is commutative,
//          so the butterfly gives every lane the bits of the halving
//          x[:16] + x[16:], x[:8] + x[8:], ... that the plain version runs.
//          The order depends on T alone: not on the row tile, not on how
//          the products tile T.
//   p    = e / sum
//   ps   = max(amax, 1e-8) / 127,  amax = fl(1 / sum)
//   q    = clip(rint(p / ps), -128, 127)
//
// The pieces (row_max, row_exp_sum, prob_scale, prob_index) also serve a
// kernel that splits the steps over blocks: each step keeps its order.
//
// amax, the row's largest probability, is fl(1 / sum) exactly: the largest
// score gives e = expf(0) = 1, and a correctly rounded division is monotone,
// so no other e / sum rounds above 1 / sum.  (A fully masked row has every
// s = NEG_INF, every e = 1 and p = fl(1 / T).)  So the scale is known as
// soon as the sum is, and the probabilities are never stored as floats.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace attn {

constexpr float kNegInf = -2.0e38f;  // the models' mask fill, bit for bit

__device__ __forceinline__ float masked_score(int32_t acc, float sq, float sk, float scale,
                                              int32_t keep) {
  const float s = __fdiv_rn(__fmul_rn(__fmul_rn(float(acc), sq), sk), scale);
  return keep != 0 ? s : kNegInf;
}

// e = exp(s - mx), the accurate expf
__device__ __forceinline__ float row_exp(float s, float mx) {
  const float e = expf(__fsub_rn(s, mx));
  return e;
}

// A warp's 32 lane sums joined by the butterfly: every lane gets the row sum.
__device__ __forceinline__ float warp_sum(float sum) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xFFFFFFFFu, sum, o));
  return sum;
}

// The row's probability scale ps from its sum (amax = fl(1 / sum)).
__device__ __forceinline__ float prob_scale(float sum) {
  const float amax = __fdiv_rn(1.0f, sum);
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
}

// A probability's operand index q + 128 from its e, the row sum and ps.
__device__ __forceinline__ int32_t prob_index(float e, float sum, float ps) {
  const float p = __fdiv_rn(e, sum);
  const float q = fminf(fmaxf(rintf(__fdiv_rn(p, ps)), -128.0f), 127.0f);
  return int32_t(q) + 128;
}

constexpr int kBatch = 16;  // a lane's loads in flight on a row in L2

// use(t, s[t]) for this lane's columns t = lane, lane + 32, ... < T in
// increasing order, B loads at a time: kBatch for a row another block
// wrote (a split tail), read through L2 (__ldcg), never L1; 1 for a row in
// shared memory (the batched loop cost the fused inject kernel's
// whole-tile blocks 1.5% at the served shapes on an H100, PERF.md).
template <int B, typename Use>
__device__ __forceinline__ void lane_columns(const float* s, int T, Use use) {
  int t = threadIdx.x & 31;
  if constexpr (B > 1) {
    for (; t + 32 * (B - 1) < T; t += 32 * B) {
      float x[B];
#pragma unroll
      for (int i = 0; i < B; ++i) x[i] = __ldcg(s + t + 32 * i);
#pragma unroll
      for (int i = 0; i < B; ++i) use(t + 32 * i, x[i]);
    }
    for (; t < T; t += 32) use(t, __ldcg(s + t));
  } else {
    for (; t < T; t += 32) use(t, s[t]);
  }
}

// One warp, one row of T masked scores: their max (exact in any order).
template <int B>
__device__ __forceinline__ float row_max(const float* s, int T) {
  float mx = __int_as_float(int(0xff800000u));  // -inf
  lane_columns<B>(s, T, [&](int, float x) { mx = fmaxf(mx, x); });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
  return mx;
}

// One warp, one row: the sum of e = row_exp(s, mx) in the fixed order
// (STORE: e written over s).
template <bool STORE, int B>
__device__ __forceinline__ float row_exp_sum(float* s, int T, float mx) {
  float sum = 0.0f;
  lane_columns<B>(s, T, [&](int t, float x) {
    const float e = row_exp(x, mx);
    if constexpr (STORE) s[t] = e;
    sum = __fadd_rn(sum, e);
  });
  return warp_sum(sum);
}

// One warp, one row: s[0, T) holds the row's masked scores; afterwards
// s[t] holds, as an int, the probability's operand index q + 128.
// Returns the row's probability scale ps.
template <int B>
__device__ __forceinline__ float softmax_requant_row(float* s, int T) {
  const float mx = row_max<B>(s, T);
  const float sum = row_exp_sum<true, B>(s, T, mx);
  const float ps = prob_scale(sum);
  int32_t* idx = reinterpret_cast<int32_t*>(s);
  lane_columns<B>(s, T, [&](int t, float e) { idx[t] = prob_index(e, sum, ps); });
  return ps;
}

}  // namespace attn
