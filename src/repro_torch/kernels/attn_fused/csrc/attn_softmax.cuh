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

// One warp, one row: s[0, T) holds the row's masked scores; afterwards
// s[t] holds, as an int, the probability's operand index q + 128.
// Returns the row's probability scale ps.
__device__ __forceinline__ float softmax_requant_row(float* s, int T) {
  const int lane = threadIdx.x & 31;
  float mx = __int_as_float(int(0xff800000u));  // -inf
  for (int t = lane; t < T; t += 32) mx = fmaxf(mx, s[t]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
  float sum = 0.0f;
  for (int t = lane; t < T; t += 32) {
    const float e = expf(__fsub_rn(s[t], mx));
    s[t] = e;
    sum = __fadd_rn(sum, e);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xFFFFFFFFu, sum, o));
  const float amax = __fdiv_rn(1.0f, sum);
  const float ps = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  int32_t* idx = reinterpret_cast<int32_t*>(s);
  for (int t = lane; t < T; t += 32) {
    const float p = __fdiv_rn(s[t], sum);
    const float q = fminf(fmaxf(rintf(__fdiv_rn(p, ps)), -128.0f), 127.0f);
    idx[t] = int32_t(q) + 128;
  }
  return ps;
}

}  // namespace attn
