// Fused AMR attention, circuit-replay method, for Hopper (sm_90a), plain C
// interface.  The chain of attn_fused_lut.cu with both products replayed on
// the schedule's reduction circuit instead of gathered from a table, so any
// schedule runs fused, a DSE candidate without a table included:
//
//   acc[t] = sum_d AMR(q[g, m, d] + 128, kt[g, d, t] + 128)             (int32)
//   s, softmax, q_p as in attn_softmax.cuh
//   out[c] = float(sum_t AMR(q_p[t] + 128, v[g, t, c] + 128)) * ps * sv[g, c]
//
// Replaces the JAX package's Pallas kernel
// src/repro/kernels/attn_fused/kernel.py _make_attn_fused_inject_kernel
// (the pallas_call in _attn_fused_inject_jit), which runs _replay_block
// twice back to back on K and V packed outside the kernel.
//
// Design.  One block of 128 threads per (row tile of bm rows, group), in
// sub-tiles of `rows` <= 16 rows as in attn_fused_lut.cu.  Both products run
// replay_device.cuh's tile loop, the device code of the replay matmul
// (inject_replay.cu): the schedule is a program in shared memory, B (K^T,
// then V) is packed into 32-column words inside the block with ballots, and
// each thread adds its (row, word) products into a bit-sliced accumulator.
// A tile is qk_wpb words x qk_rpb rows x the rest of the block's threads as
// k-lanes for QK^T (K = D), pv_wpb x pv_rpb for PV (K = T), as the wrapper's
// block_shape picks them.  The k-lanes' sums meet in shared memory, exact
// modulo 2**32.  QK^T's sums become the masked scores of a float slab of
// rows x T in shared memory, the softmax re-quantizes them in place (one
// warp per row), and PV reads its A operand, the probability indices, from
// the slab.  The word padding of T (the last K^T word) and of P (the last V
// word) reads index 128 and is never written: the kernel returns (G, M, P).
//
// What bounds it on this card: integer and logic operations, the replay's
// per 32-pair word (chip_smoke.replay_ops) for G M ceil(T/32) D words of
// QK^T and G M ceil(P/32) T words of PV.  It takes the replay's loop with
// one item a thread (J = 1): its blocks hold a slab of scores beside the
// wire slots, and more items would multiply the slots.  The LOP3
// immediates and the carry-save accumulator of the shared device code
// apply; each op still waits on the shared-memory loads of its inputs.
#include <cstdint>
#include <cuda_runtime.h>

#include "attn_softmax.cuh"
#include "replay_device.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = 16;

struct Params {
  const int8_t* q;             // (G, M, D)
  const int8_t* kt;            // (G, D, T)
  const int8_t* v;             // (G, T, P)
  const float* sq;             // (G, M)
  const float* sk;             // (G, T)
  const float* sv;             // (G, P)
  const int32_t* mask;         // (G, M, T), 0 = masked
  float* out;                  // (G, M, P)
  const uint32_t* program;     // (n_ops, 2) ops
  const uint32_t* fin;         // (kPos, 2) slots of the final bits by position
  const uint32_t* value_bits;  // (256,) stored bits of each operand index
  int n_ops, n_opbits, n_slots, offset;
  float scale;
  int G, M, D, T, P, bm, rows, qk_wpb, qk_rpb, pv_wpb, pv_rpb;
};

__global__ void __launch_bounds__(kThreads) attn_fused_inject_kernel(const Params p) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_slots = smem;                                   // [slot][thread]
  uint32_t* s_y = s_slots + p.n_slots * kThreads;             // [k-lane][bit][word]
  uint2* s_ops = reinterpret_cast<uint2*>(s_y + kThreads * p.n_opbits);  // kThreads is even
  uint32_t* s_vbits = reinterpret_cast<uint32_t*>(s_ops + p.n_ops);
  uint32_t* s_fin = s_vbits + 256;
  float* s_ps = reinterpret_cast<float*>(s_fin + 2 * replay::kPos);
  float* slab = s_ps + kMaxRows;                              // [rows][T]
  replay::load_program<kThreads>(s_ops, s_vbits, s_fin, p.program, p.n_ops, p.value_bits, p.fin);
  const int tid = threadIdx.x;
  s_slots[tid] = 0u;  // slot 0 is the constant zero word
  const int g = blockIdx.y;
  const int m_begin = blockIdx.x * p.bm;
  const int8_t* kt_g = p.kt + size_t(g) * p.D * p.T;
  const int8_t* v_g = p.v + size_t(g) * p.T * p.P;
  int32_t* s_idx = reinterpret_cast<int32_t*>(slab);

  for (int m0 = m_begin; m0 < m_begin + p.bm; m0 += p.rows) {
    const int nr = min(p.rows, m_begin + p.bm - m0);
    const size_t row0 = size_t(g) * p.M + m0;  // first (g, m) row of the sub-tile

    // 1. QK^T: scores into the slab (replay_tile starts with a barrier, which
    //    orders the previous sub-tile's last reads of the slab before these writes)
    {
      const int wpb = p.qk_wpb, rpb = p.qk_rpb;
      const int n_words = (p.T + 31) / 32;
      for (int word0 = 0; word0 < n_words; word0 += wpb) {
        for (int r0 = 0; r0 < nr; r0 += rpb) {
          const int row = r0 + (tid / wpb) % rpb;
          const bool active = row < nr && word0 + tid % wpb < n_words;
          const int8_t* q_row = p.q + (row0 + (active ? row : 0)) * p.D;
          uint32_t acc[32];
          const uint32_t n_k = replay::replay_tile<kThreads, 1>(
              acc, s_ops, p.n_ops, s_vbits, p.n_opbits, s_fin, s_slots, s_y, wpb, rpb, word0,
              p.T, active, 0, p.D,
              [&](int k) { return int(q_row[k]) + 128; },
              [&](int k, int col) { return int(kt_g[size_t(k) * p.T + col]) + 128; });
          replay::reduce_tile<kThreads, 1>(
              acc, n_k * uint32_t(p.offset), s_slots, wpb, rpb,
              [&](int r, int w, int l, uint32_t sum) {
                const int rr = r0 + r;
                const int t = (word0 + w) * 32 + l;
                if (rr < nr && t < p.T) {
                  slab[rr * p.T + t] = attn::masked_score(
                      int32_t(sum), p.sq[row0 + rr], p.sk[size_t(g) * p.T + t], p.scale,
                      p.mask[(row0 + rr) * p.T + t]);
                }
              });
        }
      }
    }
    __syncthreads();

    // 2. softmax and re-quantization, one warp per row
    for (int r = tid >> 5; r < nr; r += kThreads / 32) {
      const float ps = attn::softmax_requant_row(slab + size_t(r) * p.T, p.T);
      if ((tid & 31) == 0) s_ps[r] = ps;
    }
    __syncthreads();

    // 3. PV: the probability indices against V
    {
      const int wpb = p.pv_wpb, rpb = p.pv_rpb;
      const int n_words = (p.P + 31) / 32;
      for (int word0 = 0; word0 < n_words; word0 += wpb) {
        for (int r0 = 0; r0 < nr; r0 += rpb) {
          const int row = r0 + (tid / wpb) % rpb;
          const bool active = row < nr && word0 + tid % wpb < n_words;
          const int32_t* idx_row = s_idx + (active ? row : 0) * p.T;
          uint32_t acc[32];
          const uint32_t n_k = replay::replay_tile<kThreads, 1>(
              acc, s_ops, p.n_ops, s_vbits, p.n_opbits, s_fin, s_slots, s_y, wpb, rpb, word0,
              p.P, active, 0, p.T,
              [&](int k) { return idx_row[k]; },
              [&](int k, int col) { return int(v_g[size_t(k) * p.P + col]) + 128; });
          replay::reduce_tile<kThreads, 1>(
              acc, n_k * uint32_t(p.offset), s_slots, wpb, rpb,
              [&](int r, int w, int l, uint32_t sum) {
                const int rr = r0 + r;
                const int c = (word0 + w) * 32 + l;
                if (rr < nr && c < p.P) {
                  p.out[(row0 + rr) * p.P + c] = __fmul_rn(
                      __fmul_rn(float(int32_t(sum)), s_ps[rr]), p.sv[size_t(g) * p.P + c]);
                }
              });
        }
      }
    }
  }
}

size_t smem_bytes(int n_slots, int n_opbits, int n_ops, int rows, int T) {
  return sizeof(uint32_t) * (size_t(n_slots) * kThreads + size_t(kThreads) * n_opbits +
                             2 * size_t(n_ops) + 256 + 2 * replay::kPos + kMaxRows +
                             size_t(rows) * T);
}

bool valid_shape(int wpb, int rpb) {
  return wpb >= 1 && rpb >= 1 && (wpb & (wpb - 1)) == 0 && kThreads % (wpb * rpb) == 0;
}

}  // namespace

extern "C" {

// q (G, M, D), kt (G, D, T), v (G, T, P) int8; sq (G, M), sk (G, T),
// sv (G, P) float32; mask (G, M, T) int32; out (G, M, P) float32.  The
// program tables come from replay_program; bm must divide M; rows (1..16)
// is the sub-tile; each (wpb, rpb) must divide the block's 128 threads.
// Returns a cudaError_t (0 on success).
int attn_fused_inject(const int8_t* q, const int8_t* kt, const int8_t* v, const float* sq,
                      const float* sk, const float* sv, const int32_t* mask, float* out,
                      const uint32_t* program, int n_ops, const uint32_t* fin,
                      const uint32_t* value_bits, int n_opbits, int n_slots, int offset,
                      float scale, int G, int M, int D, int T, int P, int bm, int rows,
                      int qk_wpb, int qk_rpb, int pv_wpb, int pv_rpb, void* stream) {
  if (G < 1 || M < 1 || D < 1 || T < 1 || P < 1 || bm < 1 || M % bm != 0 || rows < 1 ||
      rows > kMaxRows || n_ops < 1 || n_opbits < 1 || n_opbits > replay::kMaxOpBits ||
      n_slots < 32 || n_slots > 256 || !valid_shape(qk_wpb, qk_rpb) ||
      !valid_shape(pv_wpb, pv_rpb)) {
    return int(cudaErrorInvalidValue);
  }
  if (G > 65535) return int(cudaErrorInvalidConfiguration);
  const size_t smem = smem_bytes(n_slots, n_opbits, n_ops, rows, T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_fused_inject_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const Params p{q, kt, v, sq, sk, sv, mask, out, program, fin, value_bits, n_ops, n_opbits,
                 n_slots, offset, scale, G, M, D, T, P, bm, rows, qk_wpb, qk_rpb, pv_wpb,
                 pv_rpb};
  const dim3 grid(M / bm, G);
  attn_fused_inject_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
