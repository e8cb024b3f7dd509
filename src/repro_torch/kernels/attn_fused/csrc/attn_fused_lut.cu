// Fused AMR attention, full-table method, for Hopper (sm_90a), plain C
// interface.  Per group g and query row m:
//
//   acc[t]  = sum_d LUT[q[g, m, d] + 128, kt[g, d, t] + 128]            (int32)
//   s[t]    = float(acc[t]) * sq[g, m] * sk[g, t] / scale, NEG_INF where
//             mask[g, m, t] == 0;  softmax;  int8 re-quantization
//             q_p[t] = clip(rint(p[t] / ps), -128, 127),  ps = max|p| / 127
//   out[c]  = float(sum_t LUT[q_p[t] + 128, v[g, t, c] + 128]) * ps * sv[g, c]
//
// Replaces the JAX package's Pallas kernel
// src/repro/kernels/attn_fused/kernel.py _attn_fused_lut_kernel (the
// pallas_call in _attn_fused_lut_jit), which holds T, D and P whole in
// VMEM.  The float chain between the products is attn_softmax.cuh's, bit
// for bit the plain version's (kernels/attn_fused/ref.py).
//
// Design.  One block of 512 threads per (row tile of bm rows, group); it
// runs its rows in sub-tiles of R in {1, 2, 4, 8, 16} rows (a template
// parameter, chosen by the wrapper to fit shared memory; rows are
// independent, so neither bm nor R changes a bit).  Per sub-tile:
//   1. QK^T: thread t owns score column t (T in steps of 512) and the
//      sub-tile's rows in registers; the q rows sit in shared memory and are
//      read at one address per warp, the K^T column is read from device
//      memory once per sub-tile, up to 8 bytes ahead of their gathers so
//      that the loads overlap (neighbouring threads, neighbouring bytes).  The
//      rescaled, masked scores go to a float slab of R x T in shared memory:
//      4 T bytes a row, 32 KB at gemma-2b's 8192-token context.
//   2. softmax: one warp per row over its slab row (max, expf, the lane-order
//      sum, then p and its int8 index, written back into the slab).  The
//      softmax is not online: T is streamed through the products, never
//      through the softmax, so the float sums keep the plain version's order.
//   3. PV: thread c owns output column c for one of 512 / P slices of T (P
//      in steps of 512); the slab's indices are read at one address per
//      warp, V's rows from device memory ahead.  The slices' int32 sums
//      meet in shared-memory atomics, exact in any order: PV accumulates the
//      re-quantized probabilities in exact int32.
// The table (kernel_table) is gathered through the read-only path, as in
// lut_matmul.cu: int16 (128 KB, stays in L1) while every product fits
// (border <= 13), int32 otherwise.  (lut_matmul.cu measured the int16 table
// staged in shared memory slower than this path; here shared memory also
// holds the score slab.)
//
// What bounds it on this card: one table gather and one int32 add per
// product, D + P products per score; the int8 operands, the int32 mask and
// the scales are read once.  At decode shapes (8 rows, a long cache) the
// grid is small (G * M / bm blocks, 16 at gemma-2b's 2-slot decode), and
// each block runs T * (D + P) gathers of its row alone, latency-bound.  (A
// first version with 256 threads, all 16 row registers live and no loads
// ahead took 7.7 ms at T = 8192 on an H100 80GB HBM3 at 700 W, slower than
// its plain version; PERF.md.)
#include <cstdint>
#include <cuda_runtime.h>

#include "attn_softmax.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxRows = 16;  // rows of a sub-tile, held in registers

// B bytes loaded ahead of their gathers: about 16 independent gathers in
// flight per thread whatever the row count, in the registers that two
// blocks per SM leave a thread (64).
template <int R>
constexpr int kAhead = R >= 8 ? 16 / R : 8;

struct Params {
  const int8_t* q;       // (G, M, D)
  const int8_t* kt;      // (G, D, T)
  const int8_t* v;       // (G, T, P)
  const float* sq;       // (G, M)
  const float* sk;       // (G, T)
  const float* sv;       // (G, P)
  const int32_t* mask;   // (G, M, T), 0 = masked
  const void* table;     // (256, 256) int16 or int32
  float* out;            // (G, M, P)
  float scale;
  int G, M, D, T, P, bm, rows;
};

// acc[r] += sum_{k in [k0, k1)} table[a_index(r, k) * 256 + b[k * stride] + 128]
// for the R rows r < nr, with the B bytes loaded kAhead<R> at a time.
template <int R, typename TT, typename AIndex>
__device__ __forceinline__ void gather_rows(int32_t (&acc)[R], const TT* __restrict__ table,
                                            const int8_t* b, size_t stride, int k0, int k1,
                                            int nr, AIndex a_index) {
  constexpr int A = kAhead<R>;
  int k = k0;
  for (; k + A <= k1; k += A) {
    int col[A];
#pragma unroll
    for (int j = 0; j < A; ++j) col[j] = int(b[size_t(k + j) * stride]) + 128;
#pragma unroll
    for (int j = 0; j < A; ++j) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) acc[r] += int32_t(__ldg(table + a_index(r, k + j) * 256 + col[j]));
      }
    }
  }
  for (; k < k1; ++k) {
    const int col = int(b[size_t(k) * stride]) + 128;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) acc[r] += int32_t(__ldg(table + a_index(r, k) * 256 + col));
    }
  }
}

template <int R, typename TT>
__global__ void __launch_bounds__(kThreads, 2) attn_fused_lut_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* slab = reinterpret_cast<float*>(smem4);              // [R][T]
  float* s_ps = slab + size_t(R) * p.T;                       // [kMaxRows]
  int32_t* s_acc = reinterpret_cast<int32_t*>(s_ps + kMaxRows);  // [R][P]
  int8_t* s_q = reinterpret_cast<int8_t*>(s_acc + size_t(R) * p.P);  // [R][D]
  const TT* __restrict__ table = static_cast<const TT*>(p.table);
  const int tid = threadIdx.x;
  const int g = blockIdx.y;
  const int m_begin = blockIdx.x * p.bm;
  const int8_t* kt_g = p.kt + size_t(g) * p.D * p.T;
  const int8_t* v_g = p.v + size_t(g) * p.T * p.P;
  const int32_t* s_idx = reinterpret_cast<const int32_t*>(slab);
  // PV: `cols` columns a pass, the block's threads in `slices` slices of T
  const int cols = min(p.P, kThreads);
  const int slices = kThreads / cols;
  const int slice = tid / cols;
  const int t_chunk = (p.T + slices - 1) / slices;

  for (int m0 = m_begin; m0 < m_begin + p.bm; m0 += R) {
    const int nr = min(R, m_begin + p.bm - m0);
    const size_t row0 = size_t(g) * p.M + m0;  // first (g, m) row of the sub-tile
    __syncthreads();  // the previous sub-tile is done with shared memory
    for (int i = tid; i < nr * p.D; i += kThreads) s_q[i] = p.q[row0 * p.D + i];
    for (int i = tid; i < nr * p.P; i += kThreads) s_acc[i] = 0;
    __syncthreads();

    // 1. scores into the slab
    for (int t = tid; t < p.T; t += kThreads) {
      int32_t acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0;
      gather_rows<R>(acc, table, kt_g + t, size_t(p.T), 0, p.D, nr,
                     [&](int r, int d) { return int(s_q[r * p.D + d]) + 128; });
      const float sk = p.sk[size_t(g) * p.T + t];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) {
          slab[r * p.T + t] = attn::masked_score(acc[r], p.sq[row0 + r], sk, p.scale,
                                                 p.mask[(row0 + r) * p.T + t]);
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

    // 3. PV from the probability indices, slices of T joined in shared memory
    if (slice < slices) {
      const int t0 = slice * t_chunk;
      const int t1 = min(p.T, t0 + t_chunk);
      for (int c = tid % cols; c < p.P; c += cols) {
        int32_t acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0;
        gather_rows<R>(acc, table, v_g + c, size_t(p.P), t0, t1, nr,
                       [&](int r, int t) { return s_idx[r * p.T + t]; });
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < nr) atomicAdd(s_acc + r * p.P + c, acc[r]);
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < nr * p.P; i += kThreads) {
      const int r = i / p.P;
      const int c = i % p.P;
      p.out[(row0 + r) * p.P + c] =
          __fmul_rn(__fmul_rn(float(s_acc[i]), s_ps[r]), p.sv[size_t(g) * p.P + c]);
    }
  }
}

size_t smem_bytes(int rows, int T, int D, int P) {
  return sizeof(float) * (size_t(rows) * (T + P) + kMaxRows) + size_t(rows) * D;
}

template <int R, typename TT>
int launch_rows(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(R, p.T, p.D, p.P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_fused_lut_kernel<R, TT>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid(p.M / p.bm, p.G);
  attn_fused_lut_kernel<R, TT><<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename TT>
int launch_typed(const Params& p, cudaStream_t stream) {
  switch (p.rows) {
    case 1: return launch_rows<1, TT>(p, stream);
    case 2: return launch_rows<2, TT>(p, stream);
    case 4: return launch_rows<4, TT>(p, stream);
    case 8: return launch_rows<8, TT>(p, stream);
    case 16: return launch_rows<16, TT>(p, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (G, M, D), kt (G, D, T), v (G, T, P) int8; sq (G, M), sk (G, T),
// sv (G, P) float32; mask (G, M, T) int32; table (256, 256) int16 or int32;
// out (G, M, P) float32.  bm must divide M; rows (1, 2, 4, 8 or 16) is the
// sub-tile.
// Returns a cudaError_t (0 on success).
int attn_fused_lut(const int8_t* q, const int8_t* kt, const int8_t* v, const float* sq,
                   const float* sk, const float* sv, const int32_t* mask, const void* table,
                   int table_int16, float* out, float scale, int G, int M, int D, int T, int P,
                   int bm, int rows, void* stream) {
  if (G < 1 || M < 1 || D < 1 || T < 1 || P < 1 || bm < 1 || M % bm != 0 || rows < 1 ||
      rows > kMaxRows) {
    return int(cudaErrorInvalidValue);
  }
  if (G > 65535) return int(cudaErrorInvalidConfiguration);
  const Params p{q, kt, v, sq, sk, sv, mask, table, out, scale, G, M, D, T, P, bm, rows};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return table_int16 ? launch_typed<int16_t>(p, s) : launch_typed<int32_t>(p, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
