// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface.
//
// Replaces the JAX package's Pallas kernel
//   src/repro/kernels/ssd_scan/kernel.py  _ssd_kernel
// which runs one grid cell per (batch, head, chunk) with the chunk axis
// sequential and the (N, P) state carried in VMEM scratch.  Per chunk of Q
// rows, with la = -exp(a_log) dt and cum = cumsum(la) over the chunk:
//
//   y  = (C B^T . tril exp(cum_t - cum_s)) @ (x dt)  [+ exp(cum) (C @ h)]
//   h <- exp(cum_Q) h + (exp(cum_Q - cum) B)^T @ (x dt)
//
// Two modes.  full: y with the bracketed readout, and the final state.
// split: y without the readout, the state before every chunk (h_prev) and
// the final state; the caller then reads the state out through the AMR
// numerics seam (site ssm.scan), as the JAX package's ssd_chunked does.
//
// Layout: x (B, S, H, P), dt (B, S, H) float32, a_log (H,) float32, b and c
// grouped (B, S, G, N) with head h reading group h / (H / G) (no
// head-expanded copy), all contiguous; x, b and c in float32 or bf16 (read
// as such and widened here).  Outputs float32: y (B, S, H, P), h_prev
// (B, nc, H, N, P), h_final (B, H, N, P).  S need not be a multiple of Q:
// rows past S count as dt = 0 (state-neutral) and are neither computed nor
// written, so a 16-token prompt in a 256-row chunk costs 16 rows.
//
// What bounds it on this card: the work is float32 (TF32 would change the
// numbers), about 2 Q N + 2 Q P multiply-adds per row over the lower
// triangle plus the state update, on a few MB of operands; it is bound by
// float32 operations at 67 T/s, not by bytes.  This first version uses
// plain FMAs from shared memory, no tensor cores.
//
// Design: one block of 256 threads per (16-column slice of P, head, batch),
// grid (P/16, H, B): 128 blocks at B = 1, H = 32, P = 64, against 32 for a
// block per (batch, head).  The chunk axis is a loop inside the block, and
// the block's (N, 16) state slice stays in shared memory across chunks.
// Each block recomputes its own C B^T tiles (the P slices share them), so
// the C B^T work is done P/16 times.  Rows t and columns s <= t are tiled
// 32 x 32: per tile the masked, decayed C B^T tile goes to shared memory
// (the mask is applied before exp, so no overflow can leak), then is
// multiplied into the block's y rows.  Shared rows are padded by one word
// so that the warps' strided reads hit distinct banks.  Sums run in another
// order than the plain version's, so the two agree to a float32 tolerance,
// not bit for bit.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPB = 16;  // columns of P per block
constexpr int kT = 32;   // rows t and columns s per tile

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Smem {
  float* c;      // [kT][N + 1]   C rows of the current t tile
  float* bt;     // [N][kT + 1]   B of the current s tile, transposed
  float* cb;     // [kT][kT + 1]  masked, decayed C B^T tile
  float* xdt;    // [Qr][kPB]     x dt of the chunk (then tail-weighted), zero past the rows
  float* cum;    // [Q]           cumulative log decay
  float* dt;     // [Q]
  float* h;      // [N][kPB]      carried state slice
  float* hacc;   // [N][kPB]      this chunk's state contribution
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

__host__ __device__ inline size_t smem_floats(int N, int Q) {
  return size_t(kT) * (N + 1) + size_t(N) * (kT + 1) + size_t(kT) * (kT + 1) +
         size_t(round_up(Q, kT)) * kPB + 2 * size_t(Q) + 2 * size_t(N) * kPB;
}

template <typename T>
__device__ __forceinline__ void load_bt(const Smem& sm, const T* __restrict__ b, size_t row0,
                                        int row_stride, int rows, int N) {
  // bt[n][s] = b[row0 + s * row_stride + n] for s < rows, else 0
  for (int i = threadIdx.x; i < kT * N; i += kThreads) {
    const int s = i / N, n = i % N;
    sm.bt[n * (kT + 1) + s] = s < rows ? widen(b[row0 + size_t(s) * row_stride + n]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ b,
                const T* __restrict__ c, float* __restrict__ y, float* __restrict__ h_prev,
                float* __restrict__ h_final, int S, int H, int P, int G, int N, int Q,
                int split) {
  extern __shared__ float smem[];
  Smem sm;
  sm.c = smem;
  sm.bt = sm.c + kT * (N + 1);
  sm.cb = sm.bt + N * (kT + 1);
  sm.xdt = sm.cb + kT * (kT + 1);
  sm.cum = sm.xdt + round_up(Q, kT) * kPB;
  sm.dt = sm.cum + Q;
  sm.h = sm.dt + Q;
  sm.hacc = sm.h + N * kPB;

  const int p0 = blockIdx.x * kPB;
  const int hd = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = hd / (H / G);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nc = (S + Q - 1) / Q;
  const float A = expf(a_log[hd]);
  const int bc_stride = G * N;  // elements between consecutive rows of b / c

  for (int i = tid; i < N * kPB; i += kThreads) sm.h[i] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const int r0 = ci * Q;             // first sequence row of the chunk
    const int L = min(Q, S - r0);      // valid rows
    const int Lr = round_up(L, kT);
    __syncthreads();  // the previous chunk is done with every buffer

    for (int t = tid; t < L; t += kThreads) sm.dt[t] = dt[(size_t(bi) * S + r0 + t) * H + hd];
    __syncthreads();
    if (tid < 32) {  // inclusive scan of la = -A dt by warp 0, 32 rows at a time
      float carry = 0.f;
      for (int base = 0; base < L; base += 32) {
        const int t = base + lane;
        float v = t < L ? -A * sm.dt[t] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (t < L) sm.cum[t] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    for (int i = tid; i < Lr * kPB; i += kThreads) {
      const int t = i / kPB, p = i % kPB;
      sm.xdt[i] = t < L ? widen(x[((size_t(bi) * S + r0 + t) * H + hd) * P + p0 + p]) * sm.dt[t]
                        : 0.f;
    }
    __syncthreads();

    // ---- y rows, one 32-row tile at a time
    for (int tt0 = 0; tt0 < L; tt0 += kT) {
      const int rows = min(kT, L - tt0);
      __syncthreads();  // the previous tile's C rows are consumed
      for (int i = tid; i < kT * N; i += kThreads) {
        const int t = i / N, n = i % N;
        sm.c[t * (N + 1) + n] =
            t < rows ? widen(c[(size_t(bi) * S + r0 + tt0 + t) * bc_stride + g * N + n]) : 0.f;
      }
      const int ty = tid / kPB, p = tid % kPB;  // y rows ty, ty + 16; column p
      float yacc[2] = {0.f, 0.f};
      for (int ts0 = 0; ts0 <= tt0; ts0 += kT) {
        const int cols = min(kT, L - ts0);
        __syncthreads();  // the previous C B^T tile is consumed
        load_bt(sm, b, (size_t(bi) * S + r0 + ts0) * bc_stride + g * N, bc_stride, cols, N);
        __syncthreads();
        {
          const int s = lane, t0 = tid / 32;  // rows t0 + 8 j
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int n = 0; n < N; ++n) {
            const float bv = sm.bt[n * (kT + 1) + s];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] += sm.c[(t0 + 8 * j) * (N + 1) + n] * bv;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = t0 + 8 * j;
            const int tg = tt0 + t, sg = ts0 + s;
            // mask before exp: only s <= t is ever exponentiated
            sm.cb[t * (kT + 1) + s] = (sg <= tg && t < rows && s < cols)
                                          ? acc[j] * expf(sm.cum[tg] - sm.cum[sg])
                                          : 0.f;
          }
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t = ty + 16 * j;
          float acc = 0.f;
#pragma unroll 8
          for (int s = 0; s < kT; ++s) acc += sm.cb[t * (kT + 1) + s] * sm.xdt[(ts0 + s) * kPB + p];
          yacc[j] += acc;
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = ty + 16 * j;
        if (t >= rows) continue;
        float out = yacc[j];
        if (!split) {  // the inter-chunk readout exp(cum_t) (C_t @ h)
          float acc = 0.f;
          for (int n = 0; n < N; ++n) acc += sm.c[t * (N + 1) + n] * sm.h[n * kPB + p];
          out += expf(sm.cum[tt0 + t]) * acc;
        }
        y[((size_t(bi) * S + r0 + tt0 + t) * H + hd) * P + p0 + p] = out;
      }
    }
    __syncthreads();

    // ---- state: h <- exp(cum_Q) h + sum_s exp(cum_Q - cum_s) B_s (x dt)_s
    const float cum_q = sm.cum[L - 1];
    if (split) {
      float* dst = h_prev + ((size_t(bi) * nc + ci) * H + hd) * N * P + p0;
      for (int i = tid; i < N * kPB; i += kThreads) dst[(i / kPB) * P + i % kPB] = sm.h[i];
    }
    for (int i = tid; i < L * kPB; i += kThreads) sm.xdt[i] *= expf(cum_q - sm.cum[i / kPB]);
    for (int i = tid; i < N * kPB; i += kThreads) sm.hacc[i] = 0.f;
    for (int ts0 = 0; ts0 < L; ts0 += kT) {
      const int cols = min(kT, L - ts0);
      __syncthreads();  // xdt is scaled; the previous B tile is consumed
      load_bt(sm, b, (size_t(bi) * S + r0 + ts0) * bc_stride + g * N, bc_stride, cols, N);
      __syncthreads();
      for (int i = tid; i < N * kPB; i += kThreads) {
        const int n = i / kPB, p = i % kPB;
        float acc = 0.f;
#pragma unroll 8
        for (int s = 0; s < kT; ++s) acc += sm.bt[n * (kT + 1) + s] * sm.xdt[(ts0 + s) * kPB + p];
        sm.hacc[i] += acc;
      }
    }
    const float decay_q = expf(cum_q);
    for (int i = tid; i < N * kPB; i += kThreads) sm.h[i] = decay_q * sm.h[i] + sm.hacc[i];
  }
  __syncthreads();
  float* dst = h_final + (size_t(bi) * H + hd) * N * P + p0;
  for (int i = tid; i < N * kPB; i += kThreads) dst[(i / kPB) * P + i % kPB] = sm.h[i];
}

template <typename T>
int launch(const void* x, const float* dt, const float* a_log, const void* b, const void* c,
           float* y, float* h_prev, float* h_final, int B, int S, int H, int P, int G, int N,
           int Q, int split, cudaStream_t stream) {
  const size_t bytes = smem_floats(N, Q) * sizeof(float);
  auto kernel = ssd_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(P / kPB, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(b), static_cast<const T*>(c),
      y, h_prev, h_final, S, H, P, G, N, Q, split);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (the wrapper checks it against the card).
long long ssd_scan_smem_bytes(int N, int Q) {
  return (long long)(smem_floats(N, Q) * sizeof(float));
}

// x (B, S, H, P), b / c (B, S, G, N): float32 (in_bf16 = 0) or bf16 (1);
// dt (B, S, H), a_log (H,) float32; y (B, S, H, P); h_prev (B, nc, H, N, P)
// when split, else unused; h_final (B, H, N, P).  P % 16 == 0, H % G == 0.
// Returns a cudaError_t (0 on success).
int ssd_scan(const void* x, const float* dt, const float* a_log, const void* b, const void* c,
             int in_bf16, float* y, float* h_prev, float* h_final, int B, int S, int H, int P,
             int G, int N, int Q, int split, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < kPB || P % kPB || G < 1 || H % G || N < 1 || Q < 1 ||
      H > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return launch<__nv_bfloat16>(x, dt, a_log, b, c, y, h_prev, h_final, B, S, H, P, G, N, Q,
                                 split, s);
  }
  return launch<float>(x, dt, a_log, b, c, y, h_prev, h_final, B, S, H, P, G, N, Q, split, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
