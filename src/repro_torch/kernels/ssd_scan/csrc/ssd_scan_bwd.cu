// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX package has no backward kernel for
// kernels/ssd_scan (its training differentiates the jnp ssd_chunked of
// src/repro/models/ssm.py with jax.grad).  This is the gradient of
// ssd_scan.cu's forward, in both of its modes.  Per chunk of L rows, with
// u = x dt, la = -A dt (A = exp(a_log)), cum = cumsum(la) over the chunk,
// e_t = exp(cum_t), w_s = exp(cum_L - cum_s), the state h_c before the
// chunk (saved by the forward) and D the gradient of the state after it:
//
//   intra   M = (C B^T) o tril exp(cum_t - cum_s),  y += M u
//           dM = dy u^T (lower triangle);  du += M^T dy;
//           dC += (dM o dec) B;  dB += (dM o dec)^T C;  dseg = dM o M:
//           dcum_t += sum_s dseg_ts,  dcum_s -= sum_t dseg_ts
//   readout (full mode)  y_t += e_t C_t h_c:
//           dC_t += e_t h_c dy_t;  dcum_t += e_t C_t . (h_c dy_t)
//   state   h_{c+1} = exp(cum_L) h_c + sum_s w_s B_s u_s^T:
//           dB_s += w_s D u_s;  du_s += w_s D^T B_s;  V_s = w_s B_s . (D u_s):
//           dcum_s -= V_s,  dcum_L += sum_s V_s + exp(cum_L) <D, h_c>
//   join    dL/dh_c = dh_prev_c (split mode) + sum_t e_t C_t dy_t^T (full
//           mode) + exp(cum_L) D, and D = dL/dh_{c+1}, dh_final for the last
//           chunk: the reverse recurrence across chunks
//   then    dla = reverse cumsum of dcum within the chunk; ddt = du . x - A
//           dla; dx = du dt; da_log = -A sum dt dla.
//
// Layout as the forward's: x (B, S, H, P), dt (B, S, H) float32, a_log (H,)
// float32, b and c grouped (B, S, G, N), head h reading group h / (H / G);
// x, b and c float32 or bf16.  Gradients in: dy (B, S, H, P), dh_prev (B,
// nc, H, N, P) in split mode, dh_final (B, H, N, P), all float32, and the
// forward's h_prev (B, nc, H, N, P).  Out: dx (B, S, H, P) in x's dtype, ddt
// (B, S, H) float32, da_log's per-block partials (nc, B, H), and db and dc
// per head, (B, S, H, N) float32, which the wrapper sums over the heads of a
// group in a fixed order (as jax.grad sums jnp.repeat's copies) before the
// cast to b's dtype; the gradient of each (chunk, state) passes through a
// scratch dstates (B, nc, H, N, P).  Rows past S are neither read nor
// written.
//
// What bounds it on this card: float32 operations (about 2.4 times the
// forward's: the lower triangle's C B^T and dy u^T dots, each recomputed
// once, and its three products into dC, dB and du, plus four L N P
// products for the state and the readout), on a few MB of operands: 67 T/s.
// Plain FMAs, no tensor cores, as the forward (TF32 would change the
// numbers).
//
// Design (a first, simple version: operands read from shared memory one
// float a load, so the loads, not the FMAs, set its pace).  One block of
// 256 threads per (chunk, batch, head), all of P.  A block:
//   1. loads dt and scans cum (one warp), as the forward;
//   2. full mode: R = sum_t e_t C_t dy_t^T over 64-row tiles (N x P, in
//      registers);
//   3. joins the state gradient across chunks, last chunk first: it waits
//      until the block of the chunk after it has published D, writes
//      dL/dh_c = dh_prev_c + R + exp(cum_L) D to dstates and publishes it;
//   4. pass A, per 64-row tile t: the readout's dC and dcum, then per tile
//      s <= t the masked tiles (C B^T and dy u^T recomputed, the mask before
//      exp) into dC and the row sums of dseg; writes dC;
//   5. pass B, per 64-row tile s: the state terms with D, then per tile t
//      >= s the same masked tiles into dB and du and the column sums of
//      dseg; writes dB and dx;
//   6. the reverse cumsum of dcum (one warp), ddt and da_log's partial.
// Blocks take their item from a ticket (an atomic counter) last chunk
// first, so the block a block waits on holds a lower ticket and is running
// or done.  The block with the last ticket zeroes the ticket counter, and
// the first chunk's block zeroes its chain counter: the counters are zero
// between calls and a call is one launch.  Every sum runs in a fixed order
// (each row of dcum is owned by one thread; block-wide sums are taken by
// one thread in index order; no float atomics), so a call gives the same
// bits every time.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // rows of a staged tile; t, s of the masked tiles
constexpr int kMaxN = 128;            // d_state a block takes
constexpr int kMaxP = 64;             // head_dim a block takes
constexpr int kLdT = kTile + 1;       // leading dimension of a 64 x 64 tile
constexpr int kPartCols = kMaxN / 4;  // per-row partials: one per 4-column group

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared memory in floats: C and B tiles (64 x (N + 1)), dy and x dt tiles
// (64 x (P + 1)), the dCB, M and dseg tiles (64 x 65), h_c or D (N x (P +
// 1)), five per-row arrays (dt, cum, dcum, du . x, V), the per-row partials
// (64 x 32) and one float a thread for block sums.
__host__ __device__ inline size_t smem_floats(int N, int P, int Q) {
  const size_t rows = size_t(round_up(Q, kTile));
  return 2 * size_t(kTile) * (N + 1) + 2 * size_t(kTile) * (P + 1) + 3 * size_t(kTile) * kLdT +
         size_t(N) * (P + 1) + 5 * rows + size_t(kTile) * kPartCols + kThreads;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// acc[i][j] += sum_{k < K} a[i * a_i + k * a_k] * b[k * b_k + j * b_j]: one
// 4 x 4 micro-tile of a product, operands from shared memory at any strides
// (so one routine takes a tile and its transpose).
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* a, int a_i, int a_k,
                                   const float* b, int b_k, int b_j, int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[i * a_i + k * a_k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[k * b_k + j * b_j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R][4][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][i][j] = 0.f;
}

struct Params {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* b;
  const void* c;
  const float* dy;
  const float* dh_prev;   // split mode only
  const float* dh_final;
  const float* h_prev;    // the forward's state before each chunk
  void* dx;
  float* ddt;
  float* da_part;         // (nc, B, H)
  float* dbh;             // (B, S, H, N)
  float* dch;             // (B, S, H, N)
  float* dstates;         // (B, nc, H, N, P) scratch
  int* counters;          // [0] the ticket, [1 + b H + h] the chains
  int B, S, H, P, G, N, Q, split;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_bwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = p.N, P = p.P, ldn = N + 1, ldp = P + 1;
  const int Qr = round_up(p.Q, kTile);
  float* s_c = smem;                       // [64][N + 1]  C rows of a t tile
  float* s_b = s_c + kTile * ldn;          // [64][N + 1]  B rows of an s tile
  float* s_dy = s_b + kTile * ldn;         // [64][P + 1]  dy rows of a t tile
  float* s_u = s_dy + kTile * ldp;         // [64][P + 1]  x dt rows of an s tile
  float* s_dcb = s_u + kTile * ldp;        // [64][65]     dM o dec, (t, s)
  float* s_m = s_dcb + kTile * kLdT;       // [64][65]     M
  float* s_dseg = s_m + kTile * kLdT;      // [64][65]     dM o M
  float* s_hd = s_dseg + kTile * kLdT;     // [N][P + 1]   h_c (pass A), D (pass B)
  float* s_dt = s_hd + N * ldp;            // [Qr]
  float* s_cum = s_dt + Qr;                // [Qr]
  float* s_dcum = s_cum + Qr;              // [Qr]  dL/dcum, then dL/dla
  float* s_dux = s_dcum + Qr;              // [Qr]  du . x
  float* s_v = s_dux + Qr;                 // [Qr]  V_s
  float* s_part = s_v + Qr;                // [64][32]  per-row partials
  float* s_red = s_part + kTile * kPartCols;  // [256]
  __shared__ int s_ticket;
  __shared__ float s_dq;  // dL/dcum_L beyond dcum's rows: the join and sum V

  const int tid = threadIdx.x;
  const int nc = (p.S + p.Q - 1) / p.Q;
  const int per_chunk = p.B * p.H;
  if (tid == 0 && nc > 1) {  // one chunk: no block waits on another, the grid order serves
    const int t = atomicAdd(p.counters, 1);
    if (t == nc * per_chunk - 1) atomicExch(p.counters, 0);  // every ticket is taken
    s_ticket = t;
  }
  __syncthreads();
  const int ticket = nc > 1 ? s_ticket : int(blockIdx.x);
  const int rank = ticket / per_chunk;  // chunks are handed out last first
  const int ci = nc - 1 - rank;
  const int rem = ticket - rank * per_chunk;
  const int bi = rem / p.H, hd = rem - bi * p.H;
  const int g = hd / (p.H / p.G);
  const int r0 = ci * p.Q;
  const int L = min(p.Q, p.S - r0);
  const int n_tiles = (L + kTile - 1) / kTile;
  const size_t row0 = size_t(bi) * p.S + r0;  // sequence row of the chunk's first row
  const T* x = static_cast<const T*>(p.x);
  const T* bsrc = static_cast<const T*>(p.b);
  const T* csrc = static_cast<const T*>(p.c);
  // offsets of (row r of the chunk, column) in the (B, S, H, P), (B, S, G, N)
  // and (B, S, H, N) arrays
  auto at_x = [&](int r, int col) { return ((row0 + r) * p.H + hd) * size_t(P) + col; };
  auto at_bc = [&](int r, int col) { return ((row0 + r) * p.G + g) * size_t(N) + col; };
  auto at_h = [&](int r, int col) { return ((row0 + r) * p.H + hd) * size_t(N) + col; };

  // rows [base, base + 64) of the chunk into a tile, zero past L; c scaled
  // by e_t where asked
  auto stage_bc = [&](float* dst, const T* src, int base, bool by_e) {
    for (int e = tid; e < kTile * N; e += kThreads) {
      const int r = e / N, col = e - r * N;
      float v = 0.f;
      if (base + r < L) {
        v = widen(src[at_bc(base + r, col)]);
        if (by_e) v *= expf(s_cum[base + r]);
      }
      dst[r * ldn + col] = v;
    }
  };
  auto stage_u = [&](int base) {
    for (int e = tid; e < kTile * P; e += kThreads) {
      const int r = e / P, col = e - r * P;
      s_u[r * ldp + col] = base + r < L ? widen(x[at_x(base + r, col)]) * s_dt[base + r] : 0.f;
    }
  };
  auto stage_dy = [&](int base) {
    for (int e = tid; e < kTile * P; e += kThreads) {
      const int r = e / P, col = e - r * P;
      s_dy[r * ldp + col] = base + r < L ? p.dy[at_x(base + r, col)] : 0.f;
    }
  };
  // the masked tiles of the pair (t tile at t0 in s_c / s_dy, s tile at s0
  // in s_b / s_u): one 4 x 4 micro-tile a thread, rows t0 + ty * 4 + i,
  // columns s0 + tx * 4 + j; the mask before exp
  auto masked_tiles = [&](int t0, int s0) {
    const int ty = tid % 16, tx = tid / 16;
    float cb[4][4], dyu[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cb[i][j] = dyu[i][j] = 0.f;
    mm(cb, s_c + ty * 4 * ldn, ldn, 1, s_b + tx * 4 * ldn, 1, ldn, N);
    mm(dyu, s_dy + ty * 4 * ldp, ldp, 1, s_u + tx * 4 * ldp, 1, ldp, P);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tl = ty * 4 + i, t = t0 + tl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sl = tx * 4 + j, s = s0 + sl;
        const float dec = (s <= t && t < L) ? expf(s_cum[t] - s_cum[s]) : 0.f;
        const float m = cb[i][j] * dec;
        s_m[tl * kLdT + sl] = m;
        s_dcb[tl * kLdT + sl] = dyu[i][j] * dec;
        s_dseg[tl * kLdT + sl] = dyu[i][j] * m;
      }
    }
  };
  // sums of the per-row partials of rows [base, base + 64) over `cols`
  // column groups, in order, by the row's owner thread (tid < 64)
  auto row_partials = [&](int cols) {
    float sum = 0.f;
    for (int k = 0; k < cols; ++k) sum += s_part[tid * kPartCols + k];
    return sum;
  };

  // ---- 1. dt, the cumulative log decay
  const float A = expf(p.a_log[hd]);
  for (int t = tid; t < Qr; t += kThreads) {
    s_dt[t] = t < L ? p.dt[(row0 + t) * p.H + hd] : 0.f;
    s_cum[t] = 0.f;
    s_dcum[t] = 0.f;
    s_dux[t] = 0.f;
    s_v[t] = 0.f;
  }
  __syncthreads();
  if (tid < 32) {  // inclusive scan of la = -A dt by warp 0, 32 rows at a time
    const int lane = tid;
    float carry = 0.f;
    for (int base = 0; base < L; base += 32) {
      const int t = base + lane;
      float v = t < L ? -A * s_dt[t] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      if (t < L) s_cum[t] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const float cum_q = s_cum[L - 1];
  const float decay_q = expf(cum_q);
  const bool readout = !p.split && ci > 0;  // h_0 = 0: the first chunk reads out nothing

  // ---- 2. R = sum_t e_t C_t dy_t^T, N x P micro-tiles (rows n, columns p)
  const int rg_np = N / 4;
  const int n_np = (N / 4) * (P / 4);
  float racc[2][4][4];
  zero(racc);
  if (readout) {
    for (int tt = 0; tt < n_tiles; ++tt) {
      const int t0 = tt * kTile;
      const int kt = min(kTile, L - t0);
      __syncthreads();
      stage_bc(s_c, csrc, t0, true);
      stage_dy(t0);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = tid + r * kThreads;
        if (m < n_np) {
          const int rg = m % rg_np, cg = m / rg_np;
          mm(racc[r], s_c + rg * 4, 1, ldn, s_dy + cg * 4, ldp, 1, kt);
        }
      }
    }
  }

  // ---- 3. the state gradient across chunks, last chunk first
  int* chain = p.counters + 1 + bi * p.H + hd;
  const size_t hs = size_t(N) * P;
  const size_t head = (size_t(bi) * p.H + hd) * hs;
  const size_t slot = ((size_t(bi) * nc + ci) * p.H + hd) * hs;
  const float* d_src = ci + 1 < nc ? p.dstates + ((size_t(bi) * nc + ci + 1) * p.H + hd) * hs
                                   : p.dh_final + head;
  if (tid == 0 && ci + 1 < nc) {
    while (ld_acquire(chain) != rank) __nanosleep(100);
    __threadfence();
  }
  __syncthreads();
  float dot = 0.f;  // this thread's share of <D, h_c>
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = tid + r * kThreads;
    if (m >= n_np) continue;
    const int rg = m % rg_np, cg = m / rg_np;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t at = size_t(rg * 4 + i) * P + cg * 4;
      const float4 d = __ldcg(reinterpret_cast<const float4*>(d_src + at));
      const float dv[4] = {d.x, d.y, d.z, d.w};
      float hv[4] = {0.f, 0.f, 0.f, 0.f}, pv[4] = {0.f, 0.f, 0.f, 0.f};
      if (ci > 0) {
        const float4 h = *reinterpret_cast<const float4*>(p.h_prev + slot + at);
        hv[0] = h.x, hv[1] = h.y, hv[2] = h.z, hv[3] = h.w;
        if (p.split) {
          const float4 q = *reinterpret_cast<const float4*>(p.dh_prev + slot + at);
          pv[0] = q.x, pv[1] = q.y, pv[2] = q.z, pv[3] = q.w;
        }
      }
      float gv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dot = fmaf(dv[j], hv[j], dot);
        gv[j] = racc[r][i][j] + decay_q * dv[j] + pv[j];
      }
      if (ci > 0)  // the first chunk's state is 0: nothing reads its gradient
        *reinterpret_cast<float4*>(p.dstates + slot + at) = make_float4(gv[0], gv[1], gv[2], gv[3]);
    }
  }
  if (nc > 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(chain, ci > 0 ? rank + 1 : 0);  // the first chunk leaves it 0
  }
  s_red[tid] = dot;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int k = 0; k < kThreads; ++k) sum += s_red[k];
    s_dq = decay_q * sum;
  }

  // ---- 4. pass A: dC, the readout's and the row sums' dcum
  if (readout) {
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P, col = e - n * P;
      s_hd[n * ldp + col] = p.h_prev[slot + e];
    }
  }
  const int n_n = 4 * N;  // 4 x 4 micro-tiles of a 64 x N output: rg = m % 16, cg = m / 16
  const int n_p = 4 * P;  // of a 64 x P output (at most one a thread)
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int t0 = tt * kTile;
    __syncthreads();
    stage_bc(s_c, csrc, t0, false);
    stage_dy(t0);
    __syncthreads();
    float cacc[2][4][4];
    zero(cacc);
    if (readout) {  // Z = dy h_c^T: dC_t += e_t Z_t, dcum_t += e_t C_t . Z_t
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = tid + r * kThreads;
        if (m >= n_n) continue;
        const int rg = m % 16, cg = m / 16;
        mm(cacc[r], s_dy + rg * 4 * ldp, ldp, 1, s_hd + cg * 4 * ldp, 1, ldp, P);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tl = rg * 4 + i;
          float sp = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) sp = fmaf(cacc[r][i][j], s_c[tl * ldn + cg * 4 + j], sp);
          s_part[tl * kPartCols + cg] = sp;
          const float et = t0 + tl < L ? expf(s_cum[t0 + tl]) : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) cacc[r][i][j] *= et;
        }
      }
      __syncthreads();
      if (tid < kTile && t0 + tid < L) s_dcum[t0 + tid] += expf(s_cum[t0 + tid]) * row_partials(N / 4);
    }
    for (int st = 0; st <= tt; ++st) {
      const int s0 = st * kTile;
      const int ks = round_up(min(kTile, L - s0), 4);
      __syncthreads();
      stage_bc(s_b, bsrc, s0, false);
      stage_u(s0);
      __syncthreads();
      masked_tiles(t0, s0);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = tid + r * kThreads;
        if (m < n_n) {
          const int rg = m % 16, cg = m / 16;
          mm(cacc[r], s_dcb + rg * 4 * kLdT, kLdT, 1, s_b + cg * 4, ldn, 1, ks);
        }
      }
      if (tid < kTile) {
        float sum = 0.f;
        for (int k = 0; k < ks; ++k) sum += s_dseg[tid * kLdT + k];
        s_dcum[t0 + tid] += sum;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = tid + r * kThreads;
      if (m >= n_n) continue;
      const int rg = m % 16, cg = m / 16;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + rg * 4 + i;
        if (t < L)
          *reinterpret_cast<float4*>(p.dch + at_h(t, cg * 4)) =
              make_float4(cacc[r][i][0], cacc[r][i][1], cacc[r][i][2], cacc[r][i][3]);
      }
    }
  }

  // ---- 5. pass B: the state terms with D, dB, du and the column sums' dcum
  __syncthreads();
  for (int e = tid; e < N * P; e += kThreads) {
    const int n = e / P, col = e - n * P;
    s_hd[n * ldp + col] = __ldcg(d_src + e);
  }
  T* dx = static_cast<T*>(p.dx);
  for (int st = 0; st < n_tiles; ++st) {
    const int s0 = st * kTile;
    __syncthreads();
    stage_bc(s_b, bsrc, s0, false);
    stage_u(s0);
    __syncthreads();
    float bacc[2][4][4], uacc[4][4];
    zero(bacc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) uacc[i][j] = 0.f;
    // Y2 = u D^T (dB_s = w_s Y2_s, V_s = w_s B_s . Y2_s) and B D (du_s = w_s B_s D)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = tid + r * kThreads;
      if (m >= n_n) continue;
      const int rg = m % 16, cg = m / 16;
      mm(bacc[r], s_u + rg * 4 * ldp, ldp, 1, s_hd + cg * 4 * ldp, 1, ldp, P);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int sl = rg * 4 + i;
        float sp = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) sp = fmaf(bacc[r][i][j], s_b[sl * ldn + cg * 4 + j], sp);
        s_part[sl * kPartCols + cg] = sp;
        const float w = s0 + sl < L ? expf(cum_q - s_cum[s0 + sl]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) bacc[r][i][j] *= w;
      }
    }
    if (tid < n_p) {
      const int rg = tid % 16, cg = tid / 16;
      mm(uacc, s_b + rg * 4 * ldn, ldn, 1, s_hd + cg * 4, ldp, 1, N);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + rg * 4 + i;
        const float w = s < L ? expf(cum_q - s_cum[s]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) uacc[i][j] *= w;
      }
    }
    __syncthreads();
    if (tid < kTile && s0 + tid < L) {
      const float v = expf(cum_q - s_cum[s0 + tid]) * row_partials(N / 4);
      s_v[s0 + tid] = v;
      s_dcum[s0 + tid] -= v;
    }
    for (int tt = st; tt < n_tiles; ++tt) {
      const int t0 = tt * kTile;
      const int kt = round_up(min(kTile, L - t0), 4);
      __syncthreads();
      stage_bc(s_c, csrc, t0, false);
      stage_dy(t0);
      __syncthreads();
      masked_tiles(t0, s0);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = tid + r * kThreads;
        if (m < n_n) {
          const int rg = m % 16, cg = m / 16;
          mm(bacc[r], s_dcb + rg * 4, 1, kLdT, s_c + cg * 4, ldn, 1, kt);
        }
      }
      if (tid < n_p) {
        const int rg = tid % 16, cg = tid / 16;
        mm(uacc, s_m + rg * 4, 1, kLdT, s_dy + cg * 4, ldp, 1, kt);
      }
      if (tid < kTile) {
        float sum = 0.f;
        for (int k = 0; k < kt; ++k) sum += s_dseg[k * kLdT + tid];
        s_dcum[s0 + tid] -= sum;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = tid + r * kThreads;
      if (m >= n_n) continue;
      const int rg = m % 16, cg = m / 16;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + rg * 4 + i;
        if (s < L)
          *reinterpret_cast<float4*>(p.dbh + at_h(s, cg * 4)) =
              make_float4(bacc[r][i][0], bacc[r][i][1], bacc[r][i][2], bacc[r][i][3]);
      }
    }
    __syncthreads();  // the column sums are done with s_part's rows
    if (tid < n_p) {  // dx = du dt, and du . x per row
      const int rg = tid % 16, cg = tid / 16;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int sl = rg * 4 + i, s = s0 + sl;
        float sp = 0.f;
        if (s < L) {
          const float dts = s_dt[s];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const size_t at = at_x(s, cg * 4 + j);
            sp = fmaf(uacc[i][j], widen(x[at]), sp);
            dx[at] = narrow<T>(uacc[i][j] * dts);
          }
        }
        s_part[sl * kPartCols + cg] = sp;
      }
    }
    __syncthreads();
    if (tid < kTile && s0 + tid < L) s_dux[s0 + tid] = row_partials(P / 4);
  }

  // ---- 6. dla = reverse cumsum of dcum; ddt, da_log's partial
  __syncthreads();
  if (tid == 0) {
    float sum = s_dq;
    for (int s = 0; s < L; ++s) sum += s_v[s];
    s_dcum[L - 1] += sum;
  }
  __syncthreads();
  if (tid < 32) {  // inclusive suffix scan by warp 0, 32 rows at a time from the end
    const int lane = tid;
    float carry = 0.f;
    for (int base = (L - 1) / 32 * 32; base >= 0; base -= 32) {
      const int t = base + lane;
      float v = t < L ? s_dcum[t] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, v, o);
        if (lane + o < 32) v += u;
      }
      v += carry;
      if (t < L) s_dcum[t] = v;
      carry = __shfl_sync(0xffffffffu, v, 0);
    }
  }
  __syncthreads();
  for (int t = tid; t < L; t += kThreads) p.ddt[(row0 + t) * p.H + hd] = s_dux[t] - A * s_dcum[t];
  if (tid == 0) {
    float sum = 0.f;
    for (int t = 0; t < L; ++t) sum = fmaf(s_dt[t], s_dcum[t], sum);
    p.da_part[(size_t(ci) * p.B + bi) * p.H + hd] = -A * sum;
  }
}

template <typename T>
int launch(const Params& p, int blocks, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.N, p.P, p.Q) * sizeof(float);
  auto kernel = ssd_scan_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return int(err);
  kernel<<<blocks, kThreads, bytes, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (kernel.ssd_bwd_smem_bytes
// computes the same; the CUDA tests hold the two together).
long long ssd_scan_bwd_smem_bytes(int N, int P, int Q) {
  return (long long)(smem_floats(N, P, Q) * sizeof(float));
}

// x (B, S, H, P), b / c (B, S, G, N): float32 (in_bf16 = 0) or bf16 (1); dt
// (B, S, H), a_log (H,) float32; dy (B, S, H, P), dh_prev (B, nc, H, N, P)
// (split = 1; else unused), dh_final (B, H, N, P), h_prev (B, nc, H, N, P),
// all float32.  Out: dx (x's dtype), ddt (B, S, H), da_part (nc, B, H), dbh
// and dch (B, S, H, N), float32; dstates (B, nc, H, N, P) float32 scratch;
// counters: 1 + B H int32 zeros, left zero.  N % 4 == 0, N <= 128; P % 4 ==
// 0, P <= 64; H % G == 0.  The state arrays, dbh and dch are read or written
// four floats a access: 16-byte aligned.  Returns a cudaError_t (0 on
// success).
int ssd_scan_bwd(const void* x, const float* dt, const float* a_log, const void* b,
                 const void* c, int in_bf16, const float* dy, const float* dh_prev,
                 const float* dh_final, const float* h_prev, void* dx, float* ddt,
                 float* da_part, float* dbh, float* dch, float* dstates, int* counters, int B,
                 int S, int H, int P, int G, int N, int Q, int split, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G || N < 4 || N % 4 || N > kMaxN || P < 4 ||
      P % 4 || P > kMaxP || Q < 1 || counters == nullptr || (split && dh_prev == nullptr) ||
      (reinterpret_cast<uintptr_t>(dh_final) | reinterpret_cast<uintptr_t>(h_prev) |
       reinterpret_cast<uintptr_t>(dbh) | reinterpret_cast<uintptr_t>(dch) |
       reinterpret_cast<uintptr_t>(dstates) | reinterpret_cast<uintptr_t>(dh_prev)) % 16)
    return int(cudaErrorInvalidValue);
  const long long blocks = (long long)((S + Q - 1) / Q) * B * H;
  if (blocks > 2147483647LL) return int(cudaErrorInvalidConfiguration);
  const Params p{x,  dt,      a_log,   b,   c,       dy, dh_prev, dh_final, h_prev,
                 dx, ddt,     da_part, dbh, dch,     dstates, counters, B, S, H, P, G, N, Q,
                 split};
  auto s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch<__nv_bfloat16>(p, int(blocks), s) : launch<float>(p, int(blocks), s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
