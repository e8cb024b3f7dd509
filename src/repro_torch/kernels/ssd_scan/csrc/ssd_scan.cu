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
// Full mode with keep_states also writes h_prev: the backward
// (ssd_scan_bwd.cu) reads the state before each chunk from it.
//
// Layout: x (B, S, H, P), dt (B, S, H) float32, a_log (H,) float32, b and c
// grouped (B, S, G, N) with head h reading group h / (H / G) (no
// head-expanded copy), all contiguous; x, b and c in float32 or bf16 (read
// as such and widened here).  Outputs float32: y (B, S, H, P), h_prev
// (B, nc, H, N, P), h_final (B, H, N, P).  S need not be a multiple of Q:
// rows past S count as dt = 0 (state-neutral) and are neither computed nor
// written, so a 16-token prompt in a 256-row chunk costs 16 rows (rounded
// up to a 64-row tile).
//
// What bounds it on this card: the work is float32 (TF32 would change the
// numbers: copies of this source with TF32 rounding leave the checked
// bound), about 2 Q N + 2 Q P multiply-adds per row over the lower triangle
// plus the state update, on a few MB of operands; it is bound by float32
// operations at 67 T/s, not by bytes.  Plain FMAs, no tensor cores.
//
// Design.  One block of 256 threads per (chunk, batch, head, slice of
// p_block columns of P): the chunks run in parallel, and C B^T is computed
// once per (chunk, head) for the whole slice (p_block = P but where the
// grid would leave SMs empty, as at a 16-token prompt: kernel.py,
// ssd_launch_plan).  A block:
//   1. loads dt, scans the cumulative log decay (one warp) and stages x dt
//      for the chunk in shared memory;
//   2. computes its chunk's state contribution (exp(cum_Q - cum) B)^T (x dt)
//      (N x p_block, over 64-row tiles of B);
//   3. joins the state across chunks: it waits until the block of the chunk
//      before has published h_c, publishes h_{c+1} = exp(cum_Q) h_c +
//      contribution, and keeps h_c for the readout.  The states go through
//      h_prev (split, keep_states) or h_final (full: one slot a head, read
//      before it is overwritten by the same thread);
//   4. computes y one 64-row tile t at a time: per 64-column tile s <= t the
//      masked, decayed C B^T tile (the mask before exp, so no overflow can
//      leak) into shared memory, then its product with x dt; in full mode
//      the readout exp(cum_t) C_t h_c; then writes y.
// Blocks take their (chunk, ...) item from a ticket (an atomic counter) in
// chunk-major order, so the block a block waits on holds a lower ticket and
// is running or done: no deadlock whatever the order the card starts blocks
// in.  The block with the last ticket zeroes the ticket counter, and the
// last chunk's block zeroes its chain counter, so the per-stream counters
// are zero between calls and a call is one launch.
// Register tiling: every product runs in 4 x 4 micro-tiles a thread, four
// k at a time, its operands read from shared memory as float4 (64
// multiply-adds per eight 16-byte loads); the C B^T tile takes its 4
// columns 16 apart so that a warp's loads of B rows hit distinct banks, and
// only as many column groups as the tile has rows (a 16-row prompt takes
// one).  The next B or C tile is loaded into registers, two elements a
// load, while the current one is computed: one tile in flight, so that the
// products' registers fit without spilling (a first version with a C and a
// B tile in flight took 255 registers and spilled).  Sums run in another
// order than the plain version's, so the two agree to a float32 tolerance
// (ssd_scan.ref.ssd_error_bound), not bit for bit.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                         // rows of a staged B or C tile; t, s of C B^T
constexpr int kMaxN = 128;                        // d_state a block takes
constexpr int kMaxStateTile = 8192;               // N x p_block: two micro-tiles a thread
constexpr int kTilePairs = kTile * kMaxN / 2 / kThreads;  // element pairs a thread stages

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float2 widen(float2 v) { return v; }
__device__ __forceinline__ float2 widen(__nv_bfloat162 v) { return __bfloat1622float2(v); }

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
  __device__ static float2 zero() { return make_float2(0.f, 0.f); }
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  __device__ static __nv_bfloat162 zero() { return __floats2bfloat162_rn(0.f, 0.f); }
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared memory in floats: C and B tiles (64 rows of N, padded to N + 4), the
// masked C B^T tile (64 x 68), x dt of the chunk (rows rounded up to 64 x
// p_block), the state h_c (N x p_block), and per row dt / cum and the tail
// weights exp(cum_Q - cum).
__host__ __device__ inline size_t smem_floats(int N, int Q, int p_block) {
  const size_t rows = size_t(round_up(Q, kTile));
  return 2 * size_t(kTile) * (N + 4) + size_t(kTile) * (kTile + 4) + rows * p_block +
         size_t(N) * p_block + 3 * rows;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The walk of a thread over the element pairs of a 64 x N tile, pair e =
// i * kThreads + tid at (row, pair column): rows advance by dr and pair
// columns by dn each step, N / 2 pairs a row.
struct TileWalk {
  int r0, n0, dr, dn, np;
};

// Rows [0, rows) of an operand (row r at src + r * stride elements, N of
// them, N even, every row 2-element aligned) into registers as raw pairs,
// zero past `rows`; widened when stored.
template <typename T>
__device__ __forceinline__ void load_tile(typename Pair<T>::type (&v)[kTilePairs],
                                          const T* __restrict__ src, size_t stride, int rows,
                                          const TileWalk& w) {
  using T2 = typename Pair<T>::type;
  int r = w.r0, n = w.n0;
#pragma unroll
  for (int i = 0; i < kTilePairs; ++i) {
    v[i] = r < rows ? *reinterpret_cast<const T2*>(src + size_t(r) * stride + 2 * n)
                    : Pair<T>::zero();
    n += w.dn;
    r += w.dr;
    if (n >= w.np) {
      n -= w.np;
      ++r;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(const typename Pair<T>::type (&v)[kTilePairs],
                                           float* dst, int ld, const TileWalk& w) {
  int r = w.r0, n = w.n0;
#pragma unroll
  for (int i = 0; i < kTilePairs; ++i) {
    if (r < kTile) *reinterpret_cast<float2*>(dst + r * ld + 2 * n) = widen(v[i]);
    n += w.dn;
    r += w.dr;
    if (n >= w.np) {
      n -= w.np;
      ++r;
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// acc[i][j] += sum_k a[i][k] b[j][k] over k in [0, K), K % 4 == 0: rows i of
// a at a_row + i * lda, rows j of b at b_row + j * ldb_j, both k-contiguous.
template <int JN>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* a_row, int lda,
                                         const float* b_row, int ldb_j, int K) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 av[4], bv[JN];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a_row + i * lda + k);
#pragma unroll
    for (int j = 0; j < JN; ++j) bv[j] = ld4(b_row + j * ldb_j + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        acc[i][j] += av[i].x * bv[j].x;
        acc[i][j] += av[i].y * bv[j].y;
        acc[i][j] += av[i].z * bv[j].z;
        acc[i][j] += av[i].w * bv[j].w;
      }
  }
}

// acc[i][j] += sum_k a[i][k] b[k][j] over k in [0, K), K % 4 == 0: rows i of
// a at a_row + i * lda (k-contiguous), row k of b at b_col + k * ldb (the 4
// columns j contiguous).
__device__ __forceinline__ void mul_tile(float (&acc)[4][4], const float* a_row, int lda,
                                         const float* b_col, int ldb, int K) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a_row + i * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) bv[kk] = ld4(b_col + (k + kk) * ldb);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float a = comp(av[i], kk);
        acc[i][0] += a * bv[kk].x;
        acc[i][1] += a * bv[kk].y;
        acc[i][2] += a * bv[kk].z;
        acc[i][3] += a * bv[kk].w;
      }
  }
}

struct Params {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* b;
  const void* c;
  float* y;
  float* h_prev;
  float* h_final;
  int* counters;  // [0] the ticket, [1 + (b H + h) ps_n + ps] the chains
  int B, S, H, P, G, N, Q, p_block, split;
  int keep;       // the states go through h_prev: split mode, or full mode keeping them
};

// The staged tiles a block takes, in order: its B tiles for the state
// contribution, then per 64-row tile tt of y the C tile and B tiles 0..tt.
// Returns the rows offset of job j's tile and whether it is a C tile.
__device__ __forceinline__ int job_tile(int j, int n_tiles, bool* is_c) {
  *is_c = false;
  if (j < n_tiles) return j * kTile;
  j -= n_tiles;
  int tt = 0;
  while (j >= tt + 2) {
    j -= tt + 2;
    ++tt;
  }
  *is_c = j == 0;
  return (j == 0 ? tt : j - 1) * kTile;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(const Params p) {
  using T2 = typename Pair<T>::type;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = p.N, PB = p.p_block, ld = N + 4, ldc = kTile + 4;
  const int Qr = round_up(p.Q, kTile);
  float* s_c = smem;                      // [64][N + 4]  C rows of the current t tile
  float* s_b = s_c + kTile * ld;          // [64][N + 4]  B rows of the current s tile
  float* s_cb = s_b + kTile * ld;         // [64][68]     masked, decayed C B^T tile
  float* s_xdt = s_cb + kTile * ldc;      // [Qr][PB]     x dt, zero past the rows
  float* s_h = s_xdt + size_t(Qr) * PB;   // [N][PB]      h_c (full mode)
  float* s_dt = s_h + N * PB;             // [Qr]
  float* s_cum = s_dt + Qr;               // [Qr]         cumulative log decay
  float* s_w = s_cum + Qr;                // [Qr]         exp(cum_Q - cum), 0 past the rows
  __shared__ int s_ticket;

  const int tid = threadIdx.x;
  const int ps_n = p.P / PB;
  const int nc = (p.S + p.Q - 1) / p.Q;
  const int per_chunk = p.B * p.H * ps_n;
  if (tid == 0 && nc > 1) {  // one chunk: no block waits on another, the grid order serves
    const int t = atomicAdd(p.counters, 1);
    if (t == nc * per_chunk - 1) atomicExch(p.counters, 0);  // every ticket is taken
    s_ticket = t;
  }
  __syncthreads();
  const int ticket = nc > 1 ? s_ticket : int(blockIdx.x);
  const int ci = ticket / per_chunk;
  int rem = ticket - ci * per_chunk;
  const int bi = rem / (p.H * ps_n);
  rem -= bi * p.H * ps_n;
  const int hd = rem / ps_n;
  const int ps = rem - hd * ps_n;
  const int p0 = ps * PB;
  const int g = hd / (p.H / p.G);
  const int r0 = ci * p.Q;           // first sequence row of the chunk
  const int L = min(p.Q, p.S - r0);  // valid rows
  const int n_tiles = (L + kTile - 1) / kTile;
  const int n_jobs = n_tiles + n_tiles * (n_tiles + 3) / 2;
  const int bc_stride = p.G * N;     // elements between consecutive rows of b / c
  const T* x = static_cast<const T*>(p.x);
  const T* b_rows = static_cast<const T*>(p.b) + (size_t(bi) * p.S + r0) * bc_stride + g * N;
  const T* c_rows = static_cast<const T*>(p.c) + (size_t(bi) * p.S + r0) * bc_stride + g * N;
  const int np = N / 2;
  const TileWalk walk{tid / np, tid % np, kThreads / np, kThreads % np, np};
  T2 regs[kTilePairs];  // the next job's tile, in flight
  int job = 0;
  auto prefetch = [&]() {  // loads job `job`'s tile, if any
    if (job >= n_jobs) return;
    bool is_c;
    const int row = job_tile(job, n_tiles, &is_c);
    load_tile<T>(regs, (is_c ? c_rows : b_rows) + size_t(row) * bc_stride, bc_stride,
                 min(kTile, L - row), walk);
  };
  prefetch();

  // ---- 1. dt, the cumulative log decay, x dt
  const float A = expf(p.a_log[hd]);
  for (int t = tid; t < Qr; t += kThreads) {
    s_dt[t] = t < L ? p.dt[(size_t(bi) * p.S + r0 + t) * p.H + hd] : 0.f;
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
  for (int i = tid; i < Qr * PB; i += kThreads) {
    const int s = i / PB, pc = i - s * PB;
    const size_t xrow = ((size_t(bi) * p.S + r0 + s) * p.H + hd) * p.P + p0;
    s_xdt[i] = s < L ? widen(x[xrow + pc]) * s_dt[s] : 0.f;
  }
  __syncthreads();
  const float cum_q = s_cum[L - 1];
  for (int s = tid; s < Qr; s += kThreads) s_w[s] = s < L ? expf(cum_q - s_cum[s]) : 0.f;

  // ---- 2. the chunk's state contribution, two 4 x 4 micro-tiles (n, p) a thread
  const int pq = PB / 4;  // micro-tile columns of a p_block (4, 8 or 16: it divides kThreads)
  const int n_micro = (N / 4) * pq;
  const int cn = tid / pq, cp = tid - cn * pq;  // micro-tile r at rows (cn + r kThreads / pq) * 4
  const int cn_step = kThreads / pq;
  float cacc[2][4][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cacc[r][i][j] = 0.f;
  for (int st = 0; st < n_tiles; ++st) {
    const int s0 = st * kTile;
    const int kc = round_up(min(kTile, L - s0), 4);
    __syncthreads();  // the previous tile is consumed; s_w is written
    store_tile<T>(regs, s_b, ld, walk);
    ++job;
    prefetch();
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < kc; k += 4) {
      const float4 wv = ld4(s_w + s0 + k);
      float4 xv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        xv[kk] = ld4(s_xdt + (s0 + k + kk) * PB + cp * 4);
        const float wt = comp(wv, kk);
        xv[kk] = make_float4(xv[kk].x * wt, xv[kk].y * wt, xv[kk].z * wt, xv[kk].w * wt);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (tid + r * kThreads < n_micro) {
          const float* b_col = s_b + (cn + r * cn_step) * 4;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 bv = ld4(b_col + (k + kk) * ld);
            const float bn[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              cacc[r][i][0] += bn[i] * xv[kk].x;
              cacc[r][i][1] += bn[i] * xv[kk].y;
              cacc[r][i][2] += bn[i] * xv[kk].z;
              cacc[r][i][3] += bn[i] * xv[kk].w;
            }
          }
        }
      }
    }
  }

  // ---- 3. the state across chunks: wait for h_c, publish h_{c+1}
  int* chain = p.counters + 1 + (bi * p.H + hd) * ps_n + ps;
  const size_t head_state = size_t(N) * p.P;
  float* h_in = p.keep ? p.h_prev + ((size_t(bi) * nc + ci) * p.H + hd) * head_state
                        : p.h_final + (size_t(bi) * p.H + hd) * head_state;
  float* h_out = (p.keep && ci + 1 < nc)
                     ? p.h_prev + ((size_t(bi) * nc + ci + 1) * p.H + hd) * head_state
                     : p.h_final + (size_t(bi) * p.H + hd) * head_state;
  if (tid == 0 && ci > 0) {
    while (ld_acquire(chain) != ci) __nanosleep(100);
    __threadfence();
  }
  __syncthreads();
  const float decay_q = expf(cum_q);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (tid + r * kThreads >= n_micro) continue;
    const int n0 = (cn + r * cn_step) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t at = size_t(n0 + i) * p.P + p0 + cp * 4;
      float4 hc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ci > 0) hc = __ldcg(reinterpret_cast<const float4*>(h_in + at));
      if (p.keep && ci == 0) *reinterpret_cast<float4*>(h_in + at) = hc;  // h_0 = 0
      if (!p.split) *reinterpret_cast<float4*>(s_h + (n0 + i) * PB + cp * 4) = hc;
      const float hcv[4] = {hc.x, hc.y, hc.z, hc.w};
      float hn[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) hn[j] = decay_q * hcv[j] + cacc[r][i][j];
      *reinterpret_cast<float4*>(h_out + at) = make_float4(hn[0], hn[1], hn[2], hn[3]);
    }
  }
  if (nc > 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(chain, ci + 1 < nc ? ci + 1 : 0);  // the last chunk leaves it 0
  }

  // ---- 4. y, one 64-row tile at a time
  const bool y_active = tid < 16 * pq;   // y micro-tiles: 16 row groups x pq column groups
  const int yt = tid / pq, yp = tid - yt * pq;
  const int ty = tid / 16, tx = tid % 16;  // C B^T micro-tile: rows ty * 4 + i, columns tx + 16 j
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int t0 = tt * kTile;
    __syncthreads();  // the previous tile's readout is done with s_c
    store_tile<T>(regs, s_c, ld, walk);
    ++job;
    prefetch();
    float yacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yacc[i][j] = 0.f;
    for (int st = 0; st <= tt; ++st) {
      const int s0 = st * kTile;
      const int cols = min(kTile, L - s0);
      __syncthreads();  // the previous step's tiles are consumed
      store_tile<T>(regs, s_b, ld, walk);
      ++job;
      prefetch();
      __syncthreads();
      // the masked, decayed C B^T tile, as many 16-column groups as the tile has columns
      const int jn = min(4, (cols + 15) / 16);
      if (t0 + ty * 4 < L) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        const float* a_row = s_c + ty * 4 * ld;
        const float* b_row = s_b + tx * ld;
        if (jn == 4) {
          dot_tile<4>(acc, a_row, ld, b_row, 16 * ld, N);
        } else if (jn >= 2) {
          dot_tile<2>(acc, a_row, ld, b_row, 16 * ld, N);
          if (jn == 3) {
            float rest[4][4] = {};
            dot_tile<1>(rest, a_row, ld, b_row + 32 * ld, 16 * ld, N);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][2] = rest[i][0];
          }
        } else {
          dot_tile<1>(acc, a_row, ld, b_row, 16 * ld, N);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tg = t0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sg = s0 + tx + 16 * j;
            // mask before exp: only s <= t is ever exponentiated
            if (j < jn) {
              s_cb[(ty * 4 + i) * ldc + tx + 16 * j] =
                  (sg <= tg && tg < L) ? acc[i][j] * expf(s_cum[tg] - s_cum[sg]) : 0.f;
            }
          }
        }
      }
      __syncthreads();
      // y += C B^T tile @ x dt
      if (y_active && t0 + yt * 4 < L) {
        mul_tile(yacc, s_cb + yt * 4 * ldc, ldc, s_xdt + s0 * PB + yp * 4, PB,
                 round_up(cols, 4));
      }
    }
    if (!y_active || t0 + yt * 4 >= L) continue;
    // the readout exp(cum_t) (C_t @ h_c), full mode after the first chunk (h_0 = 0)
    const bool readout = !p.split && ci > 0;
    float ro[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ro[i][j] = 0.f;
    if (readout) mul_tile(ro, s_c + yt * 4 * ld, ld, s_h + yp * 4, PB, N);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + yt * 4 + i;
      if (t >= L) continue;
      const float et = readout ? expf(s_cum[t]) : 0.f;
      const float4 out = make_float4(yacc[i][0] + et * ro[i][0], yacc[i][1] + et * ro[i][1],
                                     yacc[i][2] + et * ro[i][2], yacc[i][3] + et * ro[i][3]);
      *reinterpret_cast<float4*>(p.y + ((size_t(bi) * p.S + r0 + t) * p.H + hd) * p.P + p0 +
                                 yp * 4) = out;
    }
  }
}

template <typename T>
int launch(const Params& p, int blocks, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.N, p.Q, p.p_block) * sizeof(float);
  auto kernel = ssd_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return int(err);
  kernel<<<blocks, kThreads, bytes, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (kernel.ssd_smem_bytes computes
// the same for the launch plan; the CUDA tests hold the two together).
long long ssd_scan_smem_bytes(int N, int Q, int p_block) {
  return (long long)(smem_floats(N, Q, p_block) * sizeof(float));
}

// x (B, S, H, P), b / c (B, S, G, N): float32 (in_bf16 = 0) or bf16 (1);
// dt (B, S, H), a_log (H,) float32; y (B, S, H, P); h_prev (B, nc, H, N, P)
// when split or keep_states, else unused; h_final (B, H, N, P); counters: 1 + B H (P /
// p_block) int32 zeros, left zero.  p_block (16, 32 or 64) divides P and
// N p_block <= 8192; N % 4 == 0, N <= 128; H % G == 0.  b and c are read
// two elements a load and every output four: b, c and the outputs are
// 16-byte aligned.  Returns a cudaError_t (0 on success).
int ssd_scan(const void* x, const float* dt, const float* a_log, const void* b, const void* c,
             int in_bf16, float* y, float* h_prev, float* h_final, int* counters, int B, int S,
             int H, int P, int G, int N, int Q, int p_block, int split, int keep_states,
             void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G || N < 4 || N % 4 || N > kMaxN || Q < 1 ||
      (p_block != 16 && p_block != 32 && p_block != 64) || P % p_block ||
      N * p_block > kMaxStateTile || counters == nullptr ||
      (reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(c)) % 16)
    return int(cudaErrorInvalidValue);
  const long long blocks = (long long)((S + Q - 1) / Q) * B * H * (P / p_block);
  if (blocks > 2147483647LL) return int(cudaErrorInvalidConfiguration);
  const Params p{x, dt, a_log, b, c, y, h_prev, h_final, counters, B, S, H, P, G, N, Q,
                 p_block, split, int(split || keep_states)};
  auto s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch<__nv_bfloat16>(p, int(blocks), s) : launch<float>(p, int(blocks), s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
