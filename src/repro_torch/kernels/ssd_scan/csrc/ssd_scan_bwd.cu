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
// What bounds it on this card: float32 operations, on a few MB of
// operands: 67 T/s.  Per (chunk, head) the lower triangle's C B^T and dy
// u^T dots and its three products into dC, dB and du (64^2 (3 N + 2 P)
// multiply-adds a pair of 64-row tiles), plus four L N P products for the
// state and the readout.  Plain FMAs, no tensor cores, as the forward (TF32
// would change the numbers).  The FMAs read their operands from shared
// memory, which serves 128 bytes a clock to an SM's 128 FMA lanes: a 4 x 4
// register tile loads 8 floats a lane per 16 FMAs, so the loops run at about
// half the FMA rate at best; the design keeps the tiles that large and the
// loads free of bank conflicts.
//
// Design.  One block of 256 threads per (chunk, batch, head), all of P; two
// blocks an SM.  A block:
//   1. loads dt and scans cum (one warp), as the forward;
//   2. full mode: one pass over 32-row t tiles of e_t C and dy: R = sum_t
//      e_t C_t dy_t^T (N x P, in registers), and the readout's dC (the first
//      write of those rows) and dcum;
//   3. joins the state gradient across chunks, last chunk first: it waits
//      until the block of the chunk after it has published D, writes
//      dL/dh_c = dh_prev_c + R + exp(cum_L) D to dstates and publishes it;
//   4. per 64-row s tile (B_s, x_s and D loaded together, then staged): the
//      state terms with D into dB_s and du_s (register tiles for the whole
//      s loop), then per 32-row t tile with t >= s each masked tile computed
//      once: C B^T on warps 0-3 and dy u^T on warps 4-7, a 4 x 4 register
//      tile a thread; warps 0-3 apply the mask and decay, write M and dM o
//      dec and keep the row and column sums of dseg in registers; then dB_s
//      += (dM o dec)^T C_t and du_s += M^T dy_t (registers), and dC_t += (dM
//      o dec) B_s, added to the rows of dc (L2-resident; only this block
//      writes them, in ascending s, so the sum runs in a fixed order); then
//      writes dB_s and dx;
//   5. the reverse cumsum of dcum (one warp), ddt and da_log's partial.
// Blocks take their item from a ticket (an atomic counter) last chunk
// first, so the block a block waits on holds a lower ticket and is running
// or done.  The block with the last ticket zeroes the ticket counter, and
// the first chunk's block zeroes its chain counter: the counters are zero
// between calls and a call is one launch.
//
// Tiles and loads: every product runs in 4 x 4 register tiles a thread,
// its operands read from shared memory as float4, four k at a time or as
// outer products one k at a time.  Each tile is staged in the layout its
// products read: rows padded to N + 4, P + 4 and 68 floats, so rows stay
// 16-byte aligned and each quarter-warp's loads (8 consecutive rows at one
// column, or one row at 8 consecutive columns) fall on distinct banks; D
// goes in once as it is (for B_s D) and once transposed (for u_s D^T), h_c
// transposed.  bf16 B, C and x are widened once, when staged.  Staging
// overlaps compute: the next t tile's C rows are loaded into registers
// while dB_s and du_s compute and stored while dC_t computes, its dy rows
// copied by cp.async meanwhile.  Sums run in a fixed order (warp shuffles of
// fixed shape, per-warp partials added in warp order by one owner thread a
// row; no float atomics), so a call gives the same bits every time.
//
// Shared memory a block at N = 128, P = 64, chunk 256: 100,352 bytes (the s
// tiles 51,200, the t tiles and M, dM o dec 43,008, per-row arrays 5,120,
// partials 1,024), so two blocks fit an SM; __launch_bounds__(256, 2) caps
// a thread at 128 registers, which the bf16 kernel uses with 28 bytes
// spilled (the float32 one 100; the s tile's dB and du tiles take 48).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kS = 64;           // rows of an s tile: B_s, u_s and the dB_s, du_s register tiles
constexpr int kT = 32;           // rows of a t tile: C_t and dy_t
constexpr int kMaxN = 128;       // d_state a block takes
constexpr int kMaxP = 64;        // head_dim a block takes
constexpr int kLdM = kS + 4;     // leading dimension of the M and dM o dec tiles (kT x kS)
constexpr int kParts = 256;      // per-warp partials of the row sums into dcum
constexpr int kWarps = kThreads / 32;
constexpr int kCLoads = kT * kMaxN / 4 / kThreads;   // four-element loads of a C tile a thread
constexpr int kDyLoads = kT * kMaxP / 4 / kThreads;  // 16-byte copies of a dy tile
constexpr int kBLoads = kS * kMaxN / 4 / kThreads;   // of a B tile
constexpr int kULoads = kS * kMaxP / 4 / kThreads;   // of an x tile
constexpr int kDLoads = kMaxN * kMaxP / 4 / kThreads;  // of an N x P state

template <typename T>
struct Vec4;  // four elements of T, one load
template <>
struct Vec4<float> {
  using type = float4;
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
  __device__ static uint2 zero() { return make_uint2(0u, 0u); }
};

__device__ __forceinline__ float4 widen4(float4 v) { return v; }
__device__ __forceinline__ float4 widen4(uint2 v) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__device__ __forceinline__ void narrow4(T* dst, const float (&v)[4]);
template <>
__device__ __forceinline__ void narrow4<float>(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void narrow4<__nv_bfloat16>(__nv_bfloat16* dst, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                              *reinterpret_cast<const unsigned*>(&hi));
}

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ inline size_t max2(size_t a, size_t b) { return a > b ? a : b; }

// Shared memory in floats, three regions and the partials:
//   s region  B_s (64 x (N + 4)) and u_s (64 x (P + 4)); h_c^T (P x (N + 4))
//             during the readout pass;
//   t region  C_t (32 x (N + 4)), dy_t (32 x (P + 4)), M and dM o dec (32 x
//             68); D (N x (P + 4)) or D^T (P x (N + 4)) during the state terms;
//   rows      dt, cum, dcum, du . x and V, each rounded up to 64 rows.
__host__ __device__ inline size_t region_s(int N, int P) {
  return max2(size_t(kS) * (N + 4 + P + 4), size_t(P) * (N + 4));
}
__host__ __device__ inline size_t region_t(int N, int P) {
  return max2(size_t(kT) * (N + 4 + P + 4 + 2 * kLdM),
              max2(size_t(N) * (P + 4), size_t(P) * (N + 4)));
}
__host__ __device__ inline size_t smem_floats(int N, int P, int Q) {
  return region_s(N, P) + region_t(N, P) + 5 * size_t(round_up(Q, kS)) + kParts;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// 16 bytes from global to shared memory without registers, zeros where
// !valid (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float (&b)[4]) {
  return fmaf(a.w, b[3], fmaf(a.z, b[2], fmaf(a.y, b[1], a.x * b[0])));
}

template <int I, int J>
__device__ __forceinline__ void zero(float (&acc)[I][J]) {
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ float warp_sum(float v, int from, int to) {
#pragma unroll
  for (int o = from; o < to; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][j] += sum_k a[i][k] b[j][k] over k in [0, K), K % 4 == 0: rows i of
// a at a + i * a_i, rows j of b at b + j * b_j, both k-contiguous.
template <int I, int J>
__device__ __forceinline__ void dot_tile(float (&acc)[I][J], const float* a, int a_i,
                                         const float* b, int b_j, int K) {
#pragma unroll 1
  for (int k = 0; k < K; k += 4) {
    float4 av[I], bv[J];
#pragma unroll
    for (int i = 0; i < I; ++i) av[i] = ld4(a + i * a_i + k);
#pragma unroll
    for (int j = 0; j < J; ++j) bv[j] = ld4(b + j * b_j + k);
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// acc[i][j] += sum_k a[i][k] b[k][j] over k in [0, K), K % 4 == 0: rows i of
// a at a + i * a_i (k-contiguous), row k of b at b + k * ldb (the 4 columns j
// contiguous).
__device__ __forceinline__ void mul_tile(float (&acc)[4][4], const float* a, int a_i,
                                         const float* b, int ldb, int K) {
#pragma unroll 1
  for (int k = 0; k < K; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a + i * a_i + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) bv[kk] = ld4(b + (k + kk) * ldb);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float av_k = comp(av[i], kk);
        acc[i][0] = fmaf(av_k, bv[kk].x, acc[i][0]);
        acc[i][1] = fmaf(av_k, bv[kk].y, acc[i][1]);
        acc[i][2] = fmaf(av_k, bv[kk].z, acc[i][2]);
        acc[i][3] = fmaf(av_k, bv[kk].w, acc[i][3]);
      }
  }
}

// acc[i][j] += a[i] b[j]: one k of a product whose operands both hold k as
// their row.
__device__ __forceinline__ void outer(float (&acc)[4][4], const float4& a, const float4& b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
    acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
    acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
    acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
  }
}

__device__ __forceinline__ void scale_rows(float (&acc)[4][4], const float (&w)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= w[i];
}

// The masked tiles of a pair (t tile at t0 in s_c / s_dy, s tile at s0 in
// s_b / s_u), a 4 x JN register tile a thread, rows ty + 8 i and columns tx +
// 16 j (JN = 2 where the t tile's last row precedes the s tile's column 32):
// warps 0-3 take C B^T over N, warps 4-7 dy u^T over P and leave it in s_dm;
// then warps 0-3 apply the mask and the decay (the mask before exp), write M
// and dM o dec, and add dseg = dM o M to their row and column partials.  All
// threads call it: it holds a barrier.
template <int JN>
__device__ __forceinline__ void masked_tiles(float (&rowp)[4], float (&colp)[4], const float* s_c,
                                             const float* s_b, int ldn, int N, const float* s_dy,
                                             const float* s_u, int ldp, int P,
                                             const float* s_cum, float* s_m, float* s_dm,
                                             bool dyu_half, int ty, int tx, int t0, int s0,
                                             int L) {
  float acc[4][JN];
  zero(acc);
  if (!dyu_half) {
    dot_tile(acc, s_c + ty * ldn, 8 * ldn, s_b + tx * ldn, 16 * ldn, N);
  } else {
    dot_tile(acc, s_dy + ty * ldp, 8 * ldp, s_u + tx * ldp, 16 * ldp, P);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) s_dm[(ty + 8 * i) * kLdM + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();
  if (dyu_half) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tl = ty + 8 * i, t = t0 + tl;
    const float ct = s_cum[t];
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int sl = tx + 16 * j, s = s0 + sl;
      const float dec = (s <= t && t < L) ? expf(ct - s_cum[s]) : 0.f;
      const float dyu = s_dm[tl * kLdM + sl];
      const float m = acc[i][j] * dec;
      const float seg = dyu * m;
      s_m[tl * kLdM + sl] = m;
      s_dm[tl * kLdM + sl] = dyu * dec;
      rowp[i] += seg;
      colp[j] += seg;
    }
  }
}

// acc[r][i][j] += sum_k a[i][k] b[k][r b_r + j] over k in [0, K), K % 4 ==
// 0, r < R: mul_tile for R column tiles that share their rows of a.
template <int R>
__device__ __forceinline__ void mul_tiles(float (&acc)[2][4][4], const float* a, int a_i,
                                          const float* b, int ldb, int b_r, int K) {
#pragma unroll 1
  for (int k = 0; k < K; k += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a + i * a_i + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 bv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) bv[r] = ld4(b + (k + kk) * ldb + r * b_r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av_k = comp(av[i], kk);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][i][0] = fmaf(av_k, bv[r].x, acc[r][i][0]);
          acc[r][i][1] = fmaf(av_k, bv[r].y, acc[r][i][1]);
          acc[r][i][2] = fmaf(av_k, bv[r].z, acc[r][i][2]);
          acc[r][i][3] = fmaf(av_k, bv[r].w, acc[r][i][3]);
        }
      }
    }
  }
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
__global__ void __launch_bounds__(kThreads, 2) ssd_scan_bwd_kernel(const Params p) {
  using V4 = typename Vec4<T>::type;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = p.N, P = p.P, ldn = N + 4, ldp = P + 4, nq = N / 4, pq = P / 4;
  const int Qr = round_up(p.Q, kS);
  float* s_b = smem;                           // [64][N + 4]  B rows of an s tile
  float* s_u = s_b + kS * ldn;                 // [64][P + 4]  x dt rows of an s tile
  float* s_ht = smem;                          // [P][N + 4]   h_c^T (the readout pass)
  float* s_c = smem + region_s(N, P);          // [32][N + 4]  C rows of a t tile (e_t C, readout)
  float* s_dy = s_c + kT * ldn;                // [32][P + 4]  dy rows of a t tile
  float* s_m = s_dy + kT * ldp;                // [32][68]     M, (t, s)
  float* s_dm = s_m + kT * kLdM;               // [32][68]     dM o dec
  float* s_d = s_c;                            // [N][P + 4]   D (the state terms)
  float* s_dtr = s_c;                          // [P][N + 4]   D^T (the state terms)
  float* s_dt = s_c + region_t(N, P);          // [Qr]
  float* s_cum = s_dt + Qr;                    // [Qr]
  float* s_dcum = s_cum + Qr;                  // [Qr]  dL/dcum, then dL/dla
  float* s_dux = s_dcum + Qr;                  // [Qr]  du . x
  float* s_v = s_dux + Qr;                     // [Qr]  V_s
  float* s_part = s_v + Qr;                    // [256] per-warp partials of the row sums
  __shared__ int s_ticket;
  __shared__ float s_red[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  const size_t row0 = size_t(bi) * p.S + r0;  // sequence row of the chunk's first row
  const T* x = static_cast<const T*>(p.x);
  const T* bsrc = static_cast<const T*>(p.b);
  const T* csrc = static_cast<const T*>(p.c);
  // offsets of (row r of the chunk, column) in the (B, S, H, P), (B, S, G, N)
  // and (B, S, H, N) arrays
  auto at_x = [&](int r, int col) { return ((row0 + r) * p.H + hd) * size_t(P) + col; };
  auto at_bc = [&](int r, int col) { return ((row0 + r) * p.G + g) * size_t(N) + col; };
  auto at_h = [&](int r, int col) { return ((row0 + r) * p.H + hd) * size_t(N) + col; };

  // a block-wide sum in a fixed order: a butterfly in each warp (every lane
  // ends with the same bits), then the warps' sums in warp order
  auto block_sum = [&](float v) {
    v = warp_sum(v, 1, 32);
    __syncthreads();  // s_red is free
    if (lane == 0) s_red[warp] = v;
    __syncthreads();
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_red[w];
    return sum;
  };

  // the next t tile in flight: its C rows (kT x N) in registers, stored
  // widened (scaled by e_t where asked), and its dy rows (kT x P) straight
  // into shared memory (cp.async); zero past L
  V4 pc[kCLoads];
  auto load_c = [&](int t0) {
#pragma unroll
    for (int k = 0; k < kCLoads; ++k) {
      const int e = tid + k * kThreads, r = e / nq, c4 = e - r * nq;
      pc[k] = (r < kT && t0 + r < L) ? *reinterpret_cast<const V4*>(csrc + at_bc(t0 + r, 4 * c4))
                                     : Vec4<T>::zero();
    }
  };
  auto store_c = [&](int t0, bool by_e) {
#pragma unroll
    for (int k = 0; k < kCLoads; ++k) {
      const int e = tid + k * kThreads, r = e / nq, c4 = e - r * nq;
      if (r < kT) {
        float4 v = widen4(pc[k]);
        if (by_e) {
          const float et = t0 + r < L ? expf(s_cum[t0 + r]) : 0.f;
          v = make_float4(v.x * et, v.y * et, v.z * et, v.w * et);
        }
        *reinterpret_cast<float4*>(s_c + r * ldn + 4 * c4) = v;
      }
    }
  };
  auto copy_dy = [&](int t0) {
#pragma unroll
    for (int k = 0; k < kDyLoads; ++k) {
      const int e = tid + k * kThreads, r = e / pq, c4 = e - r * pq;
      const bool valid = t0 + r < L;
      if (r < kT)
        cp_async16(s_dy + r * ldp + 4 * c4, valid ? p.dy + at_x(t0 + r, 4 * c4) : p.dy, valid);
    }
  };
  // an N x P state (global, row-major) in registers, four floats a load, a
  // warp's lanes on consecutive rows n; stored as it is (N x (P + 4)) or
  // transposed (P x (N + 4)), either way a warp's stores on distinct banks
  auto load_state = [&](float4 (&v)[kDLoads], const float* src, bool cg_load) {
#pragma unroll
    for (int k = 0; k < kDLoads; ++k) {
      const int e = tid + k * kThreads, n = e % N, c4 = e / N;
      const float* at = src + size_t(n) * P + 4 * c4;
      v[k] = c4 >= pq  ? make_float4(0.f, 0.f, 0.f, 0.f)
             : cg_load ? __ldcg(reinterpret_cast<const float4*>(at))
                       : ld4(at);
    }
  };
  auto store_state = [&](float* dst, const float4 (&v)[kDLoads], bool transposed) {
#pragma unroll
    for (int k = 0; k < kDLoads; ++k) {
      const int e = tid + k * kThreads, n = e % N, c4 = e / N;
      if (c4 >= pq) continue;
      if (transposed) {
        dst[(4 * c4 + 0) * ldn + n] = v[k].x;
        dst[(4 * c4 + 1) * ldn + n] = v[k].y;
        dst[(4 * c4 + 2) * ldn + n] = v[k].z;
        dst[(4 * c4 + 3) * ldn + n] = v[k].w;
      } else {
        *reinterpret_cast<float4*>(dst + n * ldp + 4 * c4) = v[k];
      }
    }
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
  const size_t hs = size_t(N) * P;
  const size_t slot = ((size_t(bi) * nc + ci) * p.H + hd) * hs;

  // register tiles of the products (rows x columns, 4 x 4 a tile):
  //   R      (n, p) = (4 (m >> 4) + i, 4 (m & 15) + j), m = tid + 256 r
  //   dC     (t, n) = (rg + 8 i, 4 cg + j)
  //   dB_s   (s, n) = (4 sg + i, 4 (lq + 16 r) + j);  du_s (s, p) = (4 sg + i, 4 lq + j)
  //   masked (t, s) = (ty + 8 i, tx + 16 j): C B^T on warps 0-3, dy u^T on 4-7
  const int rg = lane & 7, cg = (lane >> 3) + 4 * warp;
  const int sg = tid >> 4, lq = tid & 15;
  const bool dyu_half = warp >= kWarps / 2;
  const int ty = lane & 7, tx = (lane >> 3) + 4 * (warp & 3);

  // ---- 2. full mode: R = sum_t e_t C_t dy_t^T, the readout's dC and dcum
  float racc[2][4][4];
  zero(racc[0]);
  zero(racc[1]);
  if (readout) {
    float4 hv[kDLoads];
    load_state(hv, p.h_prev + slot, false);
    store_state(s_ht, hv, true);
    for (int t0 = 0; t0 < L; t0 += kT) {  // the previous tile is consumed
      const int kt = min(kT, L - t0);
      copy_dy(t0);
      load_c(t0);
      store_c(t0, true);
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = tid + r * kThreads, ng = m >> 4, pg = m & 15;
        if (ng < nq && pg < pq)
#pragma unroll 2
          for (int k = 0; k < kt; ++k)
            outer(racc[r], ld4(s_c + k * ldn + 4 * ng), ld4(s_dy + k * ldp + 4 * pg));
      }
      // Z = dy h_c^T: dC_t = e_t Z_t, dcum_t += e_t C_t . Z_t
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      if (cg < nq) {
        float z[4][4];
        zero(z);
        mul_tile(z, s_dy + rg * ldp, 8 * ldp, s_ht + 4 * cg, ldn, P);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tl = rg + 8 * i, t = t0 + tl;
          part[i] = dot4(ld4(s_c + tl * ldn + 4 * cg), z[i]);
          if (t < L) {
            const float et = expf(s_cum[t]);
            const float o[4] = {z[i][0] * et, z[i][1] * et, z[i][2] * et, z[i][3] * et};
            st4(p.dch + at_h(t, 4 * cg), o);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[i] = warp_sum(part[i], 8, 32);
        if (lane < 8) s_part[warp * 32 + rg + 8 * i] = part[i];
      }
      __syncthreads();
      if (tid < kT && t0 + tid < L) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += s_part[w * 32 + tid];
        s_dcum[t0 + tid] += sum;
      }
    }
  }

  // ---- 3. the state gradient across chunks, last chunk first
  int* chain = p.counters + 1 + bi * p.H + hd;
  const size_t head = (size_t(bi) * p.H + hd) * hs;
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
    const int m = tid + r * kThreads, ng = m >> 4, pg = m & 15;
    if (ng >= nq || pg >= pq) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t at = size_t(4 * ng + i) * P + 4 * pg;
      const float4 d = __ldcg(reinterpret_cast<const float4*>(d_src + at));
      const float dv[4] = {d.x, d.y, d.z, d.w};
      float hv[4] = {0.f, 0.f, 0.f, 0.f}, pv[4] = {0.f, 0.f, 0.f, 0.f};
      if (ci > 0) {
        const float4 h = ld4(p.h_prev + slot + at);
        hv[0] = h.x, hv[1] = h.y, hv[2] = h.z, hv[3] = h.w;
        if (p.split) {
          const float4 q = ld4(p.dh_prev + slot + at);
          pv[0] = q.x, pv[1] = q.y, pv[2] = q.z, pv[3] = q.w;
        }
      }
      float gv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dot = fmaf(dv[j], hv[j], dot);
        gv[j] = racc[r][i][j] + decay_q * dv[j] + pv[j];
      }
      if (ci > 0) st4(p.dstates + slot + at, gv);  // the first chunk's state is 0: unread
    }
  }
  if (nc > 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(chain, ci > 0 ? rank + 1 : 0);  // the first chunk leaves it 0
  }
  const float dq = decay_q * block_sum(dot);  // dL/dcum_L from exp(cum_L) <D, h_c>

  // ---- 4. per s tile: the state terms, the masked tiles with every t tile >= s
  T* dx = static_cast<T*>(p.dx);
  for (int s0 = 0; s0 < L; s0 += kS) {
    const int s_end = min(s0 + kS, L);
    // B_s, x_s and D in flight together, each thread's loads before its stores
    V4 vb[kBLoads], vu[kULoads];
    float4 vd[kDLoads];
#pragma unroll
    for (int k = 0; k < kBLoads; ++k) {
      const int e = tid + k * kThreads, r = e / nq, c4 = e - r * nq;
      vb[k] = (r < kS && s0 + r < L) ? *reinterpret_cast<const V4*>(bsrc + at_bc(s0 + r, 4 * c4))
                                     : Vec4<T>::zero();
    }
#pragma unroll
    for (int k = 0; k < kULoads; ++k) {
      const int e = tid + k * kThreads, r = e / pq, c4 = e - r * pq;
      vu[k] = (r < kS && s0 + r < L) ? *reinterpret_cast<const V4*>(x + at_x(s0 + r, 4 * c4))
                                     : Vec4<T>::zero();
    }
    load_state(vd, d_src, true);
    __syncthreads();  // the previous s tile is consumed
#pragma unroll
    for (int k = 0; k < kBLoads; ++k) {
      const int e = tid + k * kThreads, r = e / nq, c4 = e - r * nq;
      if (r < kS) *reinterpret_cast<float4*>(s_b + r * ldn + 4 * c4) = widen4(vb[k]);
    }
#pragma unroll
    for (int k = 0; k < kULoads; ++k) {
      const int e = tid + k * kThreads, r = e / pq, c4 = e - r * pq;
      if (r < kS) {
        const float d = s_dt[s0 + r];  // 0 past L
        const float4 v = widen4(vu[k]);
        *reinterpret_cast<float4*>(s_u + r * ldp + 4 * c4) =
            make_float4(v.x * d, v.y * d, v.z * d, v.w * d);
      }
    }
    store_state(s_d, vd, false);
    __syncthreads();
    float w[4];  // w_s of the thread's rows of dB_s and du_s
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + 4 * sg + i;
      w[i] = s < L ? expf(cum_q - s_cum[s]) : 0.f;
    }
    // du_s = w_s B_s D
    float uacc[4][4];
    zero(uacc);
    if (lq < pq) mul_tile(uacc, s_b + 4 * sg * ldn, ldn, s_d + 4 * lq, ldp, N);
    scale_rows(uacc, w);
    __syncthreads();  // D is consumed
    store_state(s_dtr, vd, true);
    __syncthreads();
    // Y2 = u_s D^T: dB_s = w_s Y2_s, V_s = w_s B_s . Y2_s
    float bacc[2][4][4];
    zero(bacc[0]);
    zero(bacc[1]);
    if (lq + 16 < nq)
      mul_tiles<2>(bacc, s_u + 4 * sg * ldp, ldp, s_dtr + 4 * lq, ldn, 64, P);
    else if (lq < nq)
      mul_tiles<1>(bacc, s_u + 4 * sg * ldp, ldp, s_dtr + 4 * lq, ldn, 64, P);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n0 = 4 * (lq + 16 * r);
      if (n0 >= N) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] += dot4(ld4(s_b + (4 * sg + i) * ldn + n0), bacc[r][i]);
      scale_rows(bacc[r], w);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float vs = w[i] * warp_sum(v[i], 1, 16);
      const int s = s0 + 4 * sg + i;
      if (lq == 0 && s < L) {
        s_v[s] = vs;
        s_dcum[s] -= vs;
      }
    }

    float colp[4] = {0.f, 0.f, 0.f, 0.f};  // column sums of dseg over the t tiles
    const bool fresh = !readout && s0 == 0;  // the first write of dC's rows
    load_c(s0);
    __syncthreads();  // D^T is consumed
    copy_dy(s0);
    store_c(s0, false);
    cp_async_wait_all();
    __syncthreads();
    for (int t0 = s0; t0 < L; t0 += kT) {
      const int t_end = min(t0 + kT, L);
      const int s_lim = min(t_end, s_end) - s0;  // s columns [0, s_lim) meet a t <= t_end - 1
      float rowp[4] = {0.f, 0.f, 0.f, 0.f};
      if (s_lim <= 32)
        masked_tiles<2>(rowp, colp, s_c, s_b, ldn, N, s_dy, s_u, ldp, P, s_cum, s_m, s_dm,
                        dyu_half, ty, tx, t0, s0, L);
      else
        masked_tiles<4>(rowp, colp, s_c, s_b, ldn, N, s_dy, s_u, ldp, P, s_cum, s_m, s_dm,
                        dyu_half, ty, tx, t0, s0, L);
      if (!dyu_half) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rowp[i] = warp_sum(rowp[i], 8, 32);
          if (lane < 8) s_part[warp * 32 + ty + 8 * i] = rowp[i];
        }
      }
      const bool more = t_end < L;
      if (more) load_c(t_end);  // in flight during dB_s and du_s
      __syncthreads();  // M, dM o dec and the row partials are complete
      if (tid < kT && t0 + tid < L)
        s_dcum[t0 + tid] +=
            (s_part[tid] + s_part[32 + tid]) + (s_part[64 + tid] + s_part[96 + tid]);
      // dB_s += (dM o dec)^T C_t, du_s += M^T dy_t: rows of the s tile past the
      // t tile's last row take nothing
      if (4 * sg < s_lim) {
#pragma unroll 2
        for (int k = 0; k < t_end - t0; ++k) {
          const float4 a_dm = ld4(s_dm + k * kLdM + 4 * sg);
          const float4 a_m = ld4(s_m + k * kLdM + 4 * sg);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (4 * (lq + 16 * r) < N) outer(bacc[r], a_dm, ld4(s_c + k * ldn + 4 * (lq + 16 * r)));
          if (lq < pq) outer(uacc, a_m, ld4(s_dy + k * ldp + 4 * lq));
        }
      }
      __syncthreads();  // C_t and dy_t are consumed: the next t tile goes in during dC_t
      if (more) {
        copy_dy(t_end);
        store_c(t_end, false);
      }
      // dC_t += (dM o dec) B_s, added to the rows already written
      if (cg < nq) {
        float z[4][4];
        zero(z);
        mul_tile(z, s_dm + rg * kLdM, 8 * kLdM, s_b + 4 * cg, ldn, round_up(s_lim, 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + rg + 8 * i;
          if (t >= L) continue;
          float* dst = p.dch + at_h(t, 4 * cg);
          if (!fresh) {
            const float4 o = ld4(dst);
            z[i][0] += o.x, z[i][1] += o.y, z[i][2] += o.z, z[i][3] += o.w;
          }
          st4(dst, z[i]);
        }
      }
      cp_async_wait_all();
      __syncthreads();  // M, dM o dec are consumed; the next t tile is in
    }

    // the column sums of dseg into dcum_s: one owner lane a column
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      colp[j] = warp_sum(colp[j], 1, 8);
      const int s = s0 + tx + 16 * j;
      if (!dyu_half && ty == 0 && s < L) s_dcum[s] -= colp[j];
    }
    // dB_s; dx = du dt and du . x per row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n0 = 4 * (lq + 16 * r);
      if (n0 >= N) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + 4 * sg + i;
        if (s < L) st4(p.dbh + at_h(s, n0), bacc[r][i]);
      }
    }
    float dux[4] = {0.f, 0.f, 0.f, 0.f};
    if (lq < pq) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + 4 * sg + i;
        if (s >= L) continue;
        const size_t at = at_x(s, 4 * lq);
        dux[i] = dot4(widen4(*reinterpret_cast<const V4*>(x + at)), uacc[i]);
        const float dts = s_dt[s];
        const float o[4] = {uacc[i][0] * dts, uacc[i][1] * dts, uacc[i][2] * dts,
                            uacc[i][3] * dts};
        narrow4<T>(dx + at, o);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float sum = warp_sum(dux[i], 1, 16);
      const int s = s0 + 4 * sg + i;
      if (lq == 0 && s < L) s_dux[s] = sum;
    }
  }

  // ---- 5. dla = reverse cumsum of dcum; ddt, da_log's partial
  float vsum = 0.f;
  for (int t = tid; t < L; t += kThreads) vsum += s_v[t];
  vsum = block_sum(vsum);  // syncs: every dcum row is final
  if (tid == 0) s_dcum[L - 1] += dq + vsum;
  __syncthreads();
  if (tid < 32) {  // inclusive suffix scan by warp 0, 32 rows at a time from the end
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
  float da = 0.f;
  for (int t = tid; t < L; t += kThreads) {
    p.ddt[(row0 + t) * p.H + hd] = s_dux[t] - A * s_dcum[t];
    da = fmaf(s_dt[t], s_dcum[t], da);
  }
  da = block_sum(da);
  if (tid == 0) p.da_part[(size_t(ci) * p.B + bi) * p.H + hd] = -A * da;
}

template <typename T>
int launch(const Params& p, int blocks, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.N, p.P, p.Q) * sizeof(float);
  auto kernel = ssd_scan_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err == cudaSuccess)  // the whole of L1 as shared memory, so two blocks fit an SM
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
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
// 0, P <= 64; H % G == 0.  Every array but dt, a_log, ddt, da_part and the
// counters is read or written four elements an access: 16-byte aligned.
// Returns a cudaError_t (0 on success).
int ssd_scan_bwd(const void* x, const float* dt, const float* a_log, const void* b,
                 const void* c, int in_bf16, const float* dy, const float* dh_prev,
                 const float* dh_final, const float* h_prev, void* dx, float* ddt,
                 float* da_part, float* dbh, float* dch, float* dstates, int* counters, int B,
                 int S, int H, int P, int G, int N, int Q, int split, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G || N < 4 || N % 4 || N > kMaxN || P < 4 ||
      P % 4 || P > kMaxP || Q < 1 || counters == nullptr || (split && dh_prev == nullptr) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(dy) |
       reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(dh_final) |
       reinterpret_cast<uintptr_t>(h_prev) | reinterpret_cast<uintptr_t>(dbh) |
       reinterpret_cast<uintptr_t>(dch) | reinterpret_cast<uintptr_t>(dstates) |
       reinterpret_cast<uintptr_t>(dh_prev)) % 16)
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
