// Full-table AMR-MUL gather matmul for Hopper (sm_90a), plain C interface.
//
//   out[g, m, n] = sum_k LUT[a[g, m, k] + 128, b[g, k, n] + 128]      (int32)
//
// Replaces the JAX package's Pallas kernels
//   src/repro/kernels/amr_matmul/kernel.py  _amr_matmul_lut_kernel          (flat)
//   src/repro/kernels/amr_matmul/kernel.py  _amr_matmul_lut_grouped_kernel  (grouped)
// which keep the whole 256 KB int32 table in TPU VMEM.  The flat form is
// the grouped one with G = 1: one kernel body serves both.
//
// What bounds it on this card: one table gather and one int32 add per
// product, and the int8 operands read once.  At the decode shapes (M = 2)
// the weight's bytes set the bound (0.0101 ms for the 32 MB of b at
// (2, 2048, 16384)).  The gathers cost more: 32 random columns of one
// 512-byte int16 table row take about 2.8 shared-memory wavefronts a warp,
// one a clock, about 0.022 ms for the 67 M products of that shape on 132
// SMs at 1980 MHz.  At M = 16, where a column offset and a b word serve 16
// rows, the kernel runs near that gather rate; at M = 2 the loop's other
// integer work (the gather's address and add, the column offsets, b's
// loads), at 64 results a clock an SM, keeps it above.
//
// The design:
//
// * Tiles.  A tile is RT rows (1, 2, 4, 8 or 16: the power of two that
//   fits M, or fewer where the tiles are too few) x 4 cg columns x one
//   k_chunk of K, of one group.  A block of 512 threads is cg column groups
//   of 4 adjacent columns x 512 / cg k-lanes; a thread holds RT x 4 int32
//   sums, so at M = 2 no sum idles, and reads its 4 columns of b for 4 k at
//   a time as 4 four-byte loads that do not allocate in L1
//   (ld.global.nc.L1::no_allocate), one group of 4 k ahead of use.  The A
//   rows of the tile's K range sit in shared memory, read by broadcast: up
//   to RT = 4 as each k's table-row address (no extraction a row), above as
//   the row bytes, 4 k a word (kRowAddr).  A column's offset is taken once
//   a k for all RT rows, so a gather is one add and one shared load; up to
//   RT = 4 the sums take two gathers an add (a three-input add).  The
//   k-lanes' sums meet by shared-memory atomics (column-planar, so a warp's
//   32 adds hit 32 banks).  A group of 4 k's gathers (gather_group) and
//   their helpers are lut_gather.cuh's, shared with the fused attention
//   LUT kernel.
// * Persistent blocks.  The grid is min(tiles, the blocks that fit on the
//   card); a block walks over tiles.  The launch plan (kernel.py,
//   lut_launch_plan) picks RT, cg and k_chunk from a cost model of rounds x
//   (per-lane gathers + a per-tile overhead) among the plans whose first
//   round fills the card, so that the small-N decode shapes use every SM.
// * The table.  With the int16 table (every border up to 13, the served 8)
//   and at least 2^24 products a call, each block stages the 128 KB table
//   into shared memory once per launch and keeps one block an SM.  The
//   earlier design (one thread a column, 16 rows a block, table through L1)
//   measured a staged version 1.2-2.7x slower, but that one ran one block
//   of 256 threads an SM with 16 row sums a thread at M = 2, so the gathers
//   of its 8 warps could not hide their latency; here 16 warps each have RT
//   x 16 independent gathers a group.  On smaller calls, where staging 128
//   KB costs as much as the gathers, and for the int32 table (border 14 and
//   up: 256 KB, more than a block's 227 KB), the same body gathers from
//   global memory through L1, where the table stays since b bypasses L1.
//   (The other design for the int32 table, an int8 high and an int16 low
//   plane both in shared memory, two gathers a product, was not built: the
//   L1 route runs border 14 at 1.02-1.16x border 8's time at the decode
//   shapes and at 1.07-1.44x in prefill.)
// * Splits of K meet in one launch: each split adds its tile's sums by
//   atomics into an accumulator that is zero between calls, and the last
//   block of a tile to finish (an atomic counter) moves the tile's sums to
//   out and zeroes them and the counter for the next call.  No zero-fill
//   launch precedes the kernel.  int32 sums are exact in any order, so the
//   result is bitwise independent of the plan.  (Where the last block
//   instead added up every split's partial, that one block's fold set the
//   time of calls with many splits of wide tiles, such as (16, 2048, 1024).)
//
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W, device time:
// (2, 2048, 16384) and (2, 16384, 2048) 0.032 ms, 8.0x and 9.0x faster than
// the earlier design's device time in the same call; the other M = 2 path
// shapes of gemma-2b and mamba2-370m 0.005-0.009 ms; (16, 2048, 16384) and
// (16, 16384, 2048) 0.203 ms (1.6x); the grouped path shapes 0.003-0.005
// ms, and 0.041 ms at mamba2-370m's prefill ssm.scan (32, 256, 128, 64),
// which holds as many products as (2, 2048, 16384).
//
// Ragged edges in M, N and K are masked here: k past the tile's range is
// skipped (AMR(0, b) is not 0), rows past M and columns past N are computed
// on zeros and not stored.
#include <cstdint>
#include <cuda_runtime.h>

#include "lut_gather.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kAEntries = 16384;              // staged A: RT x k_chunk row addresses at most
constexpr int kMaxCg = 128;                   // column groups of 4 a block

struct Params {
  const int8_t* a;     // (G, M, K)
  const int8_t* b;     // (G, K, N)
  const void* table;   // (256, 256) int16 or int32
  int32_t* out;        // (G, M, N)
  int32_t* acc;        // (G, M, N) zero between calls, when splits > 1
  int* counters;       // (G * row_tiles * col_tiles,) zero between calls
  int G, M, N, K;
  int k_chunk, splits, cg, row_tiles, col_tiles, n_tiles;
  bool vec_a, vec_b;   // A and b rows read as aligned 4-byte words
};

// b rows k .. k + 3 of the tile at this thread's 4 columns (bcol: the
// tile's first row at them), each row as a word of 4 bytes; 0 past the
// tile's kw rows or N.  full: the 4 columns lie in N and b rows are words.
__device__ __forceinline__ void load_b(const Params& p, const int8_t* bcol, int k, int kw,
                                       int n0, bool full, uint32_t w[4]) {
  const int8_t* row = bcol + size_t(k) * p.N;
  if (full && k + 3 < kw) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = gather::load_stream(row + size_t(i) * p.N);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i, row += p.N) {
    w[i] = 0u;
    if (k + i < kw && n0 < p.N) {
      if (full) {
        w[i] = gather::load_stream(row);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (n0 + c < p.N) w[i] |= uint32_t(uint8_t(__ldg(row + c))) << (8 * c);
        }
      }
    }
  }
}

template <typename T, int RT, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1) amr_lut_kernel(const Params p) {
  extern __shared__ int4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int BN = 4 * p.cg;
  const T* tab;
  int32_t* s_out;  // [RT][4][cg]: row, column in the group, column group
  if constexpr (STAGED) {
    const int4* src = static_cast<const int4*>(p.table);
#pragma unroll 4
    for (int i = tid; i < gather::kTableBytes16 / 16; i += kThreads) smem4[i] = __ldg(src + i);
    tab = reinterpret_cast<const T*>(smem);
    s_out = reinterpret_cast<int32_t*>(smem + gather::kTableBytes16);
  } else {
    tab = static_cast<const T*>(p.table);
    s_out = reinterpret_cast<int32_t*>(smem);
  }
  // [RT][groups_cap][4] row addresses (kRowAddr) or [RT][groups_cap] words
  // of row bytes: a row address is a shared byte address (staged) or an
  // entry index
  uint32_t* s_a = reinterpret_cast<uint32_t*>(s_out + RT * BN);
  const int groups_cap = p.k_chunk / 4;
  const int a_stride = gather::kRowAddr<RT> ? p.k_chunk : groups_cap;
  const uint32_t row_base = STAGED ? static_cast<uint32_t>(__cvta_generic_to_shared(smem)) : 0u;
  constexpr int kRowShift = STAGED ? 9 : 8;  // a table row: 512 bytes, or 256 entries
  for (int i = tid; i < RT * BN; i += kThreads) s_out[i] = 0;

  const int cgi = tid % p.cg;      // this thread's column group
  const int kl = tid / p.cg;       // and k-lane
  const int lanes = kThreads / p.cg;

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    int t = tile;
    const int split = t % p.splits;
    t /= p.splits;
    const int ct = t % p.col_tiles;
    t /= p.col_tiles;
    const int rtile = t % p.row_tiles;
    const int g = t / p.row_tiles;
    const int m0 = rtile * RT;
    const int ks = split * p.k_chunk;
    const int kw = min(p.k_chunk, p.K - ks);  // k of this tile
    const int groups = (kw + 3) / 4;
    const int n0 = ct * BN + cgi * 4;
    const int8_t* b = p.b + (size_t(g) * p.K + ks) * p.N;

    const int8_t* bcol = p.b + (size_t(g) * p.K + ks) * p.N + n0;
    const bool full = p.vec_b && n0 + 4 <= p.N;
    uint32_t bw[4];  // the first group's b, loaded before A is staged
    load_b(p, bcol, 4 * kl, kw, n0, full, bw);

    __syncthreads();  // the table is staged; the previous tile's A and sums are read
    {
      const int8_t* a = p.a + (size_t(g) * p.M + m0) * p.K + ks;
      for (int i = tid; i < RT * groups_cap; i += kThreads) {
        const int r = i / groups_cap;
        const int w = i - r * groups_cap;
        uint32_t v = 0u;
        if (m0 + r < p.M && 4 * w < kw) {
          const int8_t* src = a + size_t(r) * p.K + 4 * w;
          if (p.vec_a) {
            v = __ldg(reinterpret_cast<const unsigned int*>(src));
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (4 * w + c < kw) v |= uint32_t(uint8_t(__ldg(src + c))) << (8 * c);
            }
          }
        }
        v ^= 0x80808080u;  // each byte a table row: a + 128
        if constexpr (gather::kRowAddr<RT>) {
          reinterpret_cast<uint4*>(s_a)[i] =
              make_uint4(row_base + (uint32_t(gather::byte_of(v, 0)) << kRowShift),
                         row_base + (uint32_t(gather::byte_of(v, 1)) << kRowShift),
                         row_base + (uint32_t(gather::byte_of(v, 2)) << kRowShift),
                         row_base + (uint32_t(gather::byte_of(v, 3)) << kRowShift));
        } else {
          s_a[i] = v;
        }
      }
    }
    __syncthreads();

    int acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0;
    }
    for (int j = kl; j < groups; j += lanes) {
      uint32_t nb[4];  // the next group's b
      load_b(p, bcol, 4 * (j + lanes), kw, n0, full, nb);
      const int kv = kw - 4 * j;
      const uint32_t* s_aj = s_a + (gather::kRowAddr<RT> ? 4 * j : j);
      if (kv >= 4) {
        gather::gather_group<T, RT, STAGED, true>(tab, s_aj, a_stride, row_base, kv, bw, acc);
      } else {
        gather::gather_group<T, RT, STAGED, false>(tab, s_aj, a_stride, row_base, kv, bw, acc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) bw[i] = nb[i];
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) atomicAdd(s_out + (r * 4 + c) * p.cg + cgi, acc[r][c]);
    }
    __syncthreads();
    for (int o = tid; o < RT * BN; o += kThreads) {
      const int r = o / BN;
      const int col = o - r * BN;
      int32_t* s = s_out + (r * 4 + (col & 3)) * p.cg + (col >> 2);
      const int v = *s;
      *s = 0;  // zero for the next tile
      const int m = m0 + r;
      const int n = ct * BN + col;
      if (m < p.M && n < p.N) {
        const size_t at = (size_t(g) * p.M + m) * p.N + n;
        if (p.splits == 1) {
          p.out[at] = v;
        } else {
          atomicAdd(p.acc + at, v);
        }
      }
    }
    if (p.splits == 1) continue;
    // the last block of this tile to finish moves the sums to out
    __threadfence();
    __syncthreads();
    int* counter = p.counters + (g * p.row_tiles + rtile) * p.col_tiles + ct;
    if (tid == 0) s_last = atomicAdd(counter, 1) == p.splits - 1;
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
    for (int o = tid; o < RT * BN; o += kThreads) {
      const int r = o / BN;
      const int m = m0 + r;
      const int n = ct * BN + o - r * BN;
      if (m < p.M && n < p.N) {
        const size_t at = (size_t(g) * p.M + m) * p.N + n;
        p.out[at] = __ldcg(p.acc + at);
        __stcg(p.acc + at, 0);
      }
    }
    if (tid == 0) *counter = 0;
  }
}

constexpr int max_smem(int RT, bool staged) {
  return (staged ? gather::kTableBytes16 : 0) + RT * 4 * kMaxCg * 4 + 4 * kAEntries;
}

template <typename T, int RT, bool STAGED>
int launch(const Params& p, cudaStream_t stream) {
  // per device: the shared-memory limit set, and the blocks an SM holds at it
  static uint64_t configured = 0;
  static int cap[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return int(err);
  if (device >= 64) return int(cudaErrorInvalidDevice);
  if (!((configured >> device) & 1u)) {
    const int smem = max_smem(RT, STAGED);
    err = cudaFuncSetAttribute(amr_lut_kernel<T, RT, STAGED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int sms = 0, fit = 0;
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, amr_lut_kernel<T, RT, STAGED>,
                                                          kThreads, smem);
    }
    if (err != cudaSuccess) return int(err);
    if (fit < 1) return int(cudaErrorInvalidConfiguration);
    cap[device] = fit * sms;
    configured |= uint64_t(1) << device;
  }
  const size_t smem = size_t(STAGED ? gather::kTableBytes16 : 0) + size_t(RT) * 4 * p.cg * 4 +
                      size_t(RT) * p.k_chunk * 4;
  const int grid = p.n_tiles < cap[device] ? p.n_tiles : cap[device];
  amr_lut_kernel<T, RT, STAGED><<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T, bool STAGED>
int launch_rows(const Params& p, int rt, cudaStream_t s) {
  switch (rt) {
    case 1: return launch<T, 1, STAGED>(p, s);
    case 2: return launch<T, 2, STAGED>(p, s);
    case 4: return launch<T, 4, STAGED>(p, s);
    case 8: return launch<T, 8, STAGED>(p, s);
    case 16: return launch<T, 16, STAGED>(p, s);
    default: return int(cudaErrorInvalidValue);
  }
}

int run(const int8_t* a, const int8_t* b, const void* table, int table_int16, int32_t* out,
        int32_t* acc, int* counters, int G, int M, int N, int K, int rt, int cg, int k_chunk,
        int staged, void* stream) {
  if (G < 1 || M < 1 || N < 1 || K < 1 || k_chunk < 4 || k_chunk % 4 != 0 ||
      rt < 1 || rt > 16 || (rt & (rt - 1)) != 0 ||
      cg < 4 || cg > kMaxCg || (cg & (cg - 1)) != 0 || (staged && !table_int16) ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0) {
    return int(cudaErrorInvalidValue);
  }
  Params p;
  p.a = a;
  p.b = b;
  p.table = table;
  p.out = out;
  p.acc = acc;
  p.counters = counters;
  p.G = G;
  p.M = M;
  p.N = N;
  p.K = K;
  p.k_chunk = k_chunk;
  p.splits = (K + k_chunk - 1) / k_chunk;
  p.cg = cg;
  p.row_tiles = (M + rt - 1) / rt;
  p.col_tiles = (N + 4 * cg - 1) / (4 * cg);
  if ((long long)rt * k_chunk > kAEntries) return int(cudaErrorInvalidValue);
  const long long tiles = (long long)G * p.row_tiles * p.col_tiles * p.splits;
  if (tiles > 2147483647LL) return int(cudaErrorInvalidConfiguration);
  if (p.splits > 1 && (acc == nullptr || counters == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  p.n_tiles = int(tiles);
  p.vec_a = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 4 == 0;
  p.vec_b = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged) return launch_rows<int16_t, true>(p, rt, s);
  if (table_int16) return launch_rows<int16_t, false>(p, rt, s);
  return launch_rows<int32_t, false>(p, rt, s);
}

}  // namespace

extern "C" {

// a (M, K) int8, b (K, N) int8, table (256, 256) int16 or int32 (16-byte
// aligned), out (M, N) int32.  rt (rows a tile) is 1, 2, 4, 8 or 16; cg
// (column groups of 4 a block) a power of two from 4 to 128; k_chunk (K a
// tile) a multiple of 4 with rt x k_chunk at most 16384;
// staged (the table in shared memory) only with the int16 table.  When K >
// k_chunk, acc is an int32 array of M x N zeros and counters one of
// ceil(M / rt) x ceil(N / (4 cg)) zeros, both left zero by the kernel;
// neither is read otherwise.  Returns a cudaError_t (0
// on success).
int amr_lut_matmul(const int8_t* a, const int8_t* b, const void* table, int table_int16,
                   int32_t* out, int32_t* acc, int* counters, int M, int N, int K, int rt,
                   int cg, int k_chunk, int staged, void* stream) {
  return run(a, b, table, table_int16, out, acc, counters, 1, M, N, K, rt, cg, k_chunk,
             staged, stream);
}

// a (G, M, K) int8, b (G, K, N) int8, out (G, M, N) int32; the rest as
// amr_lut_matmul, with G x the sums and the counters.
int amr_lut_matmul_grouped(const int8_t* a, const int8_t* b, const void* table, int table_int16,
                           int32_t* out, int32_t* acc, int* counters, int G, int M, int N,
                           int K, int rt, int cg, int k_chunk, int staged, void* stream) {
  return run(a, b, table, table_int16, out, acc, counters, G, M, N, K, rt, cg, k_chunk,
             staged, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
