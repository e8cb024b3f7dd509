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
// What bounds it on this card: one table gather and one int32 add per
// product, D products per kept score (QK^T) and P per key (PV: a zero
// probability still gathers LUT[128, v + 128], which is not 0); the int8
// operands, the int32 mask and the scales are read once.  At gemma-2b's
// 8192-token decode (2 groups of 8 rows) that is 67 M products.
//
// Design.  Both products are gather matmuls, run on the gather matmul's
// tile loop (amr_matmul/csrc/lut_gather.cuh): QK^T is (rows x D) @ (D x
// columns of T), PV (rows x keys) @ (keys x P).  A block of 512 threads
// takes a row tile of bm rows in sub-tiles of RT rows (1, 2, 4, 8 or 16, a
// template parameter: the power of two at or above bm, at most 16), so
// that one K^T column offset and one V load serve RT rows.  Within a
// product, a tile of RT rows x 4 cg columns is cg column groups x 512 / cg
// k-lanes (qk_cg, pv_cg: kernel.py, lut_attn_plan).  The key axis T is split
// over blocks (attn_tsplit.cuh), as the fused inject kernel's is:
//   * QK^T items, one per (group, row tile, slice of T in whole 32-column
//     words), write the masked float32 scores to a per-stream scratch; a
//     column tile whose mask is 0 in every row of the sub-tile skips its
//     gathers (a masked score is NEG_INF whatever its sum: the causal long
//     prefill's upper triangle); the last QK^T item of a row tile takes
//     each row's max, its sum of exp in the fixed order and ps, one warp a
//     row reading the row from L2 in two passes (the lane order of the sum
//     depends on T alone), and marks the tile ready;
//   * PV items wait until their tile is ready, re-quantize their slice's
//     probabilities as they stage them (the softmax's last pass, spread
//     over the items instead of run by one block), gather them against V
//     and add the int32 sums into a per-stream accumulator (exact in any
//     order); the last one writes out = float(sum) * ps * sv.
//   Blocks are persistent (one an SM) and take items by ticket, every QK^T
//   item before every PV item, so a waiting PV item never waits on an item
//   that has not started, and a block stages the table once.  The ticket
//   counter, the tile counters and the accumulator are zero between calls:
//   a call is one launch.
// Where T is one slice (a served decode or prefill: one word) and the row
// tile's scores fit, one block takes the row tile whole (WHOLE): its scores
// in shared memory, QK^T, the softmax and PV back to back, no hand-off.
// The table: the int16 table (every border up to 13) staged in shared
// memory once a block where the call has at least 2^24 products, as in the
// gather matmul; otherwise, and always for the int32 table (border 14 and
// up, 256 KB), gathered through L1.  No plan changes a bit: int32 sums are
// exact in any order and the softmax's order depends on T alone.
#include <cstdint>
#include <cuda_runtime.h>

#include "attn_softmax.cuh"
#include "attn_tsplit.cuh"
#include "lut_gather.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxRows = 16;      // rows of a sub-tile
constexpr int kMaxCg = 64;        // column groups of 4 of a product's tile
constexpr int kAWords = 2048;     // staged A: row addresses or words of row bytes
constexpr int kMaxSmem = 232448;  // shared memory a block may take on Hopper (227 KB)

// K a staged A holds: kAWords row addresses (RT <= 4), or words of 4 row bytes
template <int RT>
constexpr int kChunk = gather::kRowAddr<RT> ? kAWords / RT : 4 * kAWords / RT;

// The tile loop around gather::gather_group, for both products: b's rows
// `stride` bytes apart and its columns ending at n_end (K^T's slice, V's
// P), A staged from a callback (q's rows, or probability indices made as
// they are staged).  A block is cg column groups of 4 adjacent columns x
// the rest as k-lanes; the k-lanes' sums meet by shared-memory atomics
// (meet_lanes, then take_sum), column-planar, so that a warp's 32 adds hit
// 32 banks.
//
// b rows k .. k + 3 of the tile at this thread's 4 columns (bcol: the
// tile's first row at them, rows `stride` bytes apart), each row as a word
// of 4 bytes; 0 past the tile's kw rows or from column n_end on (n0: the
// first of the 4 columns).  full: the 4 columns lie before n_end and b rows
// are words.
__device__ __forceinline__ void load_b(const int8_t* bcol, int stride, int k, int kw, int n0,
                                       int n_end, bool full, uint32_t w[4]) {
  const int8_t* row = bcol + size_t(k) * stride;
  if (full && k + 3 < kw) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = gather::load_stream(row + size_t(i) * stride);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i, row += stride) {
    w[i] = 0u;
    if (k + i < kw && n0 < n_end) {
      if (full) {
        w[i] = gather::load_stream(row);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (n0 + c < n_end) w[i] |= uint32_t(uint8_t(__ldg(row + c))) << (8 * c);
        }
      }
    }
  }
}

// The int16 table into shared memory at dst, by the block.
__device__ __forceinline__ void stage_table16(int4* dst, const void* table) {
  const int4* src = static_cast<const int4*>(table);
#pragma unroll 4
  for (int i = threadIdx.x; i < gather::kTableBytes16 / 16; i += kThreads) {
    dst[i] = __ldg(src + i);
  }
}

// The tile's A into s_a, groups_cap groups of 4 k a row: word(r, w) gives
// row r's table rows (a + 128) of k = 4 w .. 4 w + 3, one a byte.  Stored
// as [RT][groups_cap][4] row addresses (kRowAddr: a shared byte address
// when STAGED, row_base the table's, else an entry index) or
// [RT][groups_cap] words; a row is a_stride(groups_cap) words.
template <int RT, bool STAGED, typename Word>
__device__ __forceinline__ void stage_a(uint32_t* s_a, int groups_cap, uint32_t row_base,
                                        Word word) {
  constexpr int kRowShift = STAGED ? 9 : 8;  // a table row: 512 bytes, or 256 entries
  for (int i = threadIdx.x; i < RT * groups_cap; i += kThreads) {
    const int r = i / groups_cap;
    const uint32_t v = word(r, i - r * groups_cap);
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

template <int RT>
__host__ __device__ constexpr int a_stride(int groups_cap) {
  return gather::kRowAddr<RT> ? 4 * groups_cap : groups_cap;
}

// A k-lane's sums over the tile's kw k: groups kl, kl + lanes, ... of 4 k,
// b (bcol, stride, n0, n_end, full as load_b) read one group ahead.  bw
// holds the lane's first group of b on entry (loaded by the caller, so that
// the load overlaps the staging of A).
template <typename T, int RT, bool STAGED>
__device__ __forceinline__ void lane_sums(const T* tab, const uint32_t* s_a, int a_stride,
                                          uint32_t row_base, const int8_t* bcol, int stride,
                                          int kw, int n0, int n_end, bool full, int kl,
                                          int lanes, uint32_t (&bw)[4], int (&acc)[RT][4]) {
  const int groups = (kw + 3) / 4;
  for (int j = kl; j < groups; j += lanes) {
    uint32_t nb[4];  // the next group's b
    load_b(bcol, stride, 4 * (j + lanes), kw, n0, n_end, full, nb);
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
}

// The k-lanes' sums of column group cgi into s_out [RT][4][cg] (zero before).
template <int RT>
__device__ __forceinline__ void meet_lanes(int32_t* s_out, int cg, int cgi,
                                           const int (&acc)[RT][4]) {
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) atomicAdd(s_out + (r * 4 + c) * cg + cgi, acc[r][c]);
  }
}

// The met sum of the tile's row r, column col (of 4 cg), zeroed for the next tile.
__device__ __forceinline__ int32_t take_sum(int32_t* s_out, int cg, int r, int col) {
  int32_t* s = s_out + (r * 4 + (col & 3)) * cg + (col >> 2);
  const int32_t v = *s;
  *s = 0;
  return v;
}

struct Params {
  const int8_t* q;      // (G, M, D)
  const int8_t* kt;     // (G, D, T)
  const int8_t* v;      // (G, T, P)
  const float* sq;      // (G, M)
  const float* sk;      // (G, T)
  const float* sv;      // (G, P)
  const int32_t* mask;  // (G, M, T), 0 = masked
  const void* table;    // (256, 256) int16 or int32
  float* out;           // (G, M, P)
  int* state;           // zero between calls: ticket, tile counters, accumulator
  float* scores;        // (G, M, ld) scores, then (G, M) ps
  float scale;
  int G, M, D, T, P, bm, slice_words, qk_cg, pv_cg;
  bool vec_q, vec_k, vec_v;  // q, K^T and V rows read as aligned 4-byte words
};

// QK^T of the sub-tile rows [r0, r0 + nr) of a row tile (row0: its first
// (g, m) row) over the columns [c_begin, c_end) of T: the masked scores, the
// tile's row r at scores[r * ld + t].
template <typename TT, int RT, bool STAGED>
__device__ __forceinline__ void qk_rows(const Params& p, const TT* tab, uint32_t row_base,
                                        int32_t* s_out, uint32_t* s_a, int g, size_t row0,
                                        int r0, int nr, int c_begin, int c_end, float* scores,
                                        int ld) {
  const int tid = threadIdx.x;
  const int cg = p.qk_cg, bn = 4 * cg, cgi = tid % cg, kl = tid / cg, lanes = kThreads / cg;
  const int8_t* kt_g = p.kt + size_t(g) * p.D * p.T;
  const size_t first = row0 + r0;  // the sub-tile's first (g, m) row
  constexpr int kc = kChunk<RT>;
  const bool one_chunk = p.D <= kc;
  auto stage = [&](int k0) {  // q's rows, k in [k0, k0 + kc): returns the groups of 4 k
    const int kw = min(kc, p.D - k0);
    const int groups = (kw + 3) / 4;
    __syncthreads();  // the previous A is read
    stage_a<RT, STAGED>(s_a, groups, row_base, [&](int r, int w) {
      uint32_t x = 0u;
      if (r < nr) {
        const int8_t* src = p.q + (first + r) * p.D + k0 + 4 * w;
        if (p.vec_q) {
          x = __ldg(reinterpret_cast<const unsigned int*>(src));
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (4 * w + c < kw) x |= uint32_t(uint8_t(__ldg(src + c))) << (8 * c);
          }
        }
      }
      return x ^ 0x80808080u;  // each byte a table row: q + 128
    });
    __syncthreads();
    return groups;
  };
  int groups = one_chunk ? stage(0) : 0;
  for (int ct = c_begin; ct < c_end; ct += bn) {
    const int cw = min(bn, c_end - ct);
    int keep = 0;  // does the mask keep a score of the column tile?
    for (int i = tid; i < nr * bn; i += kThreads) {
      const int r = i / bn;
      const int c = i - r * bn;
      if (c < cw) keep |= p.mask[(first + r) * p.T + ct + c];
    }
    if (__syncthreads_or(keep)) {
      int acc[RT][4];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0;
      }
      const int n0 = ct + 4 * cgi;
      const bool full = p.vec_k && n0 + 4 <= c_end;
      for (int k0 = 0; k0 < p.D; k0 += kc) {
        const int8_t* bcol = kt_g + size_t(k0) * p.T + n0;
        const int kw = min(kc, p.D - k0);
        uint32_t bw[4];
        load_b(bcol, p.T, 4 * kl, kw, n0, c_end, full, bw);
        if (!one_chunk) groups = stage(k0);
        lane_sums<TT, RT, STAGED>(tab, s_a, a_stride<RT>(groups), row_base, bcol, p.T, kw, n0,
                                  c_end, full, kl, lanes, bw, acc);
      }
      meet_lanes<RT>(s_out, cg, cgi, acc);
    }
    __syncthreads();
    for (int o = tid; o < RT * bn; o += kThreads) {
      const int r = o / bn;
      const int c = o - r * bn;
      const int32_t sum = take_sum(s_out, cg, r, c);  // zero for the next tile
      if (r < nr && c < cw) {
        const size_t row = first + r;
        const int t = ct + c;
        scores[size_t(r0 + r) * ld + t] = attn::masked_score(
            sum, p.sq[row], p.sk[size_t(g) * p.T + t], p.scale, p.mask[row * p.T + t]);
      }
    }
  }
}

// 4 probability indices (each q_p + 128 in a byte; bits past 8 dropped)
// as a staged A word.
__device__ __forceinline__ uint32_t pack_indices(int32_t a, int32_t b, int32_t c, int32_t d) {
  return uint32_t(a & 255) | uint32_t(b & 255) << 8 | uint32_t(c & 255) << 16 |
         uint32_t(d & 255) << 24;
}

// PV of a sub-tile of nr rows over the keys [k_begin, k_end): word(r, k)
// gives row r's probability indices of keys k .. k + 3 (k a multiple of 4;
// those past T are never gathered); done(r, c, sum) takes the sum of the
// sub-tile's row r at column c < P.
template <typename TT, int RT, bool STAGED, typename Word, typename Done>
__device__ __forceinline__ void pv_rows(const Params& p, const TT* tab, uint32_t row_base,
                                        int32_t* s_out, uint32_t* s_a, int g, int nr,
                                        int k_begin, int k_end, Word word, Done done) {
  const int tid = threadIdx.x;
  const int cg = p.pv_cg, bn = 4 * cg, cgi = tid % cg, kl = tid / cg, lanes = kThreads / cg;
  const int8_t* v_g = p.v + size_t(g) * p.T * p.P;
  constexpr int kc = kChunk<RT>;
  for (int ct = 0; ct < p.P; ct += bn) {
    int acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0;
    }
    const int n0 = ct + 4 * cgi;
    const bool full = p.vec_v && n0 + 4 <= p.P;
    for (int k0 = k_begin; k0 < k_end; k0 += kc) {
      const int kw = min(kc, k_end - k0);
      const int groups = (kw + 3) / 4;
      const int8_t* bcol = v_g + size_t(k0) * p.P + n0;
      uint32_t bw[4];
      load_b(bcol, p.P, 4 * kl, kw, n0, p.P, full, bw);
      __syncthreads();  // the previous A and sums are read
      stage_a<RT, STAGED>(s_a, groups, row_base, [&](int r, int w) {
        return r < nr ? word(r, k0 + 4 * w) : 0u;  // rows past nr: any table row, not stored
      });
      __syncthreads();
      lane_sums<TT, RT, STAGED>(tab, s_a, a_stride<RT>(groups), row_base, bcol, p.P, kw, n0,
                                p.P, full, kl, lanes, bw, acc);
    }
    meet_lanes<RT>(s_out, cg, cgi, acc);
    __syncthreads();
    for (int o = tid; o < RT * bn; o += kThreads) {
      const int r = o / bn;
      const int c = o - r * bn;
      const int32_t sum = take_sum(s_out, cg, r, c);  // zero for the next tile
      if (r < nr && ct + c < p.P) done(r, ct + c, sum);
    }
  }
}

// WHOLE: a block a row tile, its scores in shared memory (one slice of T);
// else persistent blocks over the T split's QK^T and PV items.
template <typename TT, int RT, bool STAGED, bool WHOLE>
__global__ void __launch_bounds__(kThreads, 1) attn_fused_lut_kernel(const Params p) {
  extern __shared__ int4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int tid = threadIdx.x;
  const TT* tab;
  int32_t* s_out;  // [RT][4][cg]: the k-lanes' sums of a tile
  if constexpr (STAGED) {
    stage_table16(smem4, p.table);
    tab = reinterpret_cast<const TT*>(smem);
    s_out = reinterpret_cast<int32_t*>(smem + gather::kTableBytes16);
  } else {
    tab = static_cast<const TT*>(p.table);
    s_out = reinterpret_cast<int32_t*>(smem);
  }
  const int max_cg = max(p.qk_cg, p.pv_cg);
  uint32_t* s_a = reinterpret_cast<uint32_t*>(s_out + RT * 4 * max_cg);
  const uint32_t row_base = STAGED ? static_cast<uint32_t>(__cvta_generic_to_shared(smem)) : 0u;
  for (int i = tid; i < RT * 4 * max_cg; i += kThreads) s_out[i] = 0;

  const int n_words = (p.T + 31) / 32;
  const int ld = 32 * n_words;  // score row stride: whole words
  const int row_tiles = p.M / p.bm;
  const int tiles = p.G * row_tiles;

  if constexpr (WHOLE) {
    float* slab = reinterpret_cast<float*>(s_a + kAWords);  // [bm][ld] scores, then [bm] ps
    float* row_ps = slab + size_t(p.bm) * ld;
    const int32_t* idx = reinterpret_cast<const int32_t*>(slab);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int g = tile / row_tiles;
      const size_t row0 = size_t(tile) * p.bm;
      for (int r0 = 0; r0 < p.bm; r0 += RT) {
        qk_rows<TT, RT, STAGED>(p, tab, row_base, s_out, s_a, g, row0, r0, min(RT, p.bm - r0),
                                0, p.T, slab, ld);
      }
      __syncthreads();
      // softmax and re-quantization of the whole rows, one warp a row
      for (int r = tid >> 5; r < p.bm; r += kThreads / 32) {
        const float ps = attn::softmax_requant_row<1>(slab + size_t(r) * ld, p.T);
        if ((tid & 31) == 0) row_ps[r] = ps;
      }
      __syncthreads();
      for (int r0 = 0; r0 < p.bm; r0 += RT) {
        pv_rows<TT, RT, STAGED>(
            p, tab, row_base, s_out, s_a, g, min(RT, p.bm - r0), 0, p.T,
            [&](int r, int k) {  // 16-byte aligned: ld and k are multiples of 4
              const int4 x = *reinterpret_cast<const int4*>(idx + size_t(r0 + r) * ld + k);
              return pack_indices(x.x, x.y, x.z, x.w);
            },
            [&](int r, int c, int32_t sum) {
              p.out[(row0 + r0 + r) * p.P + c] = __fmul_rn(
                  __fmul_rn(float(sum), row_ps[r0 + r]), p.sv[size_t(g) * p.P + c]);
            });
      }
      __syncthreads();  // the slab is read before the next tile's scores
    }
    return;
  } else {
    const int slices = (n_words + p.slice_words - 1) / p.slice_words;
    const int n_items = tiles * slices;  // of each kind
    float* ps = p.scores + size_t(p.G) * p.M * ld;     // (G, M) each row's ps,
    float* row_mx = ps + size_t(p.G) * p.M;            // max
    float* row_sum = row_mx + size_t(p.G) * p.M;       // and sum
    int32_t* acc = p.state + 1 + tsplit::kTileWords * tiles;  // (G, M, P)
    __shared__ float s_mx[kMaxRows], s_sum[kMaxRows], s_ps[kMaxRows];  // a PV sub-tile's rows
    for (;;) {
      // every block takes one ticket past the items, on which it stops
      const int ticket = tsplit::take_ticket(p.state, 2 * n_items + int(gridDim.x));
      if (ticket >= 2 * n_items) break;
      const bool qk = ticket < n_items;
      const int item = qk ? ticket : ticket - n_items;
      const int slice = item % slices;
      const int tile = item / slices;  // g * row_tiles + row tile
      const int g = tile / row_tiles;
      const size_t row0 = size_t(tile) * p.bm;
      const int t_begin = slice * p.slice_words * 32;
      const int t_end = min(p.T, t_begin + p.slice_words * 32);
      int* tile_words = p.state + 1 + tsplit::kTileWords * tile;
      float* scores = p.scores + row0 * ld;
      if (qk) {
        for (int r0 = 0; r0 < p.bm; r0 += RT) {
          qk_rows<TT, RT, STAGED>(p, tab, row_base, s_out, s_a, g, row0, r0,
                                  min(RT, p.bm - r0), t_begin, t_end, scores, ld);
        }
        if (tsplit::scores_met(tile_words, slices)) {
          // the tile's rows' max, sum in the fixed order and ps, one warp a
          // row from L2; the PV items re-quantize their own slices
          for (int r = tid >> 5; r < p.bm; r += kThreads / 32) {
            float* row = scores + size_t(r) * ld;
            const float mx = attn::row_max<attn::kBatch>(row, p.T);
            const float sum = attn::row_exp_sum<false, attn::kBatch>(row, p.T, mx);
            if ((tid & 31) == 0) {
              row_mx[row0 + r] = mx;
              row_sum[row0 + r] = sum;
              ps[row0 + r] = attn::prob_scale(sum);
            }
          }
          tsplit::mark_ready(tile_words);
        }
      } else {
        tsplit::wait_ready(tile_words);  // the tile's row steps are in
        for (int r0 = 0; r0 < p.bm; r0 += RT) {
          const int nr = min(RT, p.bm - r0);
          if (tid < nr) {  // read in pv_rows, after its first barrier
            s_mx[tid] = __ldcg(row_mx + row0 + r0 + tid);
            s_sum[tid] = __ldcg(row_sum + row0 + r0 + tid);
            s_ps[tid] = __ldcg(ps + row0 + r0 + tid);
          }
          pv_rows<TT, RT, STAGED>(
              p, tab, row_base, s_out, s_a, g, nr, t_begin, t_end,
              [&](int r, int k) {  // row r's scores of keys k .. k + 3, re-quantized
                const float4 x = __ldcg(
                    reinterpret_cast<const float4*>(scores + size_t(r0 + r) * ld + k));
                const float mx = s_mx[r], sum = s_sum[r], scale = s_ps[r];
                return pack_indices(attn::prob_index(attn::row_exp(x.x, mx), sum, scale),
                                    attn::prob_index(attn::row_exp(x.y, mx), sum, scale),
                                    attn::prob_index(attn::row_exp(x.z, mx), sum, scale),
                                    attn::prob_index(attn::row_exp(x.w, mx), sum, scale));
              },
              [&](int r, int c, int32_t sum) {
                atomicAdd(acc + (row0 + r0 + r) * p.P + c, sum);
              });
        }
        tsplit::pv_done<kThreads>(tile_words, slices, acc + row0 * p.P, p.bm, p.P, ps + row0,
                                  p.sv + size_t(g) * p.P, p.out + row0 * p.P);
      }
    }
  }
}

// The staged table, the tile's sums, the staged A and, when a block takes a
// row tile whole, its scores and scales (slab floats).
size_t smem_bytes(bool staged, int rt, int max_cg, size_t slab) {
  return (staged ? size_t(gather::kTableBytes16) : 0) + 16 * size_t(rt) * max_cg +
         4 * size_t(kAWords) + 4 * slab;
}

template <typename TT, int RT, bool STAGED, bool WHOLE>
int launch(const Params& p, int blocks, size_t smem, cudaStream_t stream) {
  // per device: the dynamic shared memory the kernel is set to take (the
  // block's static shared words come off the 227 KB, so no more is asked)
  static size_t configured[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return int(err);
  if (device >= 64) return int(cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && smem > configured[device]) {
    err = cudaFuncSetAttribute(attn_fused_lut_kernel<TT, RT, STAGED, WHOLE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    configured[device] = smem;
  }
  attn_fused_lut_kernel<TT, RT, STAGED, WHOLE><<<blocks, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename TT, bool STAGED, bool WHOLE>
int launch_rows(const Params& p, int rt, int blocks, size_t smem, cudaStream_t s) {
  switch (rt) {
    case 1: return launch<TT, 1, STAGED, WHOLE>(p, blocks, smem, s);
    case 2: return launch<TT, 2, STAGED, WHOLE>(p, blocks, smem, s);
    case 4: return launch<TT, 4, STAGED, WHOLE>(p, blocks, smem, s);
    case 8: return launch<TT, 8, STAGED, WHOLE>(p, blocks, smem, s);
    case 16: return launch<TT, 16, STAGED, WHOLE>(p, blocks, smem, s);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename TT, bool STAGED>
int launch_typed(const Params& p, int rt, bool whole, int blocks, size_t smem,
                 cudaStream_t s) {
  return whole ? launch_rows<TT, STAGED, true>(p, rt, blocks, smem, s)
               : launch_rows<TT, STAGED, false>(p, rt, blocks, smem, s);
}

bool pow2_in(int x, int lo, int hi) { return x >= lo && x <= hi && (x & (x - 1)) == 0; }

}  // namespace

extern "C" {

// q (G, M, D), kt (G, D, T), v (G, T, P) int8; sq (G, M), sk (G, T),
// sv (G, P) float32; mask (G, M, T) int32; table (256, 256) int16 or int32
// (16-byte aligned); out (G, M, P) float32.  state: 1 + 3 G (M / bm) + G M P
// int32 zeros, left zero; scores: G M (32 ceil(T / 32)) + 3 G M float32
// (both unread when whole).  bm must divide M; rt (1, 2, 4, 8 or 16) is the
// sub-tile; slice_words (>= 1) the T slice in 32-column words; qk_cg and
// pv_cg (powers of two from 4 to 64) the column groups of 4 of a QK^T and a
// PV tile; staged (the table in shared memory) only with the int16 table;
// whole (1 only with one slice) keeps a row tile's scores in shared memory
// and runs it in one block; blocks (>= 1) the grid, which changes no bit.
// Returns a cudaError_t (0 on success).
int attn_fused_lut(const int8_t* q, const int8_t* kt, const int8_t* v, const float* sq,
                   const float* sk, const float* sv, const int32_t* mask, const void* table,
                   int table_int16, float* out, int* state, float* scores, float scale, int G,
                   int M, int D, int T, int P, int bm, int rt, int slice_words, int qk_cg,
                   int pv_cg, int staged, int whole, int blocks, void* stream) {
  const int n_words = (T + 31) / 32;
  if (G < 1 || M < 1 || D < 1 || T < 1 || P < 1 || bm < 1 || M % bm != 0 ||
      !pow2_in(rt, 1, kMaxRows) || slice_words < 1 || !pow2_in(qk_cg, 4, kMaxCg) ||
      !pow2_in(pv_cg, 4, kMaxCg) || blocks < 1 || (staged && !table_int16) ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 || (whole && slice_words < n_words) ||
      (!whole && (state == nullptr || scores == nullptr))) {
    return int(cudaErrorInvalidValue);
  }
  const long long slices = (n_words + slice_words - 1) / slice_words;
  if (2LL * G * (M / bm) * slices + blocks > 2147483647LL) {
    return int(cudaErrorInvalidConfiguration);
  }
  const size_t slab = whole ? size_t(bm) * (32 * size_t(n_words) + 1) : 0;
  const size_t smem = smem_bytes(staged, rt, qk_cg > pv_cg ? qk_cg : pv_cg, slab);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidConfiguration);
  const Params p{q, kt, v, sq, sk, sv, mask, table, out, state, scores, scale, G, M, D, T, P,
                 bm, slice_words, qk_cg, pv_cg,
                 D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0,
                 T % 4 == 0 && reinterpret_cast<uintptr_t>(kt) % 4 == 0,
                 P % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 4 == 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged) return launch_typed<int16_t, true>(p, rt, whole, blocks, smem, s);
  if (table_int16) return launch_typed<int16_t, false>(p, rt, whole, blocks, smem, s);
  return launch_typed<int32_t, false>(p, rt, whole, blocks, smem, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
