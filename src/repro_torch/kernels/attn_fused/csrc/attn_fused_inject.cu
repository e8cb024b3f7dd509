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
// What bounds it on this card: integer and logic operations, the replay's
// per 32-pair word (chip_smoke.replay_ops) for G M ceil(T/32) D words of
// QK^T and G M ceil(P/32) T words of PV: at gemma-2b's 8192-token decode
// as many as the replay matmul's (2, 2048, 16384).
//
// Design.  The key axis T is split over blocks (attn_tsplit.cuh): a launch
// runs QK^T items, one per (group, row tile of bm rows, slice of T in
// whole 32-column words), then PV items over the same slices, 128 threads
// each, so that a decode of 8 rows over a long cache fills the card (the
// slicing: kernel.py, inject_launch_plan).  Scores go to a float32 scratch
// in device memory, not to shared memory; the last QK^T item of a row tile
// runs the softmax of its rows from L2; PV items wait for it, add their
// int32 sums into an accumulator, and the last writes the output.  Where T
// stays one slice (a served decode or prefill: one word) and the tile's
// scores fit, one block takes the row tile whole, its scores in shared
// memory, QK^T, softmax and PV back to back (`whole`): no hand-off between
// blocks, which cost the served decode a tenth of its time.  Both
// products run replay_device.cuh's tile loop, the device code of the
// replay matmul (inject_replay.cu): the schedule is a program in shared
// memory, B (K^T, then V) is packed into 32-column words inside the block
// with ballots, and each thread adds its (row, word) products into a
// bit-sliced accumulator, J k values at a time (J = 3 where the wire slots
// fit and a block has a step of work for every item, else 1).  A tile is
// qk_wpb words x qk_rpb rows x the rest of the block's threads as k-lanes
// for QK^T (K = D), pv_wpb x pv_rpb for PV (K = the slice), as the wrapper's
// block_shape picks them; a block walks its rows and words in such tiles.
// The k-lanes' sums meet in shared memory, exact modulo 2**32.  The word
// padding of T (the last K^T word) and of P (the last V word) reads index
// 128 and is never written: the kernel returns (G, M, P).
#include <cstdint>
#include <cuda_runtime.h>

#include "attn_softmax.cuh"
#include "attn_tsplit.cuh"
#include "replay_device.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 3;         // J where it fits (else 1)
constexpr int kMaxSmem = 232448;  // shared memory a block may take on Hopper (227 KB)

// Packed B words of a tile of rpb rows: J items x kpb k-lanes x n_opbits bits x wpb words.
__host__ __device__ inline int y_words(int items, int n_opbits, int rpb) {
  return items * n_opbits * (kThreads / rpb);
}

struct Params {
  const int8_t* q;             // (G, M, D)
  const int8_t* kt;            // (G, D, T)
  const int8_t* v;             // (G, T, P)
  const float* sq;             // (G, M)
  const float* sk;             // (G, T)
  const float* sv;             // (G, P)
  const int32_t* mask;         // (G, M, T), 0 = masked
  float* out;                  // (G, M, P)
  int* state;                  // zero between calls: ticket, tile counters, accumulator
  float* scores;               // (G, M, ld) scores, then (G, M) ps
  const uint32_t* program;     // (n_ops, 2) ops
  const uint32_t* fin;         // (kPos, 2) slots of the final bits by position
  const uint32_t* value_bits;  // (256,) stored bits of each operand index
  int n_ops, n_opbits, n_slots, offset;
  float scale;
  int G, M, D, T, P, bm, slice_words, qk_wpb, qk_rpb, pv_wpb, pv_rpb;
};

// WHOLE: one block takes a row tile whole (its scores in shared memory);
// else the T split's QK^T and PV items (attn_tsplit.cuh).
template <int J, bool WHOLE>
__global__ void __launch_bounds__(kThreads, 1) attn_fused_inject_kernel(const Params p) {
  extern __shared__ uint2 smem2[];
  uint2* s_ops = smem2;                                                 // [record]
  uint32_t* s_slots = reinterpret_cast<uint32_t*>(s_ops + p.n_ops);     // [slot][item][thread]
  uint32_t* s_y = s_slots + p.n_slots * J * kThreads;                   // [k-lane][bit][word]
  uint32_t* s_vbits = s_y + y_words(J, p.n_opbits, min(p.qk_rpb, p.pv_rpb));
  uint32_t* s_fin = s_vbits + 256;
  const int tid = threadIdx.x;
  replay::load_program<kThreads>(s_ops, s_vbits, s_fin, p.program, p.n_ops, p.value_bits, p.fin);
#pragma unroll
  for (int j = 0; j < J; ++j) s_slots[j * kThreads + tid] = 0u;  // slot 0: the zero word

  const int n_words = (p.T + 31) / 32;
  const int ld = 32 * n_words;  // score row stride: whole words
  const int slices = (n_words + p.slice_words - 1) / p.slice_words;
  const int row_tiles = p.M / p.bm;
  const int n_items = p.G * row_tiles * slices;  // of each kind (one kind when whole)
  // whole row tiles depend on no other block: they take their item from the grid
  const int ticket = WHOLE ? int(blockIdx.x) : tsplit::take_ticket(p.state, 2 * n_items);
  const bool qk = ticket < n_items;
  const int item = qk ? ticket : ticket - n_items;
  const int slice = item % slices;
  const int tile = item / slices;  // g * row_tiles + row tile
  const int g = tile / row_tiles;
  const size_t row0 = size_t(tile) * p.bm;  // first (g, m) row of the tile
  const int word_begin = slice * p.slice_words;
  const int word_end = min(n_words, word_begin + p.slice_words);
  int* tile_words = p.state + 1 + tsplit::kTileWords * tile;
  int32_t* acc = p.state + 1 + tsplit::kTileWords * p.G * row_tiles;  // (G, M, P)
  float* ps = p.scores + size_t(p.G) * p.M * ld;                      // (G, M)
  // the tile's scores and scales: in shared memory when the block takes the
  // whole of T (one slice), else in the scratch
  float* slab = reinterpret_cast<float*>(s_fin + 2 * replay::kPos);   // [bm][ld], then [bm]
  float* scores = WHOLE ? slab : p.scores + row0 * ld;
  float* row_ps = WHOLE ? slab + p.bm * ld : ps + row0;

  if (qk) {
    // QK^T over the slice's words: masked scores
    const int8_t* kt_g = p.kt + size_t(g) * p.D * p.T;
    const int wpb = p.qk_wpb, rpb = p.qk_rpb;
    for (int r0 = 0; r0 < p.bm; r0 += rpb) {
      for (int word0 = word_begin; word0 < word_end; word0 += wpb) {
        const int row = r0 + (tid / wpb) % rpb;
        const bool active = row < p.bm && word0 + tid % wpb < word_end;
        const int8_t* q_row = p.q + (row0 + (active ? row : 0)) * p.D;
        uint32_t sums[32];
        const uint32_t n_k = replay::replay_tile<kThreads, J>(
            sums, s_ops, p.n_ops, s_vbits, p.n_opbits, s_fin, s_slots, s_y, wpb, rpb, word0, p.T,
            active, 0, p.D, [&](int k) { return int(q_row[k]) + 128; },
            [&](int k, int col) { return int(kt_g[size_t(k) * p.T + col]) + 128; });
        replay::reduce_tile<kThreads, J>(
            sums, n_k * uint32_t(p.offset), s_slots, wpb, rpb,
            [&](int r, int w, int l, uint32_t sum) {
              const int rr = r0 + r;
              const int t = (word0 + w) * 32 + l;
              if (rr < p.bm && word0 + w < word_end && t < p.T) {
                scores[rr * ld + t] = attn::masked_score(
                    int32_t(sum), p.sq[row0 + rr], p.sk[size_t(g) * p.T + t], p.scale,
                    p.mask[(row0 + rr) * p.T + t]);
              }
            });
      }
    }
    if constexpr (!WHOLE) {
      tsplit::scores_done<kThreads>(tile_words, slices, scores, ld, p.bm, p.T, row_ps);
      return;
    }
    // softmax and re-quantization of the whole rows, one warp a row
    __syncthreads();
    for (int r = tid >> 5; r < p.bm; r += kThreads / 32) {
      const float scale = attn::softmax_requant_row<1>(scores + size_t(r) * ld, p.T);
      if ((tid & 31) == 0) row_ps[r] = scale;
    }
    __syncthreads();
  } else {
    tsplit::wait_ready(tile_words);  // the tile's probabilities are in
  }

  // PV over the slice's columns of T
  const int8_t* v_g = p.v + size_t(g) * p.T * p.P;
  const int32_t* idx = reinterpret_cast<const int32_t*>(scores);
  const int k_begin = word_begin * 32;
  const int k_end = min(p.T, word_end * 32);
  const int p_words = (p.P + 31) / 32;
  const int wpb = p.pv_wpb, rpb = p.pv_rpb;
  for (int r0 = 0; r0 < p.bm; r0 += rpb) {
    for (int word0 = 0; word0 < p_words; word0 += wpb) {
      const int row = r0 + (tid / wpb) % rpb;
      const bool active = row < p.bm && word0 + tid % wpb < p_words;
      const int32_t* idx_row = idx + (active ? row : 0) * ld;
      uint32_t sums[32];
      const uint32_t n_k = replay::replay_tile<kThreads, J>(
          sums, s_ops, p.n_ops, s_vbits, p.n_opbits, s_fin, s_slots, s_y, wpb, rpb, word0, p.P,
          active, k_begin, k_end,
          [&](int k) {
            if constexpr (WHOLE) return idx_row[k];
            return __ldcg(idx_row + k);
          },
          [&](int k, int col) { return int(v_g[size_t(k) * p.P + col]) + 128; });
      replay::reduce_tile<kThreads, J>(
          sums, n_k * uint32_t(p.offset), s_slots, wpb, rpb,
          [&](int r, int w, int l, uint32_t sum) {
            const int rr = r0 + r;
            const int c = (word0 + w) * 32 + l;
            if (rr < p.bm && c < p.P) {
              if constexpr (WHOLE) {
                p.out[(row0 + rr) * p.P + c] = __fmul_rn(
                    __fmul_rn(float(int32_t(sum)), row_ps[rr]), p.sv[size_t(g) * p.P + c]);
              } else {
                atomicAdd(reinterpret_cast<unsigned int*>(acc) + (row0 + rr) * p.P + c, sum);
              }
            }
          });
    }
  }
  if constexpr (!WHOLE) {
    tsplit::pv_done<kThreads>(tile_words, slices, acc + row0 * p.P, p.bm, p.P, row_ps,
                              p.sv + size_t(g) * p.P, p.out + row0 * p.P);
  }
}

// The program, the wire slots, the packed B, the operand bits, the final
// bits' slots and, when a block takes the whole of T, its rows' scores and
// scales (slab floats).
size_t smem_bytes(int items, int n_slots, int n_opbits, int n_ops, int rpb, size_t slab) {
  return sizeof(uint32_t) * (2 * size_t(n_ops) + size_t(n_slots) * items * kThreads +
                             size_t(y_words(items, n_opbits, rpb)) + 256 + 2 * replay::kPos +
                             slab);
}

bool valid_shape(int wpb, int rpb) {
  return wpb >= 1 && rpb >= 1 && (wpb & (wpb - 1)) == 0 && kThreads % (wpb * rpb) == 0;
}

template <int J, bool WHOLE>
int launch(const Params& p, int blocks, cudaStream_t stream) {
  const size_t slab = WHOLE ? size_t(p.bm) * (32 * ((p.T + 31) / 32) + 1) : 0;
  const size_t smem =
      smem_bytes(J, p.n_slots, p.n_opbits, p.n_ops, min(p.qk_rpb, p.pv_rpb), slab);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidConfiguration);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_fused_inject_kernel<J, WHOLE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
  }
  attn_fused_inject_kernel<J, WHOLE><<<blocks, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (G, M, D), kt (G, D, T), v (G, T, P) int8; sq (G, M), sk (G, T),
// sv (G, P) float32; mask (G, M, T) int32; out (G, M, P) float32.  state:
// 1 + 3 G (M / bm) + G M P int32 zeros, left zero; scores: G M (32
// ceil(T / 32)) + G M float32.  The program tables come from
// replay_program; bm must divide M; slice_words (>= 1) is the T slice in
// 32-column words; whole (1 only with one slice) keeps a tile's scores in
// shared memory and runs it in one block; each (wpb, rpb) must divide the
// block's 128 threads; items is 1 or 3.  Returns a cudaError_t (0 on success).
int attn_fused_inject(const int8_t* q, const int8_t* kt, const int8_t* v, const float* sq,
                      const float* sk, const float* sv, const int32_t* mask, float* out,
                      int* state, float* scores, const uint32_t* program, int n_ops,
                      const uint32_t* fin, const uint32_t* value_bits, int n_opbits, int n_slots,
                      int offset, float scale, int G, int M, int D, int T, int P, int bm,
                      int slice_words, int qk_wpb, int qk_rpb, int pv_wpb, int pv_rpb,
                      int items, int whole, void* stream) {
  if (G < 1 || M < 1 || D < 1 || T < 1 || P < 1 || bm < 1 || M % bm != 0 || slice_words < 1 ||
      n_ops < 1 || n_opbits < 1 || n_opbits > replay::kMaxOpBits || n_slots < 32 ||
      n_slots > 256 || !valid_shape(qk_wpb, qk_rpb) || !valid_shape(pv_wpb, pv_rpb) ||
      (items != 1 && items != kItems) || state == nullptr || scores == nullptr ||
      (whole && slice_words < (T + 31) / 32)) {
    return int(cudaErrorInvalidValue);
  }
  const long long slices = ((T + 31) / 32 + slice_words - 1) / slice_words;
  const long long grid = (whole ? 1LL : 2LL) * G * (M / bm) * slices;
  if (grid > 2147483647LL) return int(cudaErrorInvalidConfiguration);
  const int blocks = int(grid);
  const Params p{q, kt, v, sq, sk, sv, mask, out, state, scores, program, fin, value_bits,
                 n_ops, n_opbits, n_slots, offset, scale, G, M, D, T, P, bm, slice_words,
                 qk_wpb, qk_rpb, pv_wpb, pv_rpb};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (whole) return items == 1 ? launch<1, true>(p, blocks, s) : launch<kItems, true>(p, blocks, s);
  return items == 1 ? launch<1, false>(p, blocks, s) : launch<kItems, false>(p, blocks, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
