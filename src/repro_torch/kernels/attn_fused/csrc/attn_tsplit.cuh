// The T split of the fused AMR attention kernels: the key axis T of a row
// tile cut into slices of whole 32-column words, each slice a block of its
// own, joined inside one launch.  attn_fused_inject.cu and attn_fused_lut.cu
// run on it.
//
// A launch runs two kinds of work item, by ticket (take_ticket): first
// every QK^T item (group, row tile, slice), then every PV item.  Per row
// tile (tile = g * (M / bm) + row tile):
//   * each QK^T item writes its slice's masked float32 scores into a score
//     scratch of G x M rows (row stride a multiple of 32 floats, so every
//     128-byte line has one writer) and counts itself done (scores_met);
//     the last one of the tile runs its rows' softmax steps, one warp a
//     row, reading the rows from L2 (the lane order of a row's float sum
//     depends on T alone, so the bits are the plain version's whatever the
//     slicing), and marks the tile ready (mark_ready).  scores_done runs
//     attn_softmax.cuh's softmax_requant_row there: the probability indices
//     over the scores and the row scale ps.  (The LUT kernel writes only
//     each row's max, sum and ps there, and its PV items re-quantize their
//     own slices.)
//   * each PV item waits until its tile is ready (wait_ready), adds its
//     slice's int32 sums into an accumulator (G, M, P) by atomics (exact
//     modulo 2**32 in any order) and counts itself done (pv_done); the last
//     one of the tile writes out = float(sum) * ps * sv and zeroes the
//     accumulator and the tile's counters.
// A PV item spins only on a tile whose QK^T items all hold lower tickets, so
// they are running or done: no deadlock whatever order the card starts
// blocks in.  The block with the last ticket zeroes the ticket counter.  So
// the per-stream state (counters and accumulator) is zero between calls and
// a call is one launch.
//
// Scratch the launch reads beside its operands (the wrapper caches both per
// stream):
//   state  int32, zero between calls: [0] the ticket, then per tile
//          [qk done, ready, pv done], then the accumulator (G, M, P);
//   scores float32 (G, M, ld) then ps (G, M) (the LUT kernel: then each
//          row's max and sum, (G, M) each).
// Data another block wrote is read through L2 (__ldcg), never L1.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "attn_softmax.cuh"

namespace tsplit {

constexpr int kTileWords = 3;  // counters of a row tile: qk done, ready, pv done

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// This block's ticket in [0, total), the same in every thread; the block
// that takes the last one zeroes the counter (every other is taken).
__device__ __forceinline__ int take_ticket(int* counter, int total) {
  __shared__ int s_ticket;
  if (threadIdx.x == 0) {
    const int t = atomicAdd(counter, 1);
    if (t == total - 1) atomicExch(counter, 0);
    s_ticket = t;
  }
  __syncthreads();
  return s_ticket;
}

// After a QK^T item has written its scores: count it.  True, in every
// thread, in the tile's last item, which then sees every item's scores.
__device__ __forceinline__ bool scores_met(int* tile_words, int slices) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(tile_words, 1) == slices - 1;
  __syncthreads();
  if (!s_last) return false;
  __threadfence();
  return true;
}

// The tile's last QK^T item, its rows' work written: the tile is ready.
__device__ __forceinline__ void mark_ready(int* tile_words) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    tile_words[0] = 0;
    st_release(tile_words + 1, 1);
  }
}

// After a QK^T item has written its scores: count it; the tile's last item
// re-quantizes every row of the tile (rows rows from `scores`, stride ld,
// T scores each; ps[r] their scales) and marks the tile ready.
template <int kThreads>
__device__ __forceinline__ void scores_done(int* tile_words, int slices, float* scores, int ld,
                                            int rows, int T, float* ps) {
  if (!scores_met(tile_words, slices)) return;
  for (int r = threadIdx.x >> 5; r < rows; r += kThreads / 32) {
    const float scale = attn::softmax_requant_row<attn::kBatch>(scores + size_t(r) * ld, T);
    if ((threadIdx.x & 31) == 0) ps[r] = scale;
  }
  mark_ready(tile_words);
}

// Before a PV item reads the probability indices: wait until the tile is ready.
__device__ __forceinline__ void wait_ready(const int* tile_words) {
  if (threadIdx.x == 0) {
    while (ld_acquire(tile_words + 1) == 0) __nanosleep(200);
    __threadfence();
  }
  __syncthreads();
}

// After a PV item has added its sums into acc: count it; the tile's last
// item writes out[r][c] = float(acc) * ps[r] * sv[c] for its rows x P (acc
// and out at the tile's first row, ps likewise, sv the group's), in the
// plain version's rounding order, and zeroes acc and the tile's counters.
template <int kThreads>
__device__ __forceinline__ void pv_done(int* tile_words, int slices, int32_t* acc, int rows,
                                        int P, const float* ps, const float* sv, float* out) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(tile_words + 2, 1) == slices - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < rows * P; i += kThreads) {
    const int r = i / P;
    const int c = i - r * P;
    const int32_t sum = __ldcg(acc + i);
    __stcg(acc + i, 0);
    out[i] = __fmul_rn(__fmul_rn(float(sum), __ldcg(ps + r)), sv[c]);
  }
  if (threadIdx.x == 0) {
    tile_words[1] = 0;
    tile_words[2] = 0;
  }
}

}  // namespace tsplit
