// The gather of the full-table AMR gather matmul, shared by the gather
// matmul (lut_matmul.cu) and the fused attention LUT kernel
// (attn_fused/csrc/attn_fused_lut.cu), which runs QK^T and PV as such
// products: a group of 4 k of a tile of RT rows x 4 columns (gather_group),
// its b read with loads that do not allocate in L1 (load_stream), its A
// staged in shared memory as each k's table-row address up to RT = 4 and as
// row bytes above (kRowAddr), the table read from shared memory (STAGED:
// the int16 table, kTableBytes16) or through L1.  Each kernel keeps its own
// tile loop around it: the gather matmul's compiles to the same SASS with
// this header as without it, where its loop written on the fused kernel's
// generalised pieces (b's row stride apart from its column end, A staged
// by a callback) did not (PERF.md).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gather {

constexpr int kTableBytes16 = 256 * 256 * 2;  // the int16 table, staged

__device__ __forceinline__ uint32_t load_stream(const int8_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Byte i of a word, zero-extended.
__device__ __forceinline__ int byte_of(uint32_t w, int i) {
  return int(__byte_perm(w, 0u, 0x4440u | uint32_t(i)));
}

// A table entry: from shared memory at a byte address (row address + 2 col),
// or through L1 at an element index (256 row + col).
template <typename T, bool STAGED>
__device__ __forceinline__ int gather(const T* tab, uint32_t row, uint32_t col) {
  if constexpr (STAGED) {
    int v;
    asm volatile("ld.shared.s16 %0, [%1];" : "=r"(v) : "r"(row + col));
    return v;
  } else {
    return int(__ldg(tab + (row + col)));
  }
}

// How A is staged: up to 4 rows a tile, as each k's table-row address (a
// row then costs no extraction, which matters where integer issue bounds
// the kernel, at M = 2); above, as the row bytes, 4 k a word (16 rows of
// addresses take the registers that the 64 sums need, and there shared
// memory bounds the kernel).
template <int RT>
constexpr bool kRowAddr = RT <= 4;

// One group of 4 k (kv of them valid; all 4 when FULL, with no test a k).
// s_a: the group's A in row 0, rows a_stride words apart: 4 row addresses
// a row (kRowAddr), or one word of 4 row bytes (+ 128) a row.  bw: the b
// words (row i of the group in word i, column c in byte c).  A column's
// offset is taken once a k for the RT rows and a gather is one add and one
// load.  With row addresses the k go in pairs and the sums take two
// gathers an add.
template <typename T, int RT, bool STAGED, bool FULL>
__device__ __forceinline__ void gather_group(const T* tab, const uint32_t* s_a, int a_stride,
                                             uint32_t row_base, int kv, const uint32_t bw[4],
                                             int (&acc)[RT][4]) {
  constexpr int kColShift = STAGED ? 1 : 0;  // a column: 2 bytes, or 1 entry
  constexpr int kRowShift = STAGED ? 9 : 8;  // a row: 512 bytes, or 256 entries
  if constexpr (kRowAddr<RT>) {
#pragma unroll
    for (int i0 = 0; i0 < 4; i0 += 2) {
      if (!FULL && i0 >= kv) break;
      uint32_t col[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t bx = bw[i0 + h] ^ 0x80808080u;
#pragma unroll
        for (int c = 0; c < 4; ++c) col[h][c] = uint32_t(byte_of(bx, c)) << kColShift;
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const uint2 row = *reinterpret_cast<const uint2*>(s_a + r * a_stride + i0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (FULL || i0 + 1 < kv) {
            acc[r][c] += gather<T, STAGED>(tab, row.x, col[0][c]) +
                         gather<T, STAGED>(tab, row.y, col[1][c]);
          } else {
            acc[r][c] += gather<T, STAGED>(tab, row.x, col[0][c]);
          }
        }
      }
    }
  } else {
    uint32_t aw[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) aw[r] = s_a[r * a_stride];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (FULL || i < kv) {
        const uint32_t bx = bw[i] ^ 0x80808080u;
        uint32_t col[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) col[c] = uint32_t(byte_of(bx, c)) << kColShift;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const uint32_t row = row_base + (uint32_t(byte_of(aw[r], i)) << kRowShift);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += gather<T, STAGED>(tab, row, col[c]);
        }
      }
    }
  }
}

}  // namespace gather
