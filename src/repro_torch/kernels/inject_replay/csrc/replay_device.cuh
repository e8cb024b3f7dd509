// Device code of the bit-sliced AMR-MUL circuit replay, shared by the
// replay matmul (inject_replay.cu) and the fused attention kernel
// (attn_fused/csrc/attn_fused_inject.cu).
//
// The circuit is data, not code: the host lowers a schedule once
// (kernels/inject_replay/kernel.py, replay_program) into
//   * a program of ops, each a PP gate (x bit, y word -> wire) or a reduction
//     cell (3 wires -> sum wire, carry wire), with the gate's or cell's truth
//     tables as bytes in the LOP3 convention (bit a*4 + b*2 + c is f(a, b, c));
//   * wire *slots*: a wire's slot is reused once its last reader has run, so
//     a schedule of 302 wires needs about 65 slots;
//   * the slots of the final bits by bit position (at most two per position:
//     the reduction stops at column height 2), and the polarity offset;
//   * the 256 operand values' stored MRSD bits as bitfields.
// So one build serves every schedule, DSE candidates included.
//
// Work per thread: one (row, 32-column word) pair over a range of k.  A word
// holds 32 columns of B, one per bit, so every wire of the replay is one
// 32-bit word and every logic op evaluates 32 products.  The A operand is
// the same for the 32 columns: its stored bits become full-word masks.  The
// 32 products of a k are summed into a bit-sliced accumulator (word p = bit
// p of all 32 lanes' sums): the two final rows are added by one carry-save
// step and one ripple, about 4 LOP3s per bit position.  Sums are modulo
// 2**32, which is exact because the callers bound K * max|product| below
// 2**31.  A 32x32 bit transpose then turns the bit slices into lane sums.
//
// B words are packed in the block: per k step each warp packs (k, word)
// pairs with one ballot per stored bit (lane = column) into a shared tile
// that every row of the block reads.  Columns past N read index 128 (value
// 0) and are never written out.
//
// Wires live in shared memory, [slot][thread], so a warp's accesses hit 32
// banks; ops, value bits and final slots are read at one address per warp
// (broadcast).  A block of kThreads threads is wpb words x rpb rows x kpb
// k-lanes; the k-lanes' partial sums meet in shared memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace replay {

constexpr int kPos = 24;  // final-bit positions read per k (int8 products use 19)

template <int TT>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(TT));
  return d;
}

// f(a, b, c) for a truth table known only at run time: the OR of the
// minterms the table selects, each minterm one LOP3.  All threads of a warp
// run the same op, so the tests of tt are uniform and need no branch.  (A
// 256-way switch of single LOP3s compiled to a binary search of branches
// and ran slower; PERF.md.)
__device__ __forceinline__ uint32_t lut3(uint32_t tt, uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r = 0u;
  if (tt & 0x01u) r |= lop3<0x01>(a, b, c);
  if (tt & 0x02u) r |= lop3<0x02>(a, b, c);
  if (tt & 0x04u) r |= lop3<0x04>(a, b, c);
  if (tt & 0x08u) r |= lop3<0x08>(a, b, c);
  if (tt & 0x10u) r |= lop3<0x10>(a, b, c);
  if (tt & 0x20u) r |= lop3<0x20>(a, b, c);
  if (tt & 0x40u) r |= lop3<0x40>(a, b, c);
  if (tt & 0x80u) r |= lop3<0x80>(a, b, c);
  return r;
}

__device__ __forceinline__ uint32_t xor3(uint32_t a, uint32_t b, uint32_t c) {
  return lop3<0x96>(a, b, c);
}

__device__ __forceinline__ uint32_t maj(uint32_t a, uint32_t b, uint32_t c) {
  return lop3<0xE8>(a, b, c);
}

// In place: afterwards bit r of v[c] is what bit c of v[r] was.
__device__ __forceinline__ void transpose32(uint32_t (&v)[32]) {
  const uint32_t masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu, 0x33333333u, 0x55555555u};
#pragma unroll
  for (int level = 0; level < 5; ++level) {
    const int j = 16 >> level;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if ((r & j) == 0) {
        const uint32_t t = ((v[r] >> j) ^ v[r + j]) & masks[level];
        v[r + j] ^= t;
        v[r] ^= t << j;
      }
    }
  }
}

// Copies the program's tables to shared memory (no barrier): the ops (2 words
// each, s_ops 8-byte aligned), the operands' stored bits and the final bits'
// slots.
template <int kThreads>
__device__ __forceinline__ void load_program(uint32_t* s_ops, uint32_t* s_vbits, uint32_t* s_fin,
                                             const uint32_t* program, int n_ops,
                                             const uint32_t* value_bits, const uint32_t* fin) {
  for (int i = threadIdx.x; i < 2 * n_ops; i += kThreads) s_ops[i] = program[i];
  for (int i = threadIdx.x; i < 256; i += kThreads) s_vbits[i] = value_bits[i];
  for (int i = threadIdx.x; i < 2 * kPos; i += kThreads) s_fin[i] = fin[i];
}

// Replays the circuit for one k (operand x with stored bits xb, the 32
// columns' stored-bit words at y[j * y_stride]) and adds the 32 products
// into the bit-sliced accumulator.  `my` is this thread's slot 0; slot s is
// my[s * kThreads].  s_ops must be 8-byte aligned: an op's two words are one
// 64-bit shared load from a 32-bit shared address.  (Indexed through an
// inlined helper, the op loop otherwise kept its addresses in per-thread
// registers and the replay matmul ran 3% slower than when the loop sat in
// its kernel; with this load it runs as fast or faster.  PERF.md.)
template <int kThreads>
__device__ __forceinline__ void replay_add(uint32_t (&acc)[32], const uint32_t* s_ops, int n_ops,
                                           const uint32_t* s_fin, uint32_t xb, const uint32_t* y,
                                           int y_stride, uint32_t* my) {
  const uint32_t ops = static_cast<uint32_t>(__cvta_generic_to_shared(s_ops));
  for (int i = 0; i < n_ops; ++i) {
    uint32_t op0, op1;
    asm("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(op0), "=r"(op1) : "r"(ops + 8 * i));
    const uint32_t f0 = op0 & 0xFFu, f1 = (op0 >> 8) & 0xFFu, f2 = (op0 >> 16) & 0xFFu;
    if ((op0 >> 24) == 0u) {  // PP gate: x bit f0 as a full-word mask, y word f1
      const uint32_t xm = 0u - ((xb >> f0) & 1u);
      const uint32_t yw = y[f1 * y_stride];
      my[(op1 & 0xFFu) * kThreads] = lut3((op1 >> 16) & 0xFFu, xm, yw, yw);
    } else {  // reduction cell: inputs read before either output is written
      const uint32_t a = my[f0 * kThreads], b = my[f1 * kThreads], c = my[f2 * kThreads];
      const uint32_t s = lut3((op1 >> 16) & 0xFFu, a, b, c);
      const uint32_t cy = lut3(op1 >> 24, a, b, c);
      my[(op1 & 0xFFu) * kThreads] = s;
      my[((op1 >> 8) & 0xFFu) * kThreads] = cy;
    }
  }
  // acc += row0 + row1: a carry-save step, then a ripple over all 32 bits
  uint32_t carry = 0u, cin = 0u;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    uint32_t x0 = 0u, x1 = 0u;
    if (q < kPos) {
      x0 = my[s_fin[2 * q] * kThreads];
      x1 = my[s_fin[2 * q + 1] * kThreads];
    }
    const uint32_t s = xor3(acc[q], x0, x1);
    const uint32_t cout = maj(acc[q], x0, x1);
    acc[q] = xor3(s, cin, carry);
    carry = maj(s, cin, carry);
    cin = cout;
  }
}

// The sums of one tile of wpb words x rpb rows over k in [k_begin, k_end),
// with k spread over the block's kpb = kThreads / (wpb * rpb) k-lanes.
// Thread (tx, ty, tz) takes word word0 + tx and row ty of the tile when
// `active`, and k = k_begin + tz, + kpb, ...  a_index(k) gives its row's
// operand index at k; b_index(k, col) the B operand index at (k, col), col
// < n_cols.  `s_slots` holds the n_slots x kThreads wire slots with slot 0
// zero, `s_y` kpb * n_opbits * wpb words; s_ops, s_vbits and s_fin are
// load_program's tables, n_opbits the stored bits of an operand.  The
// accumulator holds this thread's 32 lane sums, bit-sliced, each with n_k
// (the return value) times the polarity offset not yet subtracted.  Starts
// with a barrier, so the caller may reuse shared memory read by an earlier
// tile.
template <int kThreads, typename AIndex, typename BIndex>
__device__ __forceinline__ uint32_t replay_tile(uint32_t (&acc)[32], const uint32_t* s_ops,
                                                int n_ops, const uint32_t* s_vbits, int n_opbits,
                                                const uint32_t* s_fin, uint32_t* s_slots,
                                                uint32_t* s_y, int wpb, int rpb, int word0,
                                                int n_cols, bool active, int k_begin, int k_end,
                                                AIndex a_index, BIndex b_index) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int kpb = kThreads / (wpb * rpb);
  const int tx = tid % wpb;
  const int tz = tid / (wpb * rpb);
  uint32_t* my = s_slots + tid;
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0u;
  uint32_t n_k = 0;
  for (int kt = k_begin; kt < k_end; kt += kpb) {
    __syncthreads();  // tables loaded / the previous B tile consumed
    for (int pi = tid >> 5; pi < kpb * wpb; pi += kThreads / 32) {
      const int kk = pi / wpb;
      const int ww = pi % wpb;
      const int k = kt + kk;
      const int col = (word0 + ww) * 32 + lane;
      const int idx = (k < k_end && col < n_cols) ? b_index(k, col) : 128;
      const uint32_t bits = s_vbits[idx];
      uint32_t mine = 0u;
      for (int j = 0; j < n_opbits; ++j) {  // one ballot per stored bit, lane = column
        const uint32_t w = __ballot_sync(0xFFFFFFFFu, (bits >> j) & 1u);
        if (lane == j) mine = w;
      }
      if (lane < n_opbits) s_y[(kk * n_opbits + lane) * wpb + ww] = mine;
    }
    __syncthreads();
    const int k = kt + tz;
    if (!active || k >= k_end) continue;
    replay_add<kThreads>(acc, s_ops, n_ops, s_fin, s_vbits[a_index(k)],
                         s_y + tz * n_opbits * wpb + tx, wpb, my);
    ++n_k;
  }
  return n_k;
}

// Joins a tile's k-lanes: transposes each thread's bit slices into 32 lane
// sums, subtracts `off` (n_k times the polarity offset), adds the k-lanes'
// sums in shared memory (the first 32 slots, exact modulo 2**32) and calls
// emit(row, word, lane, sum) for each (row, word) of the tile and lane of
// the word.  Ends with slot 0 zero again, after a barrier.
template <int kThreads, typename Emit>
__device__ __forceinline__ void reduce_tile(uint32_t (&acc)[32], uint32_t off, uint32_t* s_slots,
                                            int wpb, int rpb, Emit emit) {
  const int tid = threadIdx.x;
  transpose32(acc);  // acc[l] = the sum of lane l (mod 2**32)
  __syncthreads();   // every thread is done with its slots
#pragma unroll
  for (int l = 0; l < 32; ++l) s_slots[l * kThreads + tid] = acc[l] - off;
  __syncthreads();
  const int plane = wpb * rpb;  // threads of one k-lane
  const int kpb = kThreads / plane;
  for (int o = tid; o < plane * 32; o += kThreads) {
    const int t = o % plane;
    const int l = o / plane;
    uint32_t sum = 0u;
    for (int z = 0; z < kpb; ++z) sum += s_slots[l * kThreads + z * plane + t];
    emit(t / wpb, t % wpb, l, sum);
  }
  __syncthreads();
  s_slots[tid] = 0u;  // slot 0 is the constant zero word
}

}  // namespace replay
