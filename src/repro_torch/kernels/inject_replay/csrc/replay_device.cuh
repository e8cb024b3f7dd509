// Device code of the bit-sliced AMR-MUL circuit replay, shared by the
// replay matmul (inject_replay.cu) and the fused attention kernel
// (attn_fused/csrc/attn_fused_inject.cu).
//
// The circuit is data, not code: the host lowers a schedule once
// (kernels/inject_replay/kernel.py, replay_program) into
//   * a program of ops, each a PP gate (x bit, y word -> wire) or a reduction
//     cell (3 wires -> sum wire, carry wire), with the gate's or cell's truth
//     tables as bytes in the LOP3 convention (bit a*4 + b*2 + c is f(a, b, c)),
//     grouped into runs: every cell of a run has one (sum, carry) pair;
//   * wire *slots*: a wire's slot is reused once its last reader has run, so
//     a schedule of 302 wires needs about 65 slots;
//   * the slots of the final bits by bit position (at most two per position:
//     the reduction stops at column height 2), and the polarity offset;
//   * the 256 operand values' stored MRSD bits as bitfields.
// So one build serves every schedule, DSE candidates included.
//
// Truth tables as immediates.  REPLAY_CELL_PAIRS0..7 (compiler definitions
// the wrapper derives from core/cells.py: every (sum, carry) pair the cells
// give under each order of their inputs, 16 at the port's cells) list the
// pairs this build compiles as LOP3 immediates, kPairs.  A run's header
// names its pair by index; the switch on it is uniform and taken once a
// run (about 20 runs a program), and the run's loop then spends one LOP3 on
// each of a cell's two functions.  A case of kGeneric (a pair outside the
// list) runs the same loop on the minterm form lut3 of the op's own bytes:
// any schedule still runs.  (One switch a run, not one an op: an indirect
// branch for each of a cell's two tables cost more than the immediates saved.)
// A PP gate is branch-free in any run: with x a full-word mask, f(x, y) =
// x ? f(1, y) : f(0, y), each a select of y by two masks from the byte.
//
// Work per thread: J items, each one (row, 32-column word, k), replayed in
// lockstep: an op is fetched and decoded once for the J items, and J
// independent chains of wire loads, LOP3s and stores are in flight.  A word
// holds 32 columns of B, one per bit, so every wire is one 32-bit word and
// every logic op evaluates 32 products.  The A operand is the same for the
// 32 columns: its stored bits become full-word masks.  The J items of a
// thread share a row and a word and differ in k, so they add into one
// bit-sliced carry-save accumulator: two words per bit position (word p
// holds bit p of all 32 lanes' sums), one carry-save step per final row of
// an item (2 LOP3s a position), resolved by one ripple at the end.  Sums are
// modulo 2**32, which is exact because the callers bound K * max|product|
// below 2**31.  A 32x32 bit transpose then turns the bit slices into lane
// sums.
//
// B words are packed in the block: per k step each warp packs (k, word)
// pairs with one ballot per stored bit (lane = column) into a shared tile
// that every row of the block reads.  Columns past N read index 128 (value
// 0) and are never written out.
//
// Wires live in shared memory, [slot][item][thread], so a warp's accesses
// hit 32 banks and an item's offset is an immediate; ops, value bits and
// final slots are read at one address per warp (broadcast), the next op
// while the current one runs.  A block of kThreads threads is wpb words x
// rpb rows x kpb k-lanes; the k-lanes' partial sums meet in shared memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#if !defined(REPLAY_CELL_PAIRS0) || !defined(REPLAY_CELL_PAIRS7)
#error "REPLAY_CELL_PAIRS0..7 must list the cells' truth-table pairs (inject_replay/kernel.py)"
#endif

namespace replay {

constexpr int kPos = 24;       // final-bit positions read per k (int8 products use 19)
constexpr int kMaxOpBits = 10; // stored bits of an operand (int8 in 2-digit MRSD)
constexpr int kMaxPairs = 32;  // 16-bit entries (sum << 8 | carry), four a definition
constexpr uint64_t kPairWords[kMaxPairs / 4] = {
    REPLAY_CELL_PAIRS0, REPLAY_CELL_PAIRS1, REPLAY_CELL_PAIRS2, REPLAY_CELL_PAIRS3,
    REPLAY_CELL_PAIRS4, REPLAY_CELL_PAIRS5, REPLAY_CELL_PAIRS6, REPLAY_CELL_PAIRS7};

__host__ __device__ constexpr int pair_entry(int i) {
  return int((kPairWords[i / 4] >> (16 * (i % 4))) & 0xFFFFu);
}

// The nonzero entries (no cell has the pair (0, 0)).
__host__ __device__ constexpr int pair_count() {
  int n = 0;
  while (n < kMaxPairs && pair_entry(n) != 0) ++n;
  return n;
}

constexpr int kNumPairs = pair_count();
constexpr uint32_t kGeneric = 0xFFFFu;  // run case of a pair outside kPairs
constexpr uint32_t kHeader = 2u;        // op kind of a run header

template <int TT>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(TT));
  return d;
}

// f(a, b, c) for a truth table known only at run time: the OR of the
// minterms the table selects, each minterm one LOP3.  Only runs whose pair
// is outside kPairs take it.
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

// The two functions of a run's cells: immediates for a pair of kPairs, the
// op's own bytes otherwise.
template <int S, int C>
struct PairImm {
  __device__ __forceinline__ static uint32_t sum(uint32_t, uint32_t a, uint32_t b, uint32_t c) {
    return lop3<S>(a, b, c);
  }
  __device__ __forceinline__ static uint32_t carry(uint32_t, uint32_t a, uint32_t b, uint32_t c) {
    return lop3<C>(a, b, c);
  }
};

struct PairGeneric {
  __device__ __forceinline__ static uint32_t sum(uint32_t op1, uint32_t a, uint32_t b,
                                                 uint32_t c) {
    return lut3((op1 >> 16) & 0xFFu, a, b, c);
  }
  __device__ __forceinline__ static uint32_t carry(uint32_t op1, uint32_t a, uint32_t b,
                                                   uint32_t c) {
    return lut3(op1 >> 24, a, b, c);
  }
};

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

// (s, c) += x in carry-save form: per position q, a full adder of s[q],
// c[q] and x[q] gives the new s[q] and the new c[q + 1] (c[0] becomes 0;
// the carry out of position 31 is dropped, as arithmetic modulo 2**32).
__device__ __forceinline__ void csa_add(uint32_t (&s)[32], uint32_t (&c)[32],
                                        const uint32_t (&x)[32]) {
#pragma unroll
  for (int q = 31; q >= 0; --q) {
    const uint32_t carry = maj(s[q], c[q], x[q]);
    s[q] = xor3(s[q], c[q], x[q]);
    if (q < 31) c[q + 1] = carry;
  }
  c[0] = 0u;
}

// Copies the program's tables to shared memory (no barrier): the records
// (2 words each, s_ops 8-byte aligned), the operands' stored bits and the
// final bits' slots.
template <int kThreads>
__device__ __forceinline__ void load_program(uint2* s_ops, uint32_t* s_vbits, uint32_t* s_fin,
                                             const uint32_t* program, int n_records,
                                             const uint32_t* value_bits, const uint32_t* fin) {
  uint32_t* ops = reinterpret_cast<uint32_t*>(s_ops);
  for (int i = threadIdx.x; i < 2 * n_records; i += kThreads) ops[i] = program[i];
  for (int i = threadIdx.x; i < 256; i += kThreads) s_vbits[i] = value_bits[i];
  for (int i = threadIdx.x; i < 2 * kPos; i += kThreads) s_fin[i] = fin[i];
}

// One run of `count` ops (records ops[0 .. count)) for the J items: cells
// through Pair's two functions, gates branch-free.  `my` is this thread's
// slot 0 of item 0; slot w of item j is my[(w * J + j) * kThreads].
template <int kThreads, int J, typename Pair>
__device__ __forceinline__ void replay_run(const uint2* ops, int count, const uint32_t (&xb)[J],
                                           const uint32_t* y, int y_item, int y_bit,
                                           uint32_t* my) {
  constexpr int kSlot = J * kThreads;  // words between a thread's slots w and w + 1
  uint2 next = ops[0];
  for (int i = 0; i < count; ++i) {
    const uint2 op = next;
    if (i + 1 < count) next = ops[i + 1];
    const uint32_t f0 = op.x & 0xFFu, f1 = (op.x >> 8) & 0xFFu;
    uint32_t* out0 = my + (op.y & 0xFFu) * kSlot;
    if ((op.x >> 24) == 0u) {  // PP gate: f(x, y) = x ? f(1, y) : f(0, y), x bit f0, y word f1
      const uint32_t tt = (op.y >> 16) & 0xFFu;  // bit 4x + 3y is f(x, y)
      const uint32_t y1x0 = 0u - ((tt >> 3) & 1u), y0x0 = 0u - (tt & 1u);
      const uint32_t y1x1 = 0u - ((tt >> 7) & 1u), y0x1 = 0u - ((tt >> 4) & 1u);
      uint32_t yw[J];  // every item's load before any store (they may not alias)
#pragma unroll
      for (int j = 0; j < J; ++j) yw[j] = y[j * y_item + f1 * y_bit];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const uint32_t xm = 0u - ((xb[j] >> f0) & 1u);
        out0[j * kThreads] = lop3<0xCA>(xm, lop3<0xCA>(yw[j], y1x1, y0x1),
                                        lop3<0xCA>(yw[j], y1x0, y0x0));
      }
    } else {  // reduction cell: inputs read before either output is written
      const uint32_t* pa = my + f0 * kSlot;
      const uint32_t* pb = my + f1 * kSlot;
      const uint32_t* pc = my + ((op.x >> 16) & 0xFFu) * kSlot;
      uint32_t* out1 = my + ((op.y >> 8) & 0xFFu) * kSlot;
      uint32_t a[J], b[J], c[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        a[j] = pa[j * kThreads];
        b[j] = pb[j * kThreads];
        c[j] = pc[j * kThreads];
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const uint32_t s = Pair::sum(op.y, a[j], b[j], c[j]);
        const uint32_t cy = Pair::carry(op.y, a[j], b[j], c[j]);
        out0[j * kThreads] = s;
        out1[j * kThreads] = cy;
      }
    }
  }
}

// Replays the circuit for this thread's J items (item j: operand x with
// stored bits xb[j], its 32 columns' stored-bit words at y[j * y_item +
// bit * y_bit]) and adds each valid item's two final rows into the
// carry-save accumulator (s, c).  The program is n_records records of
// runs; `my` as in replay_run.
template <int kThreads, int J>
__device__ __forceinline__ void replay_add(uint32_t (&s)[32], uint32_t (&c)[32],
                                           const uint2* s_ops, int n_records,
                                           const uint32_t* s_fin, const uint32_t (&xb)[J],
                                           const uint32_t* y, int y_item, int y_bit,
                                           const bool (&valid)[J], uint32_t* my) {
  constexpr int kSlot = J * kThreads;
  for (int i = 0; i < n_records;) {
    const uint2 head = s_ops[i];
    const int count = int(head.x & 0xFFFFFFu);
    const uint2* ops = s_ops + i + 1;
#define REPLAY_PAIR_CASE(p)                                                            \
  case p:                                                                              \
    if (p < kNumPairs) {                                                               \
      replay_run<kThreads, J,                                                          \
                 PairImm<(pair_entry(p < kNumPairs ? p : 0) >> 8),                     \
                         (pair_entry(p < kNumPairs ? p : 0) & 0xFF)>>(                 \
          ops, count, xb, y, y_item, y_bit, my);                                       \
      break;                                                                           \
    }                                                                                  \
    replay_run<kThreads, J, PairGeneric>(ops, count, xb, y, y_item, y_bit, my);        \
    break;
    switch (head.y) {
      REPLAY_PAIR_CASE(0) REPLAY_PAIR_CASE(1) REPLAY_PAIR_CASE(2) REPLAY_PAIR_CASE(3)
      REPLAY_PAIR_CASE(4) REPLAY_PAIR_CASE(5) REPLAY_PAIR_CASE(6) REPLAY_PAIR_CASE(7)
      REPLAY_PAIR_CASE(8) REPLAY_PAIR_CASE(9) REPLAY_PAIR_CASE(10) REPLAY_PAIR_CASE(11)
      REPLAY_PAIR_CASE(12) REPLAY_PAIR_CASE(13) REPLAY_PAIR_CASE(14) REPLAY_PAIR_CASE(15)
      REPLAY_PAIR_CASE(16) REPLAY_PAIR_CASE(17) REPLAY_PAIR_CASE(18) REPLAY_PAIR_CASE(19)
      REPLAY_PAIR_CASE(20) REPLAY_PAIR_CASE(21) REPLAY_PAIR_CASE(22) REPLAY_PAIR_CASE(23)
      REPLAY_PAIR_CASE(24) REPLAY_PAIR_CASE(25) REPLAY_PAIR_CASE(26) REPLAY_PAIR_CASE(27)
      REPLAY_PAIR_CASE(28) REPLAY_PAIR_CASE(29) REPLAY_PAIR_CASE(30) REPLAY_PAIR_CASE(31)
      default:
        replay_run<kThreads, J, PairGeneric>(ops, count, xb, y, y_item, y_bit, my);
        break;
    }
#undef REPLAY_PAIR_CASE
    i += 1 + count;
  }
  // each valid item's final rows into the accumulator
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (!valid[j]) continue;
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      uint32_t x[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        x[q] = q < kPos ? my[s_fin[2 * q + row] * kSlot + j * kThreads] : 0u;
      }
      csa_add(s, c, x);
    }
  }
}

// The sums of one tile of wpb words (a power of two) x rpb rows over k in
// [k_begin, k_end), with k spread over the block's kpb = kThreads / (wpb *
// rpb) k-lanes, J k values a thread per step (its A operand indices loaded
// before the step's B packing).  Thread (tx, ty, tz) takes word word0 + tx and
// row ty of the tile when `active`, and k = kt + tz + j kpb for j < J in the
// step from kt.  a_index(k) gives its row's operand index at k; b_index(k,
// col) the B operand index at (k, col), col < n_cols.  `s_slots` holds the
// n_slots x J x kThreads wire slots with slot 0 zero, `s_y` J * kpb *
// n_opbits * wpb words; s_ops (n_records records), s_vbits and s_fin are
// load_program's tables, n_opbits (<= kMaxOpBits) the stored bits of an
// operand.  acc receives this thread's 32
// lane sums, bit-sliced, each with n_k (the return value) times the
// polarity offset not yet subtracted.  Starts with a barrier, so the caller
// may reuse shared memory read by an earlier tile.
template <int kThreads, int J, typename AIndex, typename BIndex>
__device__ __forceinline__ uint32_t replay_tile(uint32_t (&acc)[32], const uint2* s_ops,
                                                int n_records, const uint32_t* s_vbits,
                                                int n_opbits, const uint32_t* s_fin,
                                                uint32_t* s_slots,
                                                uint32_t* s_y, int wpb, int rpb, int word0,
                                                int n_cols, bool active, int k_begin, int k_end,
                                                AIndex a_index, BIndex b_index) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int kpb = kThreads / (wpb * rpb);
  const int tx = tid % wpb;
  const int tz = tid / (wpb * rpb);
  const int step = kpb * J;  // k values of the block per step
  uint32_t* my = s_slots + tid;
  uint32_t s[32], c[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    s[q] = 0u;
    c[q] = 0u;
  }
  uint32_t n_k = 0;
  const int wshift = __ffs(wpb) - 1;  // wpb is a power of two: no division in the packing
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  constexpr int kBatch = 8;  // (k, word) pairs a warp packs with their B loads in flight together
  for (int kt = k_begin; kt < k_end; kt += step) {
    // this thread's A operand indices, loaded before the packing so that it hides them
    int a_idx[J];
    bool valid[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = kt + tz + j * kpb;
      valid[j] = active && k < k_end;
      a_idx[j] = valid[j] ? a_index(k) : 128;
    }
    __syncthreads();  // tables loaded / the previous B tile consumed
    const int n_pairs = step * wpb;
    for (int p0 = warp; p0 < n_pairs; p0 += kBatch * kWarps) {
      int idx[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {  // pair pi is (k = kt + pi / wpb, word pi % wpb)
        const int pi = p0 + u * kWarps;
        const int k = kt + (pi >> wshift);
        const int col = (word0 + (pi & (wpb - 1))) * 32 + lane;
        idx[u] = (pi < n_pairs && k < k_end && col < n_cols) ? b_index(k, col) : 128;
      }
      // branch-free: a ballot for each of kMaxOpBits bits (the bits past n_opbits are 0)
      // and a predicated store; a loop bounded by n_opbits at run time, its branches
      // serialising the ballots, and divisions by wpb made the packing cost as much
      // as the replay
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int pi = p0 + u * kWarps;
        const uint32_t bits = s_vbits[idx[u]];
        uint32_t mine = 0u;
#pragma unroll
        for (int b = 0; b < kMaxOpBits; ++b) {  // one ballot per stored bit, lane = column
          const uint32_t w = __ballot_sync(0xFFFFFFFFu, (bits >> b) & 1u);
          mine = lane == b ? w : mine;
        }
        if (pi < n_pairs && lane < n_opbits) {
          s_y[((pi >> wshift) * n_opbits + lane) * wpb + (pi & (wpb - 1))] = mine;
        }
      }
    }
    __syncthreads();
    if (!valid[0]) continue;  // item 0 has the thread's least k
    uint32_t xb[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      xb[j] = s_vbits[a_idx[j]];
      n_k += valid[j] ? 1u : 0u;
    }
    replay_add<kThreads, J>(s, c, s_ops, n_records, s_fin, xb, s_y + tz * n_opbits * wpb + tx,
                            kpb * n_opbits * wpb, wpb, valid, my);
  }
  // resolve the carry-save pair: one ripple over the 32 positions
  uint32_t carry = 0u;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    acc[q] = xor3(s[q], c[q], carry);
    carry = maj(s[q], c[q], carry);
  }
  return n_k;
}

// Joins a tile's k-lanes: transposes each thread's bit slices into 32 lane
// sums, subtracts `off` (n_k times the polarity offset), adds the k-lanes'
// sums in shared memory (the first 32 kThreads words of the slots, exact
// modulo 2**32) and calls emit(row, word, lane, sum) for each (row, word) of
// the tile and lane of the word.  Ends with slot 0 of every item zero
// again, after a barrier.
template <int kThreads, int J, typename Emit>
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
#pragma unroll
  for (int j = 0; j < J; ++j) s_slots[j * kThreads + tid] = 0u;  // slot 0 is the zero word
}

}  // namespace replay
