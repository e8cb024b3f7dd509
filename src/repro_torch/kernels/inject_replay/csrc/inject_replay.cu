// Bit-sliced AMR-MUL circuit replay as an integer matmul, for Hopper (sm_90a),
// plain C interface.
//
//   out[g, m, n] = sum_k AMR(ia[g, m, k], ib[g, k, n])                  (int32)
//
// AMR(x, y) is the exact product of the schedule's reduction circuit for the
// int8 operand indices x, y (value + 128).  Replaces the JAX package's Pallas
// kernel src/repro/kernels/inject_replay/kernel.py _replay_block (the
// pallas_call in _inject_replay_jit), which replays the same circuit on
// lane-packed words in VMEM.
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
// Work per thread: one (row, 32-column word) pair over a range of k.  A
// word holds 32 columns of B, one per bit, so every wire of the replay is
// one 32-bit word and every logic op evaluates 32 products.  The A operand
// is the same for the 32 columns: its stored bits become full-word masks.
// The 32 products of a k are summed into a bit-sliced accumulator (word p =
// bit p of all 32 lanes' sums): the two final rows are added by one
// carry-save step and one ripple, about 4 LOP3s per bit position, instead of
// unpacking 32 lanes x 32 final bits per k.  Sums are modulo 2**32, which is
// exact because the caller bounds K * max|product| below 2**31.  At the end
// a 32x32 bit transpose turns the bit slices into the 32 lane sums.
//
// The B words are packed inside the kernel: per k step each warp packs
// (k, word) pairs with one ballot per stored bit (lane = column), into a
// shared tile that every row of the block reads.  Columns past N read index
// 128 (value 0) and are never written out.
//
// Wires live in shared memory, [slot][thread], so a warp's accesses hit 32
// banks; ops, value bits and final slots are read at one address per warp
// (broadcast).  A block is 128 threads = wpb words x rpb rows x kpb k-lanes,
// chosen by the wrapper so that small N (a grouped QK^T has one word) and
// small M still fill the block; K is split across blocks, and the k-lanes'
// and the splits' partial sums meet in int32 atomics, exact in any order.
//
// What bounds it on this card: integer and logic operations.  What the
// function needs per 32-pair word: one LOP3 per PP gate (100), two per
// reduction cell (2 x 101) and a full adder per final bit into a carry-save
// accumulator (2 x 32), 366 in all at the paper's schedules, plus one 32x32
// transpose (480) per output word; chip_smoke.py's bound counts these.  This
// kernel spends more: 4 x 32 accumulator ops per word (a ripple, not a
// carry-save form), shared-memory traffic (about 3 reads and 2 writes per
// cell) and up to 8 minterm LOP3s per run-time truth table.  It runs
// latency-bound: each op waits on the shared-memory write of the op before.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
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

struct Params {
  const int32_t* ia;         // (G, M, K) operand indices
  const int32_t* ib;         // (G, K, N), or (K, N) with ib_group_stride 0
  int32_t* out;              // (G, M, N), zero-filled by the caller
  const uint32_t* program;   // (n_ops, 2) ops
  const uint32_t* fin;       // (kPos, 2) slots of the final bits by position
  const uint32_t* value_bits;  // (256,) stored bits of each operand index
  long long ib_group_stride;
  int n_ops, n_opbits, n_slots, offset;
  int G, M, N, K, k_chunk, splits, wpb, rpb;
};

__global__ void __launch_bounds__(kThreads) inject_replay_kernel(const Params p) {
  extern __shared__ uint32_t smem[];
  const int kpb = kThreads / (p.wpb * p.rpb);
  uint32_t* s_slots = smem;                                   // [slot][thread]
  uint32_t* s_y = s_slots + p.n_slots * kThreads;             // [k-lane][bit][word]
  uint32_t* s_ops = s_y + kpb * p.n_opbits * p.wpb;
  uint32_t* s_vbits = s_ops + 2 * p.n_ops;
  uint32_t* s_fin = s_vbits + 256;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < 2 * p.n_ops; i += kThreads) s_ops[i] = p.program[i];
  for (int i = tid; i < 256; i += kThreads) s_vbits[i] = p.value_bits[i];
  for (int i = tid; i < 2 * kPos; i += kThreads) s_fin[i] = p.fin[i];
  s_slots[tid] = 0u;  // slot 0 is the constant zero word

  const int tx = tid % p.wpb;
  const int ty = (tid / p.wpb) % p.rpb;
  const int tz = tid / (p.wpb * p.rpb);
  const int n_words = (p.N + 31) / 32;
  const int word = blockIdx.x * p.wpb + tx;
  const int row = blockIdx.y * p.rpb + ty;
  const int g = blockIdx.z / p.splits;
  const int k_begin = (blockIdx.z % p.splits) * p.k_chunk;
  const int k_end = min(p.K, k_begin + p.k_chunk);
  const bool active = row < p.M && word < n_words;
  const int32_t* a_row = p.ia + (size_t(g) * p.M + (active ? row : 0)) * p.K;
  const int32_t* b_g = p.ib + size_t(g) * p.ib_group_stride;
  uint32_t* my = s_slots + tid;  // this thread's slot s is my[s * kThreads]

  uint32_t acc[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0u;
  uint32_t n_k = 0;

  for (int kt = k_begin; kt < k_end; kt += kpb) {
    __syncthreads();  // tables loaded / the previous B tile consumed
    for (int pi = warp; pi < kpb * p.wpb; pi += kThreads / 32) {
      const int kk = pi / p.wpb;
      const int ww = pi % p.wpb;
      const int k = kt + kk;
      const int col = (blockIdx.x * p.wpb + ww) * 32 + lane;
      const int idx = (k < k_end && col < p.N) ? (b_g[size_t(k) * p.N + col] & 255) : 128;
      const uint32_t bits = s_vbits[idx];
      uint32_t mine = 0u;
      for (int j = 0; j < p.n_opbits; ++j) {
        const uint32_t w = __ballot_sync(0xFFFFFFFFu, (bits >> j) & 1u);
        if (lane == j) mine = w;
      }
      if (lane < p.n_opbits) s_y[(kk * p.n_opbits + lane) * p.wpb + ww] = mine;
    }
    __syncthreads();
    const int k = kt + tz;
    if (!active || k >= k_end) continue;
    const uint32_t xb = s_vbits[a_row[k] & 255];
    const uint32_t* y = s_y + tz * p.n_opbits * p.wpb + tx;  // stored bit j at y[j * wpb]
    for (int i = 0; i < p.n_ops; ++i) {
      const uint32_t op0 = s_ops[2 * i];
      const uint32_t op1 = s_ops[2 * i + 1];
      const uint32_t f0 = op0 & 0xFFu, f1 = (op0 >> 8) & 0xFFu, f2 = (op0 >> 16) & 0xFFu;
      if ((op0 >> 24) == 0u) {  // PP gate: x bit f0 as a full-word mask, y word f1
        const uint32_t xm = 0u - ((xb >> f0) & 1u);
        const uint32_t yw = y[f1 * p.wpb];
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
    ++n_k;
  }

  transpose32(acc);  // acc[l] = the sum of lane l (mod 2**32)
  const uint32_t off = n_k * uint32_t(p.offset);
  __syncthreads();   // every thread is done with its slots
  uint32_t* red = s_slots;  // [lane][thread]; n_slots >= 32
#pragma unroll
  for (int l = 0; l < 32; ++l) red[l * kThreads + tid] = acc[l] - off;
  __syncthreads();
  const int plane = p.wpb * p.rpb;  // threads of one k-lane
  for (int o = tid; o < plane * 32; o += kThreads) {
    const int t = o % plane;
    const int l = o / plane;
    uint32_t sum = 0u;
    for (int z = 0; z < kpb; ++z) sum += red[l * kThreads + z * plane + t];
    const int orow = blockIdx.y * p.rpb + t / p.wpb;
    const int ocol = (blockIdx.x * p.wpb + t % p.wpb) * 32 + l;
    if (orow < p.M && ocol < p.N) {
      atomicAdd(reinterpret_cast<unsigned int*>(p.out) + (size_t(g) * p.M + orow) * p.N + ocol,
                sum);
    }
  }
}

}  // namespace

extern "C" {

// ia (G, M, K) int32 indices, ib (G, K, N) int32 indices (ib_group_stride
// K * N) or one shared (K, N) (stride 0), out (G, M, N) int32 zero-filled.
// The program tables come from replay_program; wpb * rpb must divide 128.
// Returns a cudaError_t (0 on success).
int inject_replay_matmul(const int32_t* ia, const int32_t* ib, long long ib_group_stride,
                         int32_t* out, const uint32_t* program, int n_ops,
                         const uint32_t* fin, const uint32_t* value_bits, int n_opbits,
                         int n_slots, int offset, int G, int M, int N, int K, int k_chunk,
                         int wpb, int rpb, void* stream) {
  if (G < 1 || M < 1 || N < 1 || K < 1 || k_chunk < 1 || n_ops < 1 || n_opbits < 1 ||
      n_opbits > 32 || n_slots < 32 || n_slots > 256 || wpb < 1 || rpb < 1 ||
      kThreads % (wpb * rpb) != 0) {
    return int(cudaErrorInvalidValue);
  }
  const int splits = (K + k_chunk - 1) / k_chunk;
  const long long z = (long long)G * splits;
  const int n_words = (N + 31) / 32;
  const int kpb = kThreads / (wpb * rpb);
  const int grid_y = (M + rpb - 1) / rpb;
  if (z > 65535 || grid_y > 65535) return int(cudaErrorInvalidConfiguration);
  const size_t smem = sizeof(uint32_t) * (size_t(n_slots) * kThreads +
                                          size_t(kpb) * n_opbits * wpb + 2 * size_t(n_ops) +
                                          256 + 2 * kPos);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        inject_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  Params p;
  p.ia = ia;
  p.ib = ib;
  p.out = out;
  p.program = program;
  p.fin = fin;
  p.value_bits = value_bits;
  p.ib_group_stride = ib_group_stride;
  p.n_ops = n_ops;
  p.n_opbits = n_opbits;
  p.n_slots = n_slots;
  p.offset = offset;
  p.G = G;
  p.M = M;
  p.N = N;
  p.K = K;
  p.k_chunk = k_chunk;
  p.splits = splits;
  p.wpb = wpb;
  p.rpb = rpb;
  const dim3 grid((n_words + wpb - 1) / wpb, grid_y, unsigned(z));
  inject_replay_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
