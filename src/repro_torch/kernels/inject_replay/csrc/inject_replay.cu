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
// The replay itself (the schedule as a program of gate and cell ops over
// reused wire slots, B packed into 32-column words with ballots, the
// bit-sliced accumulator and its transpose) is in replay_device.cuh, which
// the fused attention kernel shares.  Here one block of 128 threads takes
// wpb words x rpb rows x kpb k-lanes, chosen by the wrapper so that small N
// (a grouped QK^T has one word) and small M still fill the block; K is
// split across blocks, and the k-lanes' and the splits' partial sums meet
// in int32 atomics, exact in any order.
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

#include "replay_device.cuh"

namespace {

constexpr int kThreads = 128;
using replay::kPos;

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
  uint32_t* s_ops = s_y + ((kpb * p.n_opbits * p.wpb + 1) & ~1);  // 8-byte aligned
  uint32_t* s_vbits = s_ops + 2 * p.n_ops;
  uint32_t* s_fin = s_vbits + 256;

  const int tid = threadIdx.x;
  replay::load_program<kThreads>(s_ops, s_vbits, s_fin, p.program, p.n_ops, p.value_bits, p.fin);
  s_slots[tid] = 0u;  // slot 0 is the constant zero word

  const int tx = tid % p.wpb;
  const int ty = (tid / p.wpb) % p.rpb;
  const int n_words = (p.N + 31) / 32;
  const int word0 = blockIdx.x * p.wpb;
  const int row = blockIdx.y * p.rpb + ty;
  const int g = blockIdx.z / p.splits;
  const int k_begin = (blockIdx.z % p.splits) * p.k_chunk;
  const int k_end = min(p.K, k_begin + p.k_chunk);
  const bool active = row < p.M && word0 + tx < n_words;
  const int32_t* a_row = p.ia + (size_t(g) * p.M + (active ? row : 0)) * p.K;
  const int32_t* b_g = p.ib + size_t(g) * p.ib_group_stride;

  uint32_t acc[32];
  const uint32_t n_k = replay::replay_tile<kThreads>(
      acc, s_ops, p.n_ops, s_vbits, p.n_opbits, s_fin, s_slots, s_y, p.wpb, p.rpb, word0, p.N,
      active, k_begin, k_end, [&](int k) { return a_row[k] & 255; },
      [&](int k, int col) { return b_g[size_t(k) * p.N + col] & 255; });
  replay::reduce_tile<kThreads>(
      acc, n_k * uint32_t(p.offset), s_slots, p.wpb, p.rpb,
      [&](int r, int w, int l, uint32_t sum) {
        const int orow = blockIdx.y * p.rpb + r;
        const int ocol = (word0 + w) * 32 + l;
        if (orow < p.M && ocol < p.N) {
          atomicAdd(reinterpret_cast<unsigned int*>(p.out) + (size_t(g) * p.M + orow) * p.N + ocol,
                    sum);
        }
      });
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
                                          size_t(kpb) * n_opbits * wpb + 1 + 2 * size_t(n_ops) +
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
