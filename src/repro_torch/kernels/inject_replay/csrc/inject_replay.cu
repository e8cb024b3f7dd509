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
// The replay itself (the schedule as a program of runs of gate and cell ops
// over reused wire slots, cells by LOP3 immediates, B packed into 32-column
// words with ballots, J items a thread in lockstep, the carry-save
// accumulator and its transpose) is in replay_device.cuh, which the fused
// attention kernel shares.  Here one block of 128 threads takes wpb words x
// rpb rows x kpb k-lanes, rows first (up to 16) so that the block packs B
// once for all its rows, then words; each thread takes J = 3 k values a
// step (J = 1 where a grid of J = 3 would hold fewer blocks than SMs, as at
// the grouped decode shapes, or where J = 3's wire slots would not fit).  K
// is split across blocks up to one wave: the blocks an SM holds
// (inject_replay_blocks_per_sm, the occupancy at the program's shared
// memory) times the SMs.  The k-lanes' and the splits' partial sums meet in
// int32 atomics, exact in any order.
//
// What bounds it on this card: integer and logic operations.  What the
// function needs per 32-pair word: one LOP3 per PP gate (100), two per
// reduction cell (2 x 101) and a full adder per final bit into a carry-save
// accumulator (2 x 32), 366 in all at the paper's schedules, plus one 32x32
// transpose (480) per output word; chip_smoke.py's bound counts these.  The
// kernel spends about 15 instructions an op and item instead (the op's
// record, its decode and slot addresses shared by the J items; per item 3
// wire loads, 2 LOP3s and 2 stores for a cell, a branch-free select for a
// gate), at about one instruction a clock an SM: each op's loads wait on
// the stores of the op before.  J = 3 beat J = 2 by 1.2-1.35x at every
// large shape (same call, J = 2 built from a copy of this source) although
// its shared memory (wire slots 67 x 3 x 128 words and the packed B tile:
// 111 KB a block at M = 2, 104 KB at M = 16, at border 8) leaves two
// blocks, 8 warps, an SM where J = 2 leaves three.  The first version (one item a
// thread, run-time minterm truth tables, a ripple accumulator, ballots in a
// loop bounded at run time) took about 45 instructions an op and item; this
// one is 2.2x (M = 2) to 3.1x (M = 16) faster at the large dense shapes on
// an H100 80GB HBM3 at 700 W (PERF.md, chip_smoke --parent).
#include <cstdint>
#include <cuda_runtime.h>

#include "replay_device.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 3;  // J: k values a thread replays in lockstep (1 for small grids)
constexpr int kMaxSmem = 232448;  // shared memory a block may take on Hopper (227 KB)
using replay::kPos;

struct Params {
  const int32_t* ia;         // (G, M, K) operand indices
  const int32_t* ib;         // (G, K, N), or (K, N) with ib_group_stride 0
  int32_t* out;              // (G, M, N), zero-filled by the caller
  const uint32_t* program;   // (n_ops, 2) records: runs of ops
  const uint32_t* fin;       // (kPos, 2) slots of the final bits by position
  const uint32_t* value_bits;  // (256,) stored bits of each operand index
  long long ib_group_stride;
  int n_ops, n_opbits, n_slots, offset;
  int G, M, N, K, k_chunk, splits, wpb, rpb;
};

template <int J>
__global__ void __launch_bounds__(kThreads) inject_replay_kernel(const Params p) {
  extern __shared__ uint2 smem2[];
  const int kpb = kThreads / (p.wpb * p.rpb);
  uint2* s_ops = smem2;                                            // [record] 8 bytes each
  uint32_t* s_slots = reinterpret_cast<uint32_t*>(s_ops + p.n_ops);  // [slot][item][thread]
  uint32_t* s_y = s_slots + p.n_slots * J * kThreads;         // [k][bit][word]
  uint32_t* s_vbits = s_y + J * kpb * p.n_opbits * p.wpb;
  uint32_t* s_fin = s_vbits + 256;

  const int tid = threadIdx.x;
  replay::load_program<kThreads>(s_ops, s_vbits, s_fin, p.program, p.n_ops, p.value_bits, p.fin);
#pragma unroll
  for (int j = 0; j < J; ++j) s_slots[j * kThreads + tid] = 0u;  // slot 0: the zero word

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
  const uint32_t n_k = replay::replay_tile<kThreads, J>(
      acc, s_ops, p.n_ops, s_vbits, p.n_opbits, s_fin, s_slots, s_y, p.wpb, p.rpb, word0, p.N,
      active, k_begin, k_end, [&](int k) { return a_row[k] & 255; },
      [&](int k, int col) { return b_g[size_t(k) * p.N + col] & 255; });
  replay::reduce_tile<kThreads, J>(
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

size_t smem_bytes(int items, int n_ops, int n_slots, int n_opbits, int wpb, int rpb) {
  const int kpb = kThreads / (wpb * rpb);
  return sizeof(uint32_t) * (2 * size_t(n_ops) + size_t(n_slots) * items * kThreads +
                             size_t(items) * kpb * n_opbits * wpb + 256 + 2 * kPos);
}

// Once per device: a block of J items a thread may take up to 227 KB of
// shared memory.
template <int J>
cudaError_t configure() {
  static uint64_t configured = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!((configured >> device) & 1u)) {
    err = cudaFuncSetAttribute(inject_replay_kernel<J>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    configured |= uint64_t(1) << device;
  }
  return cudaSuccess;
}

template <int J>
int launch(const Params& p, dim3 grid, cudaStream_t stream) {
  cudaError_t err = configure<J>();
  if (err != cudaSuccess) return int(err);
  const size_t smem = smem_bytes(J, p.n_ops, p.n_slots, p.n_opbits, p.wpb, p.rpb);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidConfiguration);
  inject_replay_kernel<J><<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <int J>
int blocks_per_sm(size_t smem, int* blocks) {
  *blocks = 0;
  if (smem > size_t(kMaxSmem)) return 0;
  const cudaError_t err = configure<J>();
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, inject_replay_kernel<J>,
                                                           kThreads, smem));
}

}  // namespace

extern "C" {

// ia (G, M, K) int32 indices, ib (G, K, N) int32 indices (ib_group_stride
// K * N) or one shared (K, N) (stride 0), out (G, M, N) int32 zero-filled.
// The program tables come from replay_program (program: n_ops records of 2
// words, run headers included); wpb (a power of two) * rpb must divide 128;
// items is 1 or kItems, the k values a thread replays at once.
// Returns a cudaError_t (0 on success).
int inject_replay_matmul(const int32_t* ia, const int32_t* ib, long long ib_group_stride,
                         int32_t* out, const uint32_t* program, int n_ops,
                         const uint32_t* fin, const uint32_t* value_bits, int n_opbits,
                         int n_slots, int offset, int G, int M, int N, int K, int k_chunk,
                         int wpb, int rpb, int items, void* stream) {
  if (G < 1 || M < 1 || N < 1 || K < 1 || k_chunk < 1 || n_ops < 1 || n_opbits < 1 ||
      n_opbits > replay::kMaxOpBits || n_slots < 32 || n_slots > 256 || wpb < 1 || rpb < 1 ||
      (wpb & (wpb - 1)) != 0 || kThreads % (wpb * rpb) != 0 || (items != 1 && items != kItems)) {
    return int(cudaErrorInvalidValue);
  }
  const int splits = (K + k_chunk - 1) / k_chunk;
  const long long z = (long long)G * splits;
  const int n_words = (N + 31) / 32;
  const int grid_y = (M + rpb - 1) / rpb;
  if (z > 65535 || grid_y > 65535) return int(cudaErrorInvalidConfiguration);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return items == 1 ? launch<1>(p, grid, s) : launch<kItems>(p, grid, s);
}

// Into *blocks: the blocks of the kernel with `items` (1 or kItems) k values
// a thread that one SM of the current device holds at once, for a program
// of n_ops records and n_slots slots and a block of wpb words x rpb rows
// (0 where one block's shared memory exceeds the limit).  Returns a
// cudaError_t (0 on success).
int inject_replay_blocks_per_sm(int items, int n_ops, int n_slots, int n_opbits, int wpb,
                                int rpb, int* blocks) {
  if (blocks == nullptr || n_ops < 1 || n_opbits < 1 || n_opbits > replay::kMaxOpBits ||
      n_slots < 32 || n_slots > 256 || wpb < 1 || rpb < 1 || (wpb & (wpb - 1)) != 0 ||
      kThreads % (wpb * rpb) != 0 || (items != 1 && items != kItems)) {
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(items, n_ops, n_slots, n_opbits, wpb, rpb);
  return items == 1 ? blocks_per_sm<1>(smem, blocks) : blocks_per_sm<kItems>(smem, blocks);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
