// Full-table AMR-MUL gather matmul for Hopper (sm_90a), plain C interface.
//
//   out[g, m, n] = sum_k LUT[a[g, m, k] + 128, b[g, k, n] + 128]      (int32)
//
// Replaces the JAX package's Pallas kernels
//   src/repro/kernels/amr_matmul/kernel.py  _amr_matmul_lut_kernel          (flat)
//   src/repro/kernels/amr_matmul/kernel.py  _amr_matmul_lut_grouped_kernel  (grouped)
// which keep the whole 256 KB int32 table in TPU VMEM.
//
// What bounds it on this card: one table gather and one int32 add per
// product; the operands are int8 and read once.  On the decode shapes
// (M of 2..16) the int8 weight operand dominates the bytes, on the larger
// shapes the gathers dominate.  The table is gathered from global memory
// through the read-only path, where it stays resident in L1/L2: as int16
// (128 KB) when every product fits (border <= 13; the caller guarantees it
// by passing an int16 table), as int32 (256 KB, more than the 227 KB of
// shared memory a block may use) otherwise.  A first version that staged
// the int16 table into shared memory ran at one block per SM and was 1.2x
// to 2.7x slower than the int32 L1 path on the same shapes (H100 SXM, 700 W).
// One thread owns one output column and up to kRows output rows, so the
// gathers of a warp hit one 256-entry table row (row = the broadcast A
// value).  K is split across blocks to fill the SMs at small M; partial
// sums meet in int32 atomics, which are exact in any order, so the result
// is bitwise independent of the split.  Ragged edges in M, N and K are
// masked here: decode shapes are tiny and not multiples of anything.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one output column per thread
constexpr int kRows = 16;      // output rows per block
constexpr int kKTile = 64;     // A columns staged in shared memory per step

template <typename T>
__device__ __forceinline__ void lut_block(const int8_t* __restrict__ a,
                                          const int8_t* __restrict__ b,
                                          const T* __restrict__ table,
                                          int32_t* __restrict__ out,
                                          int M, int N, int K, int k_chunk, int split) {
  __shared__ int8_t s_a[kRows][kKTile];
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, M - m0);
  const int k_begin = split * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  int32_t acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0;

  for (int kt = k_begin; kt < k_end; kt += kKTile) {
    const int kw = min(kKTile, k_end - kt);
    __syncthreads();  // the previous A tile is consumed
    for (int i = threadIdx.x; i < kRows * kKTile; i += kThreads) {
      const int r = i / kKTile;
      const int c = i % kKTile;
      s_a[r][c] = (r < rows && c < kw) ? a[size_t(m0 + r) * K + kt + c] : int8_t(0);
    }
    __syncthreads();
    if (n < N) {
#pragma unroll 4
      for (int c = 0; c < kw; ++c) {
        const int col = int(b[size_t(kt + c) * N + n]) + 128;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < rows) {
            acc[r] += int32_t(__ldg(table + (int(s_a[r][c]) + 128) * 256 + col));
          }
        }
      }
    }
  }
  if (n < N) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) atomicAdd(out + size_t(m0 + r) * N + n, acc[r]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
amr_lut_matmul_kernel(const int8_t* a, const int8_t* b, const T* table, int32_t* out,
                      int M, int N, int K, int k_chunk) {
  lut_block<T>(a, b, table, out, M, N, K, k_chunk, blockIdx.z);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
amr_lut_matmul_grouped_kernel(const int8_t* a, const int8_t* b, const T* table, int32_t* out,
                              int M, int N, int K, int k_chunk, int splits) {
  const int g = blockIdx.z / splits;
  lut_block<T>(a + size_t(g) * M * K, b + size_t(g) * K * N, table,
               out + size_t(g) * M * N, M, N, K, k_chunk, blockIdx.z % splits);
}

template <typename T>
void launch_typed(bool grouped, dim3 grid, const int8_t* a, const int8_t* b, const T* table,
                  int32_t* out, int M, int N, int K, int k_chunk, int splits,
                  cudaStream_t stream) {
  if (grouped) {
    amr_lut_matmul_grouped_kernel<T>
        <<<grid, kThreads, 0, stream>>>(a, b, table, out, M, N, K, k_chunk, splits);
  } else {
    amr_lut_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(a, b, table, out, M, N, K, k_chunk);
  }
}

int launch(bool grouped, const int8_t* a, const int8_t* b, const void* table, int table_int16,
           int32_t* out, int G, int M, int N, int K, int k_chunk, cudaStream_t stream) {
  if (G < 1 || M < 1 || N < 1 || K < 1 || k_chunk < 1) return int(cudaErrorInvalidValue);
  const int splits = (K + k_chunk - 1) / k_chunk;
  const long long z = (long long)G * splits;
  if (z > 65535 || (M + kRows - 1) / kRows > 65535) return int(cudaErrorInvalidConfiguration);
  const dim3 grid((N + kThreads - 1) / kThreads, (M + kRows - 1) / kRows, unsigned(z));
  if (table_int16) {
    launch_typed(grouped, grid, a, b, static_cast<const int16_t*>(table), out, M, N, K, k_chunk,
                 splits, stream);
  } else {
    launch_typed(grouped, grid, a, b, static_cast<const int32_t*>(table), out, M, N, K, k_chunk,
                 splits, stream);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// a (M, K) int8, b (K, N) int8, table (256, 256) int16 or int32, out (M, N)
// int32 zero-filled by the caller.  Returns a cudaError_t (0 on success).
int amr_lut_matmul(const int8_t* a, const int8_t* b, const void* table, int table_int16,
                   int32_t* out, int M, int N, int K, int k_chunk, void* stream) {
  return launch(false, a, b, table, table_int16, out, 1, M, N, K, k_chunk,
                static_cast<cudaStream_t>(stream));
}

// a (G, M, K) int8, b (G, K, N) int8, out (G, M, N) int32 zero-filled.
int amr_lut_matmul_grouped(const int8_t* a, const int8_t* b, const void* table,
                           int table_int16, int32_t* out, int G, int M, int N, int K,
                           int k_chunk, void* stream) {
  return launch(true, a, b, table, table_int16, out, G, M, N, K, k_chunk,
                static_cast<cudaStream_t>(stream));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
