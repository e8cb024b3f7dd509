// Low-rank AMR-MUL matmul for Hopper (sm_90a), plain C interface.
//
//   out[m, n] = sum_k ( a[m,k] * b[k,n] + sum_j U[a[m,k]+128, j] * V[b[k,n]+128, j] )
//
// with int8 a (M, K), b (K, N) and float32 error factors U, V (256, R).
// Replaces the JAX package's Pallas kernel
//   src/repro/kernels/amr_matmul/kernel.py  _amr_matmul_kernel
// which runs one augmented-K dot per block on the TPU's matrix unit.
//
// What bounds it on this card: (1 + R) multiply-adds per product, done as
// an int32 multiply-add for the exact lane and R float32 FMAs for the
// error lanes (no tensor cores: TF32 would round the error factors).  At
// the decode shapes the int8 weight operand's bytes bound it instead.
// The factors (256 x R floats each) sit in shared memory; a warp's U row
// is a broadcast (one A value per row), its V rows are gathered per column
// and held in registers across the block's rows.
//
// Summation order: K is cut into fixed chunks of kChunk, and inside a
// chunk each output sums k in ascending order (the exact lane in int32,
// exact; the error lanes by FMA in float32).  Chunk partials are added in
// chunk order by a second kernel.  The order depends on K alone, never on
// M or on the grid, so a row's result is the same whatever other rows are
// batched with it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one output column per thread
constexpr int kRows = 16;      // output rows per block
constexpr int kKTile = 64;     // A columns staged in shared memory per step
constexpr int kChunk = 512;    // fixed K chunk (|exact lane partial| < 2**23)

template <int R>
__global__ void __launch_bounds__(kThreads)
amr_lowrank_partial_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                           const float* __restrict__ u, const float* __restrict__ v,
                           float* __restrict__ partial, int M, int N, int K) {
  __shared__ float s_u[256 * R];
  __shared__ float s_v[256 * R];
  __shared__ int8_t s_a[kRows][kKTile];
  for (int i = threadIdx.x; i < 256 * R; i += kThreads) {
    s_u[i] = u[i];
    s_v[i] = v[i];
  }
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, M - m0);
  const int chunk = blockIdx.z;
  const int k_begin = chunk * kChunk;
  const int k_end = min(K, k_begin + kChunk);

  int32_t acc_i[kRows];
  float acc_e[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    acc_i[r] = 0;
    acc_e[r] = 0.0f;
  }

  for (int kt = k_begin; kt < k_end; kt += kKTile) {
    const int kw = min(kKTile, k_end - kt);
    __syncthreads();  // the previous A tile (and the factor copy) is complete
    for (int i = threadIdx.x; i < kRows * kKTile; i += kThreads) {
      const int r = i / kKTile;
      const int c = i % kKTile;
      s_a[r][c] = (r < rows && c < kw) ? a[size_t(m0 + r) * K + kt + c] : int8_t(0);
    }
    __syncthreads();
    if (n < N) {
      for (int c = 0; c < kw; ++c) {
        const int bv = int(b[size_t(kt + c) * N + n]);
        const float* vrow = s_v + (bv + 128) * R;
        float vb[R];
#pragma unroll
        for (int j = 0; j < R; ++j) vb[j] = vrow[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < rows) {
            const int av = int(s_a[r][c]);
            const float* urow = s_u + (av + 128) * R;
            acc_i[r] += av * bv;
            float e = acc_e[r];
#pragma unroll
            for (int j = 0; j < R; ++j) e = fmaf(urow[j], vb[j], e);
            acc_e[r] = e;
          }
        }
      }
    }
  }
  if (n < N) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        partial[(size_t(chunk) * M + m0 + r) * N + n] = float(acc_i[r]) + acc_e[r];
      }
    }
  }
}

__global__ void amr_lowrank_reduce_kernel(const float* __restrict__ partial,
                                          float* __restrict__ out, long long mn, int chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = partial[i];
  for (int c = 1; c < chunks; ++c) s += partial[c * mn + i];
  out[i] = s;
}

template <int R>
int launch_partial(const int8_t* a, const int8_t* b, const float* u, const float* v,
                   float* partial, int M, int N, int K, int chunks, cudaStream_t stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, (M + kRows - 1) / kRows, chunks);
  amr_lowrank_partial_kernel<R><<<grid, kThreads, 0, stream>>>(a, b, u, v, partial, M, N, K);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// a (M, K) int8, b (K, N) int8, u/v (256, R) float32, out (M, N) float32,
// partial a float32 scratch of partial_chunks x M x N, where the kernel
// needs ceil(K / 512) chunks (no scratch is read when that is 1).  R is
// one of 1, 2, 4, 8, 16.  Returns a cudaError_t (0 on success).
int amr_lowrank_matmul(const int8_t* a, const int8_t* b, const float* u, const float* v,
                       float* partial, int partial_chunks, float* out, int M, int N, int K,
                       int R, void* stream) {
  if (M < 1 || N < 1 || K < 1) return int(cudaErrorInvalidValue);
  const int chunks = (K + kChunk - 1) / kChunk;
  if (chunks > 1 && partial_chunks < chunks) return int(cudaErrorInvalidValue);
  if (chunks > 65535 || (M + kRows - 1) / kRows > 65535) {
    return int(cudaErrorInvalidConfiguration);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = chunks == 1 ? out : partial;
  int err;
  switch (R) {
    case 1: err = launch_partial<1>(a, b, u, v, dst, M, N, K, chunks, s); break;
    case 2: err = launch_partial<2>(a, b, u, v, dst, M, N, K, chunks, s); break;
    case 4: err = launch_partial<4>(a, b, u, v, dst, M, N, K, chunks, s); break;
    case 8: err = launch_partial<8>(a, b, u, v, dst, M, N, K, chunks, s); break;
    case 16: err = launch_partial<16>(a, b, u, v, dst, M, N, K, chunks, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  if (err != 0 || chunks == 1) return err;
  const long long mn = (long long)M * N;
  const int threads = 256;
  const long long blocks = (mn + threads - 1) / threads;
  if (blocks > 2147483647LL) return int(cudaErrorInvalidConfiguration);
  amr_lowrank_reduce_kernel<<<unsigned(blocks), threads, 0, s>>>(partial, out, mn, chunks);
  return int(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
