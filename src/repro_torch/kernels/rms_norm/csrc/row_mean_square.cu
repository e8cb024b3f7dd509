// The mean square of each row, for RMSNorm, on Hopper (sm_90a); plain C
// interface.
//
// No Pallas kernel corresponds: the JAX package computes the norm's
// jnp.mean(x * x, axis=-1) (src/repro/models/layers.py, rms_norm) and XLA
// fuses it.  The port has it as a kernel of its own so that a row's sum
// does not depend on how many rows come with it: PyTorch's CUDA reduction
// chooses how many threads share a row from the number of rows, so a
// request's row summed in another order in a batch of 8 rows than alone in
// 4, and a served request's logits differed batched and alone.  Here the
// order of a row's additions is a function of the row's length alone.
//
// Layout: x (rows, d) float32, contiguous; out (rows,) float32.  Where d %
// 4 == 0 the base must be 16-byte aligned (the wrapper copies a view that is
// not), and each lane reads float4s.
//
// Design.  One warp a row, eight rows a block.  Lane l adds the squares of
// its elements in ascending order into one float64 (float4 j = l, l + 32,
// ..., each x y z w in turn; d % 4 != 0: element j = l, l + 32, ...), then
// the warp adds its 32 partials in a fixed xor tree (16, 8, 4, 2, 1), and
// lane 0 writes float(sum * (1 / d)), as PyTorch's mean scales its sum.
// A float32 square is exact in float64 and the float64 sum is within d
// 2^-53 of the exact sum, so the result is the plain version's (ref.py,
// a float64 mean rounded to float32) but where the two sums straddle a
// float32 rounding boundary: the card's norm and the CPU's agree, and a
// rounding tie of an int8 index downstream falls the same way on both.
//
// What bounds it: reading x once (4 d bytes a row) at the card's memory
// rate; a float64 multiply-add a float.  At a decode step's few rows the
// launch itself dominates.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // rows a block

__global__ void __launch_bounds__(kWarps * 32)
row_mean_square_kernel(const float* __restrict__ x, float* __restrict__ out, long long rows,
                       int d) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + row * d;
  double acc = 0.0;
  if ((d & 3) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int j = lane; j < d / 4; j += 32) {
      const float4 v = __ldg(x4 + j);
      acc = fma(double(v.x), double(v.x), acc);
      acc = fma(double(v.y), double(v.y), acc);
      acc = fma(double(v.z), double(v.z), acc);
      acc = fma(double(v.w), double(v.w), acc);
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      const double v = __ldg(xr + j);
      acc = fma(v, v, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = float(acc * (1.0 / double(d)));
}

}  // namespace

extern "C" {

// x (rows, d) float32 contiguous, 16-byte aligned where d % 4 == 0; out
// (rows,) float32.  Returns a cudaError_t (0 on success).
int row_mean_square(const float* x, float* out, long long rows, int d, void* stream) {
  if (rows < 1 || d < 1 || x == nullptr || out == nullptr ||
      ((d & 3) == 0 && reinterpret_cast<uintptr_t>(x) % 16))
    return int(cudaErrorInvalidValue);
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return int(cudaErrorInvalidConfiguration);
  row_mean_square_kernel<<<unsigned(blocks), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, rows, d);
  return int(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
