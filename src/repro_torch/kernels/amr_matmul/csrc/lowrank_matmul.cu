// Low-rank AMR-MUL matmul for Hopper (sm_90a), plain C interface.
//
//   out[m, n] = sum_k ( a[m,k] * b[k,n] + sum_j U[a[m,k]+128, j] * V[b[k,n]+128, j] )
//
// with int8 a (M, K), b (K, N) and float32 error factors U, V (256, R).
// Replaces the JAX package's Pallas kernel
//   src/repro/kernels/amr_matmul/kernel.py  _amr_matmul_kernel
// which runs one augmented-K dot per block on the TPU's matrix unit.
//
// What bounds it on this card: R float32 FMAs per product (no tensor cores:
// TF32 would round the error factors) at 67 T/s, and at M = 2 the int8
// weight operand's bytes; both are far below what the gathers of the factor
// rows cost.  Per k, a thread gathers the V rows of its 4 columns and the U
// rows of its RT rows from shared memory and does RT x 4 x R FMAs, so at
// small M the V gathers set the pace.  Measured at rank 8 on an H100 80GB
// HBM3 at 700 W (chip_smoke.py): 0.089-0.095 ms at (2, 2048, 16384) and
// (2, 16384, 2048), 5x their 0.018 ms bound; 0.40-0.48 ms at M = 16, 2.8-3.3x
// the 0.144 ms bound: 180 registers a thread leave 8 warps an SM, which
// keep the FMA pipes about a third busy between the gathers (24 16-byte
// shared loads to 256 FMAs a k); 0.014-0.016 ms of device time at N = 256.
// The first version (one column a thread, 512-k chunks, a second launch)
// took 0.35-0.82 ms at these shapes.  The design:
//
// * Grid.  A tile is 4 cgb columns x RT rows (RT 2 for M <= 2, else 8) x one
//   K chunk of kChunk = 256; a block of 16 cgb threads is cgb column groups
//   of 4 columns x kLanes = 16 k-lanes of 16 k each.  The wrapper picks the
//   widest cgb (16, 8, 4 or 2) that gives a tile per SM (kernel.py,
//   lowrank_launch_shape); the blocks, at most as many as fit on the card,
//   loop over the tiles, so the factor tables are filled once per block.
//   On the 8 shapes of the rank-8 gemma-2b path (M, K, N):
//     (2, 2048, 16384)   cgb 16, 256 col tiles x 8 chunks   = 2048 tiles
//     (2, 16384, 2048)   cgb 16,  32 x 64                   = 2048
//     (2, 2048, 2048)    cgb 16,  32 x 8                    =  256
//     (2, 2048, 256)     cgb  2,  32 x 8                    =  256
//     (16, 2048, 16384)  cgb 16, 256 x 2 row tiles x 8      = 4096
//     (16, 16384, 2048)  cgb 16,  32 x 2 x 64               = 4096
//     (16, 2048, 2048)   cgb 16,  32 x 2 x 8                =  512
//     (16, 2048, 256)    cgb  4,  16 x 2 x 8                =  256
// * b ahead of use.  A thread issues the 4-byte loads of its 16 k rows (its
//   4 columns) before it stages A and waits on nothing in between.
// * The exact lane is one __dp4a per (row, column) per 4 k on byte-transposed
//   words: exact int32, so its order is free.
// * V without bank conflicts.  A gather of R floats is R / 4 16-byte loads;
//   a quarter warp (8 lanes) is served together, so the table is kept in 8
//   copies, entry (plane, index, copy) at 16 (8 (256 plane + index) + copy)
//   bytes: lane l reads copy l % 8, banks 4 (l % 8) .. +3, whatever index it
//   gathers (2-byte and 4-byte entries for R = 2, 1 likewise, in 16 and 32
//   copies).  U rows are read at one address per quarter warp (broadcast).
//   Against one copy of plain 16-byte planes, built from a copy of this
//   source and timed in the same chip_smoke --parent call, the copies were
//   1.25x faster at the two large M = 2 shapes and 1.07x at M = 16, and
//   slower at (2, 2048, 2048), where filling 64 KB of copies a block
//   outweighs the gathers.
// * Chunk partials meet in one launch: each tile's partial goes to a
//   scratch, and the last block of a column-and-row tile to finish (an
//   atomic counter, reset by that block for the next call) adds the
//   partials in chunk order into out.
//
// Summation order, fixed by K alone (never by M, N or the grid): in a chunk,
// k-lane l sums k = 256 c + 16 l .. + 15 in ascending order (the exact lane
// in int32, the error lanes by FMA in float32, j ascending); the chunk's
// partial is the left fold over l of float(exact) + error; out is the left
// fold over chunks.  A row's result is the same whatever rows are batched
// with it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 256;                  // K per chunk
constexpr int kLanes = 16;                   // k-lanes per chunk
constexpr int kPerLane = kChunk / kLanes;    // k per k-lane: |exact partial| < 2**24
constexpr int kMaxCgb = 16;                  // column groups per block (threads 16 cgb)

template <int R>
struct VTable {
  static constexpr int W = R < 4 ? R : 4;              // floats per gather load
  static constexpr int P = R / W;                      // loads per row
  static constexpr int C = 32 / W;                     // copies: one per lane served together
  static constexpr int kFloats = P * 256 * C * W;
};

template <int W>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x;
    out[1] = t.y;
    out[2] = t.z;
    out[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void store_vec(float* p, const float* in) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
    *p = in[0];
  }
}

// Byte i of a word whose bytes were flipped (^ 0x80 each): int8 byte i + 128.
__device__ __forceinline__ int byte_index(uint32_t flipped, int i) {
  return int(__byte_perm(flipped, 0u, 0x4440u | uint32_t(i)));
}

struct Params {
  const int8_t* a;
  const int8_t* b;
  const float* u;
  const float* v;
  float* partial;   // (chunks, M, N) when chunks > 1
  int* counters;    // (col_tiles * row_tiles,) zero between calls
  float* out;       // (M, N)
  int M, N, K, chunks, cgb, col_tiles, row_tiles, n_tiles;
  bool vec;         // b rows read as aligned 4-byte words
};

// The 4 bytes of b row k at columns n0 .. n0 + 3 (0 past K or N).
__device__ __forceinline__ uint32_t load_b(const Params& p, int k, int n0) {
  if (k >= p.K || n0 >= p.N) return 0u;
  const int8_t* row = p.b + size_t(k) * p.N;
  if (p.vec) return __ldg(reinterpret_cast<const unsigned int*>(row + n0));
  uint32_t w = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (n0 + c < p.N) w |= uint32_t(uint8_t(__ldg(row + n0 + c))) << (8 * c);
  }
  return w;
}

size_t smem_bytes(int R, int RT, int cgb, int v_floats) {
  return sizeof(float) * (size_t(256) * R + v_floats + size_t(kLanes) * RT * 4 * cgb) +
         size_t(RT) * kChunk;
}

template <int R, int RT>
__global__ void __launch_bounds__(kLanes * kMaxCgb) amr_lowrank_kernel(const Params p) {
  using VT = VTable<R>;
  extern __shared__ float4 smem4[];
  float* s_u = reinterpret_cast<float*>(smem4);       // [256][R]
  float* s_v = s_u + 256 * R;                         // [P][256][C][W]
  const int BN = 4 * p.cgb;                           // columns of a tile
  float* s_comb = s_v + VT::kFloats;                  // [kLanes][RT][BN]
  uint32_t* s_a = reinterpret_cast<uint32_t*>(s_comb + kLanes * RT * BN);  // [RT][kChunk / 4]
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  // the factor tables, W floats a load and a store (consecutive threads on
  // consecutive 16-byte chunks); each V chunk is read once per copy from L1
#pragma unroll 4
  for (int i = tid; i < 256 * R / VT::W; i += nthreads) {
    float t[VT::W];
    load_vec<VT::W>(p.u + i * VT::W, t);
    store_vec<VT::W>(s_u + i * VT::W, t);
  }
#pragma unroll 8
  for (int i = tid; i < VT::P * 256 * VT::C; i += nthreads) {
    const int e = i / VT::C;  // entry (plane, index); i = (plane, index, copy), copy fastest
    float t[VT::W];
    load_vec<VT::W>(p.v + (e % 256) * R + (e / 256) * VT::W, t);
    store_vec<VT::W>(s_v + i * VT::W, t);
  }
  const int cg = tid % p.cgb;
  const int kl = tid / p.cgb;
  const float* s_vl = s_v + ((tid & 31) % VT::C) * VT::W;  // this lane's copy

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int chunk = tile % p.chunks;
    const int rest = tile / p.chunks;
    const int rtile = rest % p.row_tiles;
    const int ctile = rest / p.row_tiles;
    const int m0 = rtile * RT;
    const int k0 = chunk * kChunk;
    const int kb = k0 + kl * kPerLane;   // this k-lane's first k
    const int n0 = ctile * BN + cg * 4;  // this thread's first column

    uint32_t w[kPerLane];  // b rows kb .. kb + 15 at columns n0 .. n0 + 3
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) w[i] = load_b(p, kb + i, n0);

    __syncthreads();  // tables written / the previous tile's A and partials read
    uint8_t* s_a8 = reinterpret_cast<uint8_t*>(s_a);
    for (int i = tid; i < RT * kChunk; i += nthreads) {
      const int r = i / kChunk;
      const int k = k0 + i % kChunk;
      s_a8[i] = (m0 + r < p.M && k < p.K) ? uint8_t(p.a[size_t(m0 + r) * p.K + k]) : uint8_t(0);
    }
    __syncthreads();

    int acc_i[RT][4];
    float acc_e[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc_i[r][c] = 0;
        acc_e[r][c] = 0.0f;
      }
    }
    const int kv = p.K - kb;  // valid k of this lane (all 16 when >= 16)
#pragma unroll
    for (int q = 0; q < kPerLane / 4; ++q) {
      // column c's bytes of rows 4q .. 4q + 3: byte i of bc[c] is b[kb + 4q + i][n0 + c]
      const uint32_t t0 = __byte_perm(w[4 * q], w[4 * q + 1], 0x5140);
      const uint32_t t1 = __byte_perm(w[4 * q], w[4 * q + 1], 0x7362);
      const uint32_t t2 = __byte_perm(w[4 * q + 2], w[4 * q + 3], 0x5140);
      const uint32_t t3 = __byte_perm(w[4 * q + 2], w[4 * q + 3], 0x7362);
      const uint32_t bc[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                              __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
      uint32_t aw[RT], bx[4], ax[RT];  // ax, bx: the bytes flipped, for the table indices
#pragma unroll
      for (int c = 0; c < 4; ++c) bx[c] = bc[c] ^ 0x80808080u;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        aw[r] = s_a[r * (kChunk / 4) + kl * (kPerLane / 4) + q];
        ax[r] = aw[r] ^ 0x80808080u;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc_i[r][c] = __dp4a(int(aw[r]), int(bc[c]), acc_i[r][c]);
      }
#pragma unroll 1
      for (int i = 0; i < 4; ++i) {
        if (4 * q + i >= kv) break;
        float vb[4][R];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* row = s_vl + byte_index(bx[c], i) * (VT::C * VT::W);
#pragma unroll
          for (int pl = 0; pl < VT::P; ++pl) {
            load_vec<VT::W>(row + pl * (256 * VT::C * VT::W), &vb[c][pl * VT::W]);
          }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float ub[R];
          const float* urow = s_u + byte_index(ax[r], i) * R;
#pragma unroll
          for (int j = 0; j < R; j += VT::W) load_vec<VT::W>(urow + j, ub + j);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float e = acc_e[r][c];
#pragma unroll
            for (int j = 0; j < R; ++j) e = fmaf(ub[j], vb[c][j], e);
            acc_e[r][c] = e;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s_comb[(kl * RT + r) * BN + cg * 4 + c] = float(acc_i[r][c]) + acc_e[r][c];
      }
    }
    __syncthreads();
    // the chunk's partial: the k-lanes' partials folded in lane order
    for (int o = tid; o < RT * BN; o += nthreads) {
      const int r = o / BN;
      const int m = m0 + r;
      const int n = ctile * BN + o % BN;
      float s = s_comb[o];
      for (int l = 1; l < kLanes; ++l) s += s_comb[l * RT * BN + o];
      if (m < p.M && n < p.N) {
        if (p.chunks == 1) {
          p.out[size_t(m) * p.N + n] = s;
        } else {
          p.partial[(size_t(chunk) * p.M + m) * p.N + n] = s;
        }
      }
    }
    if (p.chunks == 1) continue;
    // the last block of this column-and-row tile adds the chunks in order
    __threadfence();
    __syncthreads();
    int* counter = p.counters + ctile * p.row_tiles + rtile;
    if (tid == 0) s_last = atomicAdd(counter, 1) == p.chunks - 1;
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
    for (int o = tid; o < RT * BN; o += nthreads) {
      const int m = m0 + o / BN;
      const int n = ctile * BN + o % BN;
      if (m >= p.M || n >= p.N) continue;
      const size_t at = size_t(m) * p.N + n;
      const size_t stride = size_t(p.M) * p.N;
      float s = __ldcg(p.partial + at);
      int c = 1;
      for (; c + 8 <= p.chunks; c += 8) {  // eight loads in flight, added in chunk order
        float t[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) t[u] = __ldcg(p.partial + (c + u) * stride + at);
#pragma unroll
        for (int u = 0; u < 8; ++u) s += t[u];
      }
      for (; c < p.chunks; ++c) s += __ldcg(p.partial + c * stride + at);
      p.out[at] = s;
    }
    if (tid == 0) *counter = 0;
  }
}

template <int R, int RT>
int launch(Params& p, cudaStream_t stream) {
  using VT = VTable<R>;
  // per device: the shared-memory limit set, the SM count, and blocks per SM by cgb
  static uint64_t configured = 0;
  static int sms[64] = {};
  static int per_sm[64][5] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return int(err);
  if (device >= 64) return int(cudaErrorInvalidDevice);
  if (!((configured >> device) & 1u)) {
    err = cudaFuncSetAttribute(amr_lowrank_kernel<R, RT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_bytes(R, RT, kMaxCgb, VT::kFloats)));
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return int(err);
    configured |= uint64_t(1) << device;
  }
  const int threads = kLanes * p.cgb;
  const size_t smem = smem_bytes(R, RT, p.cgb, VT::kFloats);
  int& fit = per_sm[device][__builtin_ctz(p.cgb)];
  if (fit == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, amr_lowrank_kernel<R, RT>,
                                                        threads, smem);
    if (err != cudaSuccess) return int(err);
    if (fit < 1) return int(cudaErrorInvalidConfiguration);
  }
  const long long cap = (long long)fit * sms[device];
  const int grid = int(p.n_tiles < cap ? p.n_tiles : cap);
  amr_lowrank_kernel<R, RT><<<grid, threads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <int RT>
int launch_rank(Params& p, int R, cudaStream_t s) {
  switch (R) {
    case 1: return launch<1, RT>(p, s);
    case 2: return launch<2, RT>(p, s);
    case 4: return launch<4, RT>(p, s);
    case 8: return launch<8, RT>(p, s);
    case 16: return launch<16, RT>(p, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// a (M, K) int8, b (K, N) int8, u/v (256, R) float32 (16-byte aligned),
// out (M, N) float32.  R is one of 1, 2, 4, 8, 16; rt (rows per thread) 2 or 8; cgb (column
// groups of 4 per block) 2, 4, 8 or 16.  When K > 256, partial is a float32
// scratch of ceil(K / 256) x M x N and counters an int32 array of
// ceil(N / (4 cgb)) x ceil(M / rt) zeros, left zero by the kernel; neither
// is read otherwise.  Returns a cudaError_t (0 on success).
int amr_lowrank_matmul(const int8_t* a, const int8_t* b, const float* u, const float* v,
                       float* partial, int* counters, float* out, int M, int N, int K, int R,
                       int rt, int cgb, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (rt != 2 && rt != 8) ||
      (cgb != 2 && cgb != 4 && cgb != 8 && cgb != 16) ||
      reinterpret_cast<uintptr_t>(u) % 16 != 0 || reinterpret_cast<uintptr_t>(v) % 16 != 0) {
    return int(cudaErrorInvalidValue);
  }
  Params p;
  p.a = a;
  p.b = b;
  p.u = u;
  p.v = v;
  p.partial = partial;
  p.counters = counters;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.chunks = (K + kChunk - 1) / kChunk;
  p.cgb = cgb;
  p.col_tiles = (N + 4 * cgb - 1) / (4 * cgb);
  p.row_tiles = (M + rt - 1) / rt;
  const long long tiles = (long long)p.col_tiles * p.row_tiles * p.chunks;
  if (tiles > 2147483647LL) return int(cudaErrorInvalidConfiguration);
  if (p.chunks > 1 && (partial == nullptr || counters == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  p.n_tiles = int(tiles);
  p.vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rt == 2 ? launch_rank<2>(p, R, s) : launch_rank<8>(p, R, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
