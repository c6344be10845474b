// RMSNorm for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` of
// src/repro/kernels/rmsnorm/kernel.py (via `rmsnorm_pallas`).  Per row:
//   y = x * rsqrt(mean(x^2) + eps) * (1 + w)
// in fp32, cast back to x's type.  Weights are fp32 in offset form.
//
// Bound: bytes.  Each row is read once and written once (2 + 2 bytes an
// element in bf16), plus the weight vector; arithmetic is ~4 flops an
// element, far below the card's ~295 flop/byte ridge.  What costs time at
// the main path's shapes is latency: a fused chunk's norm moves 2-10 MB,
// a decode step's 8-64 rows a few KB, against a launch of a few us.
//
// Two kernels:
//
// rmsnorm_rows_kernel<T, LANES, PACKS>: the widths the models use.  A row
// group of LANES threads (a half warp, one warp, or 2-8 warps) holds one
// row in registers, PACKS 16-byte packs a lane (8 bf16 or 4 fp32
// elements), so d = LANES * PACKS * 16 / sizeof(T) is fixed at compile
// time.  A lane issues all its loads before the first use, reduces the
// sum of squares with shuffles inside its group (plus one shared-memory
// exchange where the group spans warps) and writes 16-byte stores: each
// row is read from device memory once.  A block holds `groups` row groups
// and walks rows with a block-uniform grid-stride loop; each lane loads
// its packs' weights once, into registers, for every row it normalises,
// issued with the first row's loads and not waited on before its output,
// so both share one round trip (the block's groups read the same lines
// through L1).  One copy of 1 + w a block in shared memory, by plain loads
// or by cp.async, measured slower at every decode shape and most chunk
// shapes: it puts a barrier between the weights and the first row's
// output.  The wrapper sizes the grid
// (kernels/rmsnorm.py, `launch_shape`): one row a block while the rows fit
// on the SMs one each (a decode step), else up to 256 threads of groups a
// block, the grid capped at the SMs' resident blocks with the rows spread
// evenly over the loop.
//
// rmsnorm_kernel<T, VEC>: every other width, or a misaligned pointer.
// One block a row; threads stride the row with 16-byte loads (element
// loads where the row is not a whole number of 16-byte pieces), reduce
// through shared memory, then read the row again to scale it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

// ------------------------------------------------------------- rows kernel
constexpr int kRowsMaxThreads = 256;

// a 16-byte pack of x: 8 bf16 or 4 fp32 elements
template <typename T>
struct alignas(16) Pack { T e[16 / sizeof(T)]; };

template <typename T, int LANES, int PACKS>
__global__ void __launch_bounds__(kRowsMaxThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                    int rows, int groups, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int D = LANES * PACKS * VEC;
  constexpr int WARPS = LANES > 32 ? LANES / 32 : 1;          // warps a row group
  static_assert(LANES == 16 || LANES % 32 == 0, "a row group is a half warp or whole warps");
  static_assert(LANES <= kRowsMaxThreads, "a row group fits in a block");
  __shared__ float s_part[2][kRowsMaxThreads / 32];           // per-warp sums, by parity

  const int tid = threadIdx.x;
  const int g = tid / LANES;
  const int lane = tid % LANES;
  // this lane's weights, once for every row it normalises: 16-byte loads,
  // all issued before the first row's and none waited on before its
  // output (1 + w is taken there), so they share the first row's round trip
  float4 wr[PACKS][VEC / 4];
#pragma unroll
  for (int p = 0; p < PACKS; ++p) {
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j)
      wr[p][j] = __ldg(reinterpret_cast<const float4*>(w) + (p * LANES + lane) * (VEC / 4) + j);
  }

  // block-uniform trip count: every thread reaches every shuffle and barrier,
  // a group past the last row (or past `groups`) only skips its loads and stores
  const long long stride = static_cast<long long>(gridDim.x) * groups;
  int parity = 0;
  for (long long base = static_cast<long long>(blockIdx.x) * groups; base < rows; base += stride) {
    const long long row = base + g;
    const bool valid = g < groups && row < rows;
    const Pack<T>* xr = reinterpret_cast<const Pack<T>*>(x + row * D) + lane;
    Pack<T> v[PACKS];
    float ss = 0.f;
    if (valid) {
#pragma unroll
      for (int p = 0; p < PACKS; ++p) v[p] = xr[p * LANES];
#pragma unroll
      for (int p = 0; p < PACKS; ++p) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float f = to_f32(v[p].e[j]);
          ss += f * f;
        }
      }
    }
#pragma unroll
    for (int off = (LANES < 32 ? LANES : 32) / 2; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if constexpr (WARPS > 1) {
      // one exchange of the group's per-warp sums; the parity buffer lets
      // the next row's writes go ahead of a slow warp's reads
      const int warp = tid >> 5;
      if ((tid & 31) == 0) s_part[parity][warp] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) ss += s_part[parity][g * WARPS + k];
      parity ^= 1;
    }
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    if (valid) {
      Pack<T>* outr = reinterpret_cast<Pack<T>*>(out + row * D) + lane;
#pragma unroll
      for (int p = 0; p < PACKS; ++p) {
        Pack<T> o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float4 w4 = wr[p][j / 4];
          const float wj = j % 4 == 0 ? w4.x : j % 4 == 1 ? w4.y : j % 4 == 2 ? w4.z : w4.w;
          const float y = to_f32(v[p].e[j]) * r;
          from_f32(y * (1.0f + wj), &o.e[j]);
        }
        outr[p * LANES] = o;
      }
    }
  }
}

template <typename T, int LANES, int PACKS>
int launch_rows(const void* x, const float* w, void* out, int rows, int d, float eps,
                int groups, int grid, cudaStream_t stream) {
  constexpr int D = LANES * PACKS * (16 / sizeof(T));
  const int threads = ((groups * LANES + 31) / 32) * 32;
  if (d != D || groups <= 0 || grid <= 0 || threads > kRowsMaxThreads ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_rows_kernel<T, LANES, PACKS><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), rows, groups, eps);
  return static_cast<int>(cudaGetLastError());
}

// The instances: (type, dtype code, LANES, PACKS), one for each norm width
// of the port's configs (d_model, the per-head q/k norm's head_dim, a Mamba
// layer's d_inner).  bf16: a half warp at d 128, one warp of up to 10
// packs (160 bytes of x) a lane up to 2560, and beyond that 2-6 warps of 3-7
// packs (at 3072, 4608 and 5120, 4-6 warps of 3-5 packs measured 8-15%
// faster at 512 rows than 2 warps of 6-10, and no slower at 8).  fp32 takes
// twice the bf16 instance's lanes, or its packs where twice the lanes would
// pass 256 threads (4608).  kernels/rmsnorm.py's ROWS_INSTANCES is the
// same table by width, and tests/test_torch_kernels.py holds the two equal.
#define RMSNORM_ROWS_INSTANCES(X)                                          \
  X(__nv_bfloat16, 1, 16, 1)   /* d 128  */                                \
  X(__nv_bfloat16, 1, 32, 3)   /* d 768  */                                \
  X(__nv_bfloat16, 1, 32, 4)   /* d 1024 */                                \
  X(__nv_bfloat16, 1, 32, 6)   /* d 1536 */                                \
  X(__nv_bfloat16, 1, 32, 8)   /* d 2048 */                                \
  X(__nv_bfloat16, 1, 32, 10)  /* d 2560 */                                \
  X(__nv_bfloat16, 1, 128, 3)  /* d 3072 */                                \
  X(__nv_bfloat16, 1, 64, 7)   /* d 3584 */                                \
  X(__nv_bfloat16, 1, 192, 3)  /* d 4608 */                                \
  X(__nv_bfloat16, 1, 128, 5)  /* d 5120 */                                \
  X(__nv_bfloat16, 1, 128, 7)  /* d 7168 */                                \
  X(float, 0, 32, 1)           /* d 128  */                                \
  X(float, 0, 64, 3)           /* d 768  */                                \
  X(float, 0, 64, 4)           /* d 1024 */                                \
  X(float, 0, 64, 6)           /* d 1536 */                                \
  X(float, 0, 64, 8)           /* d 2048 */                                \
  X(float, 0, 64, 10)          /* d 2560 */                                \
  X(float, 0, 256, 3)          /* d 3072 */                                \
  X(float, 0, 128, 7)          /* d 3584 */                                \
  X(float, 0, 192, 6)          /* d 4608 */                                \
  X(float, 0, 256, 5)          /* d 5120 */                                \
  X(float, 0, 256, 7)          /* d 7168 */

// ---------------------------------------------------------- generic kernel
// reduce one float across the block; every thread gets the sum
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[32];
  __shared__ float total;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    float t = lane < n_warps ? partial[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) total = t;
  }
  __syncthreads();
  return total;
}

// VEC elements per load: 16 / sizeof(T) for 16-byte loads, or 1
template <typename T, int VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                               T* __restrict__ out, int d, float eps) {
  struct alignas(sizeof(T) * VEC) Vec { T e[VEC]; };
  const long long row = blockIdx.x;
  const Vec* xr = reinterpret_cast<const Vec*>(x + row * d);
  Vec* outr = reinterpret_cast<Vec*>(out + row * d);
  const int n = d / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Vec p = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v = to_f32(p.e[j]);
      ss += v * v;
    }
  }
  const float r = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Vec p = xr[i];
    Vec o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float y = to_f32(p.e[j]) * r;
      from_f32(y * (1.0f + w[i * VEC + j]), &o.e[j]);
    }
    outr[i] = o;
  }
}

template <typename T>
int launch_generic(const void* x, const float* w, void* out, int rows, int d, float eps,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = d % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int n = vec ? d / VEC : d;
  const int threads = n >= 256 ? 256 : ((n + 31) / 32) * 32;
  if (vec)
    rmsnorm_kernel<T, VEC><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(out), d, eps);
  else
    rmsnorm_kernel<T, 1><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lanes = 0 runs the generic kernel;
// otherwise (lanes, packs) names a rows-kernel instance, launched as `grid`
// blocks of `groups` row groups.  Returns a cudaError_t (0 = success); an
// unknown dtype or instance, an empty shape, or an instance that does not
// match d, the pointers' alignment or the block limit returns
// cudaErrorInvalidValue.
extern "C" int rmsnorm_fwd(const void* x, const float* w, void* out, int rows, int d,
                           int dtype, float eps, int lanes, int packs, int groups, int grid,
                           void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes == 0) {
    if (dtype == 0) return launch_generic<float>(x, w, out, rows, d, eps, s);
    if (dtype == 1) return launch_generic<__nv_bfloat16>(x, w, out, rows, d, eps, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define RMSNORM_DISPATCH(T, DT, L, P)                                             \
  if (dtype == DT && lanes == L && packs == P)                                     \
    return launch_rows<T, L, P>(x, w, out, rows, d, eps, groups, grid, s);
  RMSNORM_ROWS_INSTANCES(RMSNORM_DISPATCH)
#undef RMSNORM_DISPATCH
  return static_cast<int>(cudaErrorInvalidValue);
}
