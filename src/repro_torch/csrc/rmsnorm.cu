// RMSNorm for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` of
// src/repro/kernels/rmsnorm/kernel.py (via `rmsnorm_pallas`).  Per row:
//   y = x * rsqrt(mean(x^2) + eps) * (1 + w)
// in fp32, cast back to x's type.  Weights are fp32 in offset form.
//
// Bound: bytes.  Each row is read once for the sum of squares and once more
// for the scaled write (the second read hits L1/L2: a 2048-wide bf16 row is
// 4 KB), so the kernel moves ~2 bytes per element in, ~2 out, plus the
// weight vector, which every block reads from L2.  Arithmetic is ~4 flops
// per element, far below the card's ~295 flop/byte ridge.
//
// Design: one block per row; threads stride the row with coalesced 16-byte
// loads (8 bf16 or 4 fp32 elements; element loads where the row is not a
// whole number of 16-byte pieces), the fp32 sum of squares is reduced with
// warp shuffles and one shared array of per-warp partials, then every
// thread scales its own elements.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

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
  struct alignas(sizeof(T) * VEC) Pack { T e[VEC]; };
  const long long row = blockIdx.x;
  const Pack* xr = reinterpret_cast<const Pack*>(x + row * d);
  Pack* outr = reinterpret_cast<Pack*>(out + row * d);
  const int n = d / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Pack p = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v = to_f32(p.e[j]);
      ss += v * v;
    }
  }
  const float r = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Pack p = xr[i];
    Pack o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float y = to_f32(p.e[j]) * r;
      from_f32(y * (1.0f + w[i * VEC + j]), &o.e[j]);
    }
    outr[i] = o;
  }
}

template <typename T>
int launch(const void* x, const float* w, void* out, int rows, int d, float eps,
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

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success);
// an unknown dtype or an empty shape returns cudaErrorInvalidValue.
extern "C" int rmsnorm_fwd(const void* x, const float* w, void* out, int rows, int d,
                           int dtype, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, rows, d, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
