// Grouped (ragged) GEMM for Hopper (sm_90a), the MoE expert matmul, plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel `_gg_kernel` of
// src/repro/kernels/grouped_gemm/kernel.py (via `grouped_gemm_pallas` and the
// wrapper `ops.py::grouped_gemm`):
//   out[i] = x[i] @ w[g(i)]
// for rows x [M, K] sorted by expert, w [E, K, N] (the reference's `x @ w`
// orientation) and group_sizes [E] (device int32): expert e owns the rows
// [start_e, start_e + group_sizes[e]), start_e the sum of the sizes before
// it.  Rows past the last group are written as zeros, as
// jax.lax.ragged_dot (the reference's oracle) gives them.  Products are
// accumulated in fp32; out has x's type (float32 or bfloat16).
//
// Bound: bytes, at the serving shapes.  A decode step routes ~32 rows to
// ~32 experts, about one row each, so the call is the touched experts'
// weights read once (K·N·2 bytes each, 5.8 MB at qwen2-moe's 2048 × 1408).
// A fused 64-token chunk of 8 slots routes 2048 rows over all 60 real
// experts, ~34 rows each: ~5 flops per weight byte, far under the card's
// ~295 flop/byte bf16 ridge.  What must hold is that each (expert, N-tile)
// of weights is read from device memory once per row tile, never once per
// row.
//
// Design.  The TPU wrapper pads every group to whole 128-row blocks in a
// copy of x (megablocks packing), hands the kernel a block → expert map by
// scalar prefetch, and gathers the output rows back: BlockSpecs need whole
// blocks.  Here one block owns one [BM, BN] output tile of one expert's row
// range and reads x's rows in place, masking the ragged row edge itself: no
// padded copy of x and no gather afterwards.  The grid is sized from what
// the host knows, ceil(M/BM) + E row tiles by ceil(N/BN) column tiles (the
// sum over experts of ceil(size/BM), plus the tiles of rows no group
// covers, never exceeds it); in its prologue, warp 0 of each block finds
// its (expert, row tile) by a shuffle prefix sum over ceil(size/BM), 32
// experts at a time, and blocks past the last tile exit, so an empty expert
// costs nothing.  The block walks K in BK-deep steps through a STAGES-deep
// ring of shared-memory stages filled by 16-byte `cp.async` copies, the
// copies of the next stages in flight while one is computed.  The TPU
// kernel's 512-deep K tile and 128-wide N tile are not inherited: any K and
// N that are multiples of 8 (16-byte bf16 copies) work, so qwen2-moe's down
// projection (K = 1408) runs; a K or N tail is zero-filled.  bf16 products
// run on the tensor cores with `mma.sync.m16n8k16` (fragments loaded with
// `ldmatrix`, B transposed on the load since w keeps N contiguous): four
// warps, each a 32 × 64 piece of the tile, and an m16 piece with no valid
// row is skipped (a decode tile holds one row).  fp32 runs on the CUDA
// cores, 8 × 8 outputs a thread.  No wgmma, TMA or persistent tiles yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int BM = 64;       // rows of one expert per block tile
constexpr int BN = 128;      // output columns per block tile
constexpr int BK = 32;       // depth of one pipeline stage
constexpr int STAGES = 4;    // cp.async ring depth
constexpr int NT = 128;      // threads per block (four warps)
constexpr unsigned FULL = 0xffffffffu;

// 16-byte global -> shared copy that bypasses the registers; src_bytes = 0
// fills the 16 bytes with zeros (a K or N tail)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// c += a · b for one 16 × 8 × 16 bf16 piece, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store(float v, float* out) { *out = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

// shared-memory layout of one stage: the x tile [BM][LDA], then the w tile
// [BK][LDB], rows padded by 16 bytes against bank conflicts
template <typename T>
struct Layout {
  static constexpr int EPC = 16 / sizeof(T);    // elements per 16-byte copy
  static constexpr int LDA = BK + EPC;
  static constexpr int LDB = BN + EPC;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * LDB;
  static constexpr size_t SMEM = static_cast<size_t>(STAGES) * STAGE_ELEMS * sizeof(T);
};

template <typename T>
__global__ void __launch_bounds__(NT)
grouped_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int* __restrict__ group_sizes, T* __restrict__ out, int M, int K,
                    int N, int E) {
  using L = Layout<T>;
  constexpr int EPC = L::EPC;
  constexpr int LDA = L::LDA;
  constexpr int LDB = L::LDB;

  __shared__ int s_tile[3];   // expert (-1: rows no group covers), first row, end row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * BN;

  // which expert's row tile this block owns: prefix sums over the experts
  // of their sizes and of their tile counts ceil(size/BM), 32 at a time
  if (warp == 0) {
    int tiles_before = 0;
    int rows_before = 0;
    bool found = false;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const int gs = e < E ? max(group_sizes[e], 0) : 0;
      const int nt = (gs + BM - 1) / BM;
      int nt_inc = nt;
      int gs_inc = gs;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int a = __shfl_up_sync(FULL, nt_inc, off);
        const int b = __shfl_up_sync(FULL, gs_inc, off);
        if (lane >= off) {
          nt_inc += a;
          gs_inc += b;
        }
      }
      const int t_lo = tiles_before + nt_inc - nt;
      const bool mine = tile >= t_lo && tile < t_lo + nt;
      if (mine) {
        const int start = rows_before + gs_inc - gs;
        const int r0 = start + (tile - t_lo) * BM;
        s_tile[0] = e;
        s_tile[1] = r0;
        s_tile[2] = min(r0 + BM, start + gs);
      }
      tiles_before += __shfl_sync(FULL, nt_inc, 31);
      rows_before += __shfl_sync(FULL, gs_inc, 31);
      if (__ballot_sync(FULL, mine)) {
        found = true;
        break;
      }
    }
    if (!found && lane == 0) {
      // past every expert's tiles: the rows after the last group, BM a tile
      const int r0 = rows_before + (tile - tiles_before) * BM;
      s_tile[0] = -1;
      s_tile[1] = r0;
      s_tile[2] = r0 + BM;
    }
  }
  __syncthreads();
  const int expert = s_tile[0];
  const int row_lo = s_tile[1];
  const int rows = min(s_tile[2], M) - row_lo;   // valid rows of this tile
  if (rows <= 0) return;                          // block-uniform
  if (expert < 0) {
    for (int e = tid; e < rows * BN; e += NT) {
      const int c = n0 + e % BN;
      if (c < N) store(0.f, &out[static_cast<long long>(row_lo + e / BN) * N + c]);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const T* wexp = w + static_cast<long long>(expert) * K * N;
  const int n_k = (K + BK - 1) / BK;

  // start the copies of K step kt into stage kt % STAGES (rows past the
  // tile's are not copied: a product row reads only its own x row, and those
  // output rows are never stored)
  auto load = [&](int kt) {
    T* As = smem + (kt % STAGES) * L::STAGE_ELEMS;
    T* Bs = As + L::A_ELEMS;
    const int k0 = kt * BK;
    for (int c = tid; c < BM * (BK / EPC); c += NT) {
      const int r = c / (BK / EPC);
      const int kc = (c % (BK / EPC)) * EPC;
      if (r >= rows) break;                       // r grows with c
      const bool in = k0 + kc < K;
      const T* src = in ? x + static_cast<long long>(row_lo + r) * K + k0 + kc : x;
      cp_async16(As + r * LDA + kc, src, in ? 16 : 0);
    }
    for (int c = tid; c < BK * (BN / EPC); c += NT) {
      const int kr = c / (BN / EPC);
      const int nc = (c % (BN / EPC)) * EPC;
      const bool in = k0 + kr < K && n0 + nc < N;
      const T* src = in ? wexp + static_cast<long long>(k0 + kr) * N + n0 + nc : w;
      cp_async16(Bs + kr * LDB + nc, src, in ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load(s);
    cp_async_commit();   // empty groups keep the count uniform
  }

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // four warps, 2 × 2, each a 32 × 64 piece: 2 m16 × 8 n8 mma tiles
    const int wm0 = (warp >> 1) * 32;
    const int wn0 = (warp & 1) * 64;
    const bool live[2] = {wm0 < rows, wm0 + 16 < rows};
    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

    for (int kt = 0; kt < n_k; ++kt) {
      cp_async_wait<STAGES - 2>();   // step kt has landed
      __syncthreads();               // ... for every thread; stage kt-1 is free
      if (kt + STAGES - 1 < n_k) load(kt + STAGES - 1);
      cp_async_commit();
      if (!live[0]) continue;        // warp-uniform: no valid row in this piece
      const T* As = smem + (kt % STAGES) * L::STAGE_ELEMS;
      const T* Bs = As + L::A_ELEMS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          if (live[mi])
            ldmatrix_x4(a[mi], As + (wm0 + mi * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          unsigned b[4];   // b0, b1 of n8 tile 2nj, then of 2nj + 1
          ldmatrix_x4_trans(b, Bs + (kk + (lane & 15)) * LDB + wn0 + nj * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if (!live[mi]) continue;
            mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait<0>();

    // accumulator (row lane/4 [+8], cols 2·(lane%4), +1) of each n8 tile
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int c = n0 + wn0 + ni * 8 + (lane & 3) * 2;
        if (c >= N) continue;        // N % 8 == 0: a pair is in or out whole
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm0 + mi * 16 + (lane >> 2) + half * 8;
          if (r >= rows) continue;
          *reinterpret_cast<__nv_bfloat162*>(&out[static_cast<long long>(row_lo + r) * N + c]) =
              __floats2bfloat162_rn(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
        }
      }
    }
  } else {
    // fp32 on the CUDA cores: thread (ty, tx) owns rows ty + 8i, cols tx + 16j
    const int ty = tid / 16;
    const int tx = tid % 16;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int kt = 0; kt < n_k; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (kt + STAGES - 1 < n_k) load(kt + STAGES - 1);
      cp_async_commit();
      const T* As = smem + (kt % STAGES) * L::STAGE_ELEMS;
      const T* Bs = As + L::A_ELEMS;
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float av[8];
        float bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = As[(ty + 8 * i) * LDA + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = Bs[k * LDB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + tx + 16 * j;
        if (c < N) out[static_cast<long long>(row_lo + r) * N + c] = acc[i][j];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const int* group_sizes, void* out, int M, int K, int N,
           int E, cudaStream_t stream) {
  constexpr size_t smem = Layout<T>::SMEM;
  auto kern = grouped_gemm_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((M + BM - 1) / BM + E, (N + BN - 1) / BN);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                   group_sizes, static_cast<T*>(out), M, K, N, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).  x [M, K], w
// [E, K, N] and out [M, N] are contiguous and 16-byte aligned; group_sizes
// is device int32 [E].  K and N must be multiples of 8.  Returns a
// cudaError_t (0 = success); a shape the kernel does not take returns
// cudaErrorInvalidValue without launching.
extern "C" int grouped_gemm_fwd(const void* x, const void* w, const int* group_sizes, void* out,
                                int M, int K, int N, int E, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 != 0 || N % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, group_sizes, out, M, K, N, E, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, group_sizes, out, M, K, N, E, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
