// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssd_scan/kernel.py (via `ssd_scan_pallas` and the
// wrapper `ops.py::ssd_scan`), and takes what the model's chunk
// continuation needs and the TPU kernel lacks: an initial state.  For each
// (batch row b, head h), over chunks of `chunk` tokens, in fp32:
//   cum   = cumsum(dt·A)                                     (within the chunk)
//   y     = ((C Bᵀ) ⊙ tril(e^{cum_i − cum_j})) (dt·x) + (C ⊙ e^{cum}) · stateᵀ
//   state ← state·e^{cum_last} + (B ⊙ e^{cum_last − cum})ᵀ (dt·x)
// starting from init_state (or zeros).  B and C are shared per group:
// head h reads group h / (H / G).  Inputs keep the model's layout, read by
// stride: x [B, S, H, P], dt [B, S, H] fp32 (post-softplus), A [H] fp32,
// B/C [B, S, G, N]; y [B, S, H, P] has x's type, the final state
// [B, H, P, N] is fp32.  The last chunk may be short: its missing tokens
// are what padding with dt = 0 and x = 0 means in the reference
// (`models/ssm.py::ssd_chunked`), so the kernel simply stops at S and
// stores no padded y.
//
// Bound: bytes at the main path's shapes.  A fused step of 8 rows × 64
// tokens moves x and y, B and C, and the fp32 state read and written;
// for mamba2 (H 24, P 64, N 128) the state alone is 12.6 of ~16 MB.  Its
// ~0.7 GFLOP (2·L²·N + 2·L²·P + 4·L·N·P per row, head and chunk) is under
// a microsecond at the bf16 tensor peak.  This version computes on the fp32
// CUDA cores from shared memory, so its arithmetic and shared-memory
// traffic, not the bytes, hold it back; mma.sync or wgmma tiles for the
// C Bᵀ and state products are later work.
//
// Design.  The TPU kernel walks the chunks as a sequential grid axis with
// the state in VMEM scratch; here one block walks all chunks of its
// (b, h) in a loop with the state in shared memory, so nothing carries
// between blocks.  Columns p of y and of the state are independent given
// C Bᵀ and cum, so a block owns 32 of the P columns: grid (P/32, H, B).
// That doubles the C Bᵀ work at P = 64 but gives 384 blocks for a
// mamba2 fused step of 8 rows (192 for whole heads, under two per SM on
// 132 SMs) and 1280 for zamba2.  Per chunk: B and C tiles in the input
// type, dt·x for the block's columns and cum in fp32 (cum by a warp scan);
// 256 threads each own 4 rows × 4 columns of y, first the inter-chunk term
// from the carried state, then the intra-chunk term over 32-column score
// tiles (C Bᵀ ⊙ decay, zero above the diagonal) staged in shared memory;
// then each thread updates the N/8 state entries of one column that it
// alone owns.  Shared memory, sized by lcap = min(chunk, S) rows:
//   state 32×(N+1)·4 + dt·x lcap×32·4 + score tile lcap×33·4 + cum and
//   decay 2·lcap·4 + B, C 2·lcap×(N+4/sizeof(T))·sizeof(T)
// = 117 KB at bf16, chunk 128, N 128 (mamba2 prefill), 67 KB at its fused
// 64-token step, 183 KB at fp32, chunk 128, N 128; the limit is 227 KB.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

constexpr int NT = 256;          // threads per block
constexpr int PT = 32;           // head-dim columns (P) per block
constexpr int JT = 32;           // key columns of one score tile
constexpr int MAX_CHUNK = 128;   // 32 lanes × 4 tokens in the cumsum; 4 row groups of 32

// shared-memory layout for state width N and input type T
template <typename T, int N>
struct Layout {
  static constexpr int LDB = N + 4 / sizeof(T);   // B/C row, padded by 4 bytes
  static constexpr int LDS = N + 1;               // fp32 state row
  static constexpr int LDSC = JT + 1;             // fp32 score-tile row
  static size_t bytes(int lcap) {
    return sizeof(float) * (static_cast<size_t>(PT) * LDS +
                            static_cast<size_t>(lcap) * (PT + LDSC + 2)) +
           sizeof(T) * 2 * static_cast<size_t>(lcap) * LDB;
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* init_state,
                T* __restrict__ y, float* final_state, int S, int H, int P,
                int G, int chunk, int lcap) {
  static_assert(N % 8 == 0, "the state update gives each of 8 warps N/8 state rows");
  using L = Layout<T, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* st = reinterpret_cast<float*>(smem_raw);   // [PT][LDS] carried state (p, n)
  float* xw = st + PT * L::LDS;                      // [lcap][PT] dt-weighted x
  float* sc = xw + lcap * PT;                        // [lcap][LDSC] one score tile
  float* cum = sc + lcap * L::LDSC;                  // [lcap] cumsum(dt·A)
  float* wend = cum + lcap;                          // [lcap] e^{cum_last − cum_t}
  T* Bs = reinterpret_cast<T*>(wend + lcap);         // [lcap][LDB]
  T* Cs = Bs + lcap * L::LDB;                        // [lcap][LDB]

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int g = h / (H / G);
  const float a = A[h];
  const int tx = tid & 7;      // y: columns p0 + tx + 8c, c < 4
  const int ty = tid >> 3;     // y: rows ty + 32k, k < 4
  const int lane = tid & 31;   // state update: column p0 + lane
  const int wid = tid >> 5;    //               state rows n = wid + 8m

  for (int e = tid; e < PT * N; e += NT) {
    const int pp = e / N;
    const int n = e % N;
    const int p = p0 + pp;
    st[pp * L::LDS + n] = (init_state != nullptr && p < P)
                              ? init_state[((b * H + h) * P + p) * N + n]
                              : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int lc = min(chunk, S - c0);
    __syncthreads();   // the last chunk's reads are done; its state is written

    for (int e = tid; e < lc * N; e += NT) {
      const int t = e / N;
      const int n = e % N;
      const long long src = ((b * S + c0 + t) * G + g) * N + n;
      Bs[t * L::LDB + n] = Bm[src];
      Cs[t * L::LDB + n] = Cm[src];
    }
    for (int e = tid; e < lc * PT; e += NT) {
      const int t = e / PT;
      const int p = p0 + e % PT;
      const long long tok = (b * S + c0 + t) * H + h;
      xw[e] = p < P ? to_f32(x[tok * P + p]) * dt[tok] : 0.f;
    }
    if (wid == 0) {
      // inclusive cumsum of dt·A: 4 consecutive tokens a lane, then a warp scan
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = lane * 4 + q;
        run += t < lc ? dt[(b * S + c0 + t) * H + h] * a : 0.f;
        v[q] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = lane * 4 + q;
        if (t < lc) cum[t] = excl + v[q];
      }
    }
    __syncthreads();

    const float c_last = cum[lc - 1];
    for (int t = tid; t < lc; t += NT) wend[t] = expf(c_last - cum[t]);

    // this thread's rows; a row past the chunk is computed as the last one
    // (never stored) so no shared memory past the chunk is read
    const int nk = (lc + 31) >> 5;
    int row[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) row[k] = min(ty + 32 * k, lc - 1);

    // inter-chunk term: e^{cum_i} Σ_n C[i][n] state[p][n]
    float acc[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[k][c] = 0.f;
    for (int n = 0; n < N; ++n) {
      float sv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) sv[c] = st[(tx + 8 * c) * L::LDS + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < nk) {
          const float cv = to_f32(Cs[row[k] * L::LDB + n]);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[k][c] = fmaf(cv, sv[c], acc[k][c]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float e = expf(cum[row[k]]);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[k][c] *= e;
    }

    // intra-chunk term over 32-key score tiles: sc[i][j] = (C_i·B_j)
    // e^{cum_i − cum_j} for j <= i, else 0; then acc += sc · (dt·x)
    for (int j0 = 0; j0 < lc; j0 += JT) {
      __syncthreads();   // the previous tile is consumed (first time: wend, cum visible)
      int jr[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) jr[m] = min(j0 + tx + 8 * m, lc - 1);
      float d[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m) d[k][m] = 0.f;
      for (int n = 0; n < N; ++n) {
        float bv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) bv[m] = to_f32(Bs[jr[m] * L::LDB + n]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < nk) {
            const float cv = to_f32(Cs[row[k] * L::LDB + n]);
#pragma unroll
            for (int m = 0; m < 4; ++m) d[k][m] = fmaf(cv, bv[m], d[k][m]);
          }
        }
      }
      // threads whose rows were clamped to the last row write the same
      // values as its owner
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < nk) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const bool vis = j0 + tx + 8 * m <= row[k];
            sc[row[k] * L::LDSC + tx + 8 * m] =
                vis ? d[k][m] * expf(cum[row[k]] - cum[jr[m]]) : 0.f;
          }
        }
      }
      __syncthreads();
      const int jn = min(JT, lc - j0);
      for (int jj = 0; jj < jn; ++jj) {
        float xv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = xw[(j0 + jj) * PT + tx + 8 * c];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < nk) {
            const float s = sc[row[k] * L::LDSC + jj];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[k][c] = fmaf(s, xv[c], acc[k][c]);
          }
        }
      }
    }

#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = ty + 32 * k;
      if (k < nk && i < lc) {
        T* yr = y + ((b * S + c0 + i) * H + h) * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = p0 + tx + 8 * c;
          if (p < P) from_f32(acc[k][c], &yr[p]);
        }
      }
    }

    // state update: this thread alone owns column `lane`, rows wid + 8m
    __syncthreads();   // every thread is past its reads of the old state
    const float d_last = expf(c_last);
    float u[N / 8];
#pragma unroll
    for (int m = 0; m < N / 8; ++m) u[m] = 0.f;
    for (int t = 0; t < lc; ++t) {
      const float xv = xw[t * PT + lane];
      const float w = wend[t];
#pragma unroll
      for (int m = 0; m < N / 8; ++m)
        u[m] = fmaf(to_f32(Bs[t * L::LDB + wid + 8 * m]) * w, xv, u[m]);
    }
#pragma unroll
    for (int m = 0; m < N / 8; ++m) {
      float& s = st[lane * L::LDS + wid + 8 * m];
      s = fmaf(s, d_last, u[m]);
    }
  }

  __syncthreads();
  for (int e = tid; e < PT * N; e += NT) {
    const int pp = e / N;
    const int n = e % N;
    const int p = p0 + pp;
    if (p < P) final_state[((b * H + h) * P + p) * N + n] = st[pp * L::LDS + n];
  }
}

template <typename T, int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* init_state, void* y, float* final_state, int Bsz, int S, int H, int P,
           int G, int chunk, cudaStream_t stream) {
  const int lcap = chunk < S ? chunk : S;
  const size_t smem = Layout<T, N>::bytes(lcap);
  auto kern = ssd_scan_kernel<T, N>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((P + PT - 1) / PT, H, Bsz);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      init_state, static_cast<T*>(y), final_state, S, H, P, G, chunk, lcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y share it); dt, A and the
// states are fp32; all tensors contiguous in the layouts above.
// init_state may be null (zero state).  final_state may be init_state
// itself (the cache updated in place): each block reads its [32, N] slice
// of the state before its first chunk and writes the same slice after its
// last, and no two blocks share a slice.  Built for state widths N = 32,
// 64 and 128 and 1 <= chunk <= 128; anything else returns
// cudaErrorInvalidValue without launching.  Returns a cudaError_t
// (0 = success).
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A, const void* B,
                            const void* C, const float* init_state, void* y, float* final_state,
                            int Bsz, int S, int H, int P, int G, int N, int chunk, int dtype,
                            void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 || chunk <= 0 ||
      chunk > MAX_CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_INSTANCE(TYPE, DIM)                                                               \
  return launch<TYPE, DIM>(x, dt, A, B, C, init_state, y, final_state, Bsz, S, H, P, G, chunk, \
                           s)
  if (N == 32 && dtype == 0) SSD_INSTANCE(float, 32);
  if (N == 32 && dtype == 1) SSD_INSTANCE(__nv_bfloat16, 32);
  if (N == 64 && dtype == 0) SSD_INSTANCE(float, 64);
  if (N == 64 && dtype == 1) SSD_INSTANCE(__nv_bfloat16, 64);
  if (N == 128 && dtype == 0) SSD_INSTANCE(float, 128);
  if (N == 128 && dtype == 1) SSD_INSTANCE(__nv_bfloat16, 128);
#undef SSD_INSTANCE
  return static_cast<int>(cudaErrorInvalidValue);
}
