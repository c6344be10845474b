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
// tokens moves x and y, B and C, dt, and the fp32 state read and written:
// ~31.8 MB at zamba2 (H 80, P 64, N 64), ~16 MB at mamba2 (H 24, P 64,
// N 128), of which the state is 21 and 12.6 MB.  Its ~1.3 and ~0.7 GFLOP
// (2·L²·N + 2·L²·P + 4·L·N·P per row, head and chunk of L tokens) take
// about a microsecond at the bf16 tensor peak.
//
// Two kernels compute the function: bf16 calls run the tensor-core kernel
// `ssd_scan_mma_kernel`, fp32 calls the CUDA-core kernel `ssd_scan_kernel`.
//
// bf16: `ssd_scan_mma_kernel<N, PB>`.  One block of 4 warps (128 threads)
// per (slab of PB state rows p, head, batch row), PB = 64, 32 or 16 (the
// host takes the widest that divides P, and 32 for 64 where the grid would
// fill under half the SMs: mamba2 at 1-2 rows, and its 2-row prefill); it
// walks the chunks of its (b, h) in a loop, so nothing carries between
// blocks.  Shared memory, for lcap = min(chunk, S) rounded up to 16 rows,
// one stage (two when S > chunk, the next chunk copied during this one):
//   stage: x lcap×(PB+8), B and C lcap×(N+8) in bf16, dt lcap fp32;
//   the state's bf16 hi and lo parts PB×(N+8) each; cum lcap fp32.
// Rows padded by 16 bytes put the 8 rows of an `ldmatrix` on distinct
// banks.  zamba2's fused chunk (N 64, PB 64, lcap 64, one stage): 46.6 KB;
// mamba2's (N 128): 79 KB; mamba2 prefill (chunk 128, two stages): 212 KB
// at PB 64, 179 KB at PB 32.
// Every copy is a 16-byte `cp.async` (dt 4 bytes) that zero-fills rows
// past the chunk's end, so those rows contribute nothing to any product.
// Per chunk, with warp 0 taking cum = cumsum(dt·A)·log2 e by a warp scan:
//   1. each warp takes row tiles of 16 tokens (rt = warp, 7 − warp): C's
//      A-fragments by `ldmatrix`, then y = (C · stateᵀ) 2^{cum_i} with the
//      state's hi and lo parts as B-fragments (two `mma.sync.m16n8k16`
//      bf16 products, fp32 accumulators), then for each key tile of 16
//      tokens kt <= rt: S = C·Bᵀ (K = N), S ⊙ 2^{cum_i − cum_j} ⊙ dt_j in
//      fp32, exact zeros above the diagonal, rounded to bf16 in registers
//      as the next A-fragment (as the flash tile repacks P), and y += that
//      · x with x's B-fragments by `ldmatrix.trans`;
//   2. B is overwritten in place by W = bf16(B ⊙ dt·2^{cum_last − cum});
//   3. the state, fp32 in the warps' accumulator fragments for the whole
//      call, becomes state·2^{cum_last} + xᵀ·W (K = the chunk's tokens,
//      xᵀ's A-fragments by `ldmatrix.trans`); each of up to four warps
//      owns 16 of its rows and a share of the columns (all N at PB 64),
//      and writes its hi and lo parts back to shared memory for the next
//      chunk.
// The state is read from init_state once, into registers, and written to
// final_state once, from registers.  Rounding: B, C and x are bf16 on
// entry, so C·Bᵀ and both products with x are exact in their inputs; the
// decayed dt-weighted scores and W are rounded to bf16 once each (dt kept
// in fp32 up to there, not folded into x), and the fp32 state enters
// C·stateᵀ as hi + lo bf16 parts (about 16 mantissa bits).  The decay is
// always 2^{difference} (ex2.approx): a chunk's cum reaches ~−100 at A
// −16 and e^{100} overflows fp32, so it is never factored.  Registers, as
// `-Xptxas -v` reports them, are in PERF.md.
//
// fp32: `ssd_scan_kernel<float, N>`, the CUDA-core kernel.  One block per
// (32 columns of P, head, batch row); per chunk, B and C tiles and dt·x in
// shared memory, cum by a warp scan; 256 threads each own 4 rows × 4
// columns of y, first the inter-chunk term from the carried state, then
// the intra-chunk term over 32-key score tiles (C Bᵀ ⊙ decay, zero above
// the diagonal) staged in shared memory; then each thread updates the N/8
// state entries of one column that it alone owns, the state kept in
// shared memory across chunks.  Shared memory, by lcap = min(chunk, S):
//   state 32×(N+1)·4 + dt·x lcap×32·4 + score tile lcap×33·4 + cum and
//   decay 2·lcap·4 + B, C 2·lcap×(N+1)·4
// = 183 KB at chunk 128, N 128; the limit is 227 KB.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }

// ------------------------------------------------------------ PTX helpers
// 16-byte (and 4-byte) global -> shared copies that bypass the registers;
// src_bytes = 0 fills the destination with zeros (rows past the chunk)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// four 8x8 bf16 matrices from shared memory, one row address per lane
// (lanes 8i..8i+7 give matrix i's rows); lane t receives row t/4, columns
// 2(t%4) and 2(t%4)+1 of each, or with .trans the same of the transpose
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col),
// d 16x8 fp32.  Lane t = 4 gr + tq holds d rows gr and gr + 8, columns
// 2 tq and 2 tq + 1: {d0, d1} and {d2, d3}
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit, results below 2^-126 flushed to 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// ------------------------------------------------------- end PTX helpers

// two floats rounded to one bf16 pair, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

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

// ------------------------------------------- bf16: the tensor-core kernel
constexpr int TC_NT = 128;                 // 4 warps
constexpr int TC_NW = TC_NT / 32;
constexpr float LOG2E = 1.4426950408889634f;

template <int N, int PB>
struct TcLayout {
  static constexpr int LDX = PB + 8;       // x row, bf16 elements
  static constexpr int LDN = N + 8;        // B, C and state rows, bf16 elements
  // one stage: x [lcap][LDX], B and C [lcap][LDN] bf16, dt [lcap] fp32
  __host__ __device__ static size_t stage_bytes(int lcap) {
    return static_cast<size_t>(lcap) * ((LDX + 2 * LDN) * sizeof(__nv_bfloat16) + sizeof(float));
  }
  // the stages, the state's hi and lo parts [PB][LDN] bf16, cum [lcap] fp32
  static size_t bytes(int lcap, int stages) {
    return stages * stage_bytes(lcap) + 2 * static_cast<size_t>(PB) * LDN * sizeof(__nv_bfloat16) +
           static_cast<size_t>(lcap) * sizeof(float);
  }
};

template <int N, int PB>
__global__ void __launch_bounds__(TC_NT)
ssd_scan_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm, const float* init_state,
                    __nv_bfloat16* __restrict__ y, float* final_state, int S, int H, int P, int G,
                    int chunk, int lcap, int stages) {
  using T = __nv_bfloat16;
  using L = TcLayout<N, PB>;
  constexpr int LDX = L::LDX;
  constexpr int LDN = L::LDN;
  constexpr int KN = N / 16;               // k-steps over the state width
  constexpr int YT = PB / 8;               // n-tiles of a y row tile
  // the state: PB/16 tiles of 16 rows, each cut into NSPLIT column parts
  // of NW columns, one part a warp
  constexpr int NSPLIT = (64 / PB < N / 16) ? 64 / PB : N / 16;
  constexpr int NW = N / NSPLIT;
  constexpr int SW = (PB / 16) * NSPLIT;   // warps that own a part
  static_assert(N % 16 == 0 && PB % 16 == 0 && PB <= 64, "whole 16-row and 16-column tiles");
  static_assert(SW <= TC_NW && NW * NSPLIT == N && NW % 16 == 0,
                "every state row and column has exactly one owner warp");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t sbytes = L::stage_bytes(lcap);
  T* Sh = reinterpret_cast<T*>(smem_raw + stages * sbytes);   // [PB][LDN] state, hi part
  T* Sl = Sh + PB * LDN;                                      // [PB][LDN] state, lo part
  float* cum = reinterpret_cast<float*>(Sl + PB * LDN);      // [lcap] cumsum(dt·A)·log2 e

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;                // fragment row (and +8)
  const int tq = lane & 3;                 // fragment column pair
  const int p0 = blockIdx.x * PB;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int g = h / (H / G);
  const float a_log2 = A[h] * LOG2E;
  const int nchunks = (S + chunk - 1) / chunk;

  // issue the copies of the chunk at token c0 into stage st; rows past its
  // end (up to lcap) are zero-filled
  auto load_chunk = [&](int c0, int st) {
    unsigned char* base = smem_raw + st * sbytes;
    T* xs = reinterpret_cast<T*>(base);
    T* bs = xs + lcap * LDX;
    T* cs = bs + lcap * LDN;
    float* ds = reinterpret_cast<float*>(cs + lcap * LDN);
    const int lc = min(chunk, S - c0);
    for (int e = tid; e < lcap * (PB / 8); e += TC_NT) {
      const int t = e / (PB / 8);
      const int c = e % (PB / 8);
      const bool in = t < lc;
      const long long off = in ? ((b * S + c0 + t) * H + h) * P + p0 + c * 8 : 0;
      cp_async16(xs + t * LDX + c * 8, x + off, in ? 16 : 0);
    }
    for (int e = tid; e < lcap * (N / 8); e += TC_NT) {
      const int t = e / (N / 8);
      const int c = e % (N / 8);
      const bool in = t < lc;
      const long long off = in ? ((b * S + c0 + t) * G + g) * N + c * 8 : 0;
      cp_async16(bs + t * LDN + c * 8, Bm + off, in ? 16 : 0);
      cp_async16(cs + t * LDN + c * 8, Cm + off, in ? 16 : 0);
    }
    for (int t = tid; t < lcap; t += TC_NT) {
      const bool in = t < lc;
      cp_async4(ds + t, dt + (in ? (b * S + c0 + t) * H + h : 0), in ? 4 : 0);
    }
    cp_async_commit();
  };
  load_chunk(0, 0);

  // this warp's part of the state: rows sp + gr (+ 8) of the slab, columns
  // sn + 8 j + 2 tq (+ 1), fp32 for the whole call
  const bool owner = warp < SW;
  const int sp = (warp / NSPLIT) * 16;
  const int sn = (warp % NSPLIT) * NW;
  float st[NW / 8][4];
  const long long s_off = ((b * H + h) * P + p0 + sp + gr) * N + sn + 2 * tq;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float2 v = make_float2(0.f, 0.f);
      if (owner && init_state != nullptr)
        v = *reinterpret_cast<const float2*>(init_state + s_off + 8 * i * N + 8 * j);
      st[j][2 * i] = v.x;
      st[j][2 * i + 1] = v.y;
    }
  }
  // the state as C·stateᵀ's operand: hi = bf16(s), lo = bf16(s − hi)
  auto write_state = [&]() {
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int o = (sp + gr + 8 * i) * LDN + sn + 8 * j + 2 * tq;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(st[j][2 * i], st[j][2 * i + 1]);
        const float2 hf = __bfloat1622float2(hi);
        *reinterpret_cast<__nv_bfloat162*>(Sh + o) = hi;
        *reinterpret_cast<__nv_bfloat162*>(Sl + o) =
            __floats2bfloat162_rn(st[j][2 * i] - hf.x, st[j][2 * i + 1] - hf.y);
      }
    }
  };
  if (owner) write_state();

  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * chunk;
    const int lc = min(chunk, S - c0);
    const int nrt = (lc + 15) >> 4;        // row tiles of 16 tokens
    unsigned char* base = smem_raw + (c & (stages - 1)) * sbytes;
    T* xs = reinterpret_cast<T*>(base);
    T* bs = xs + lcap * LDX;
    const T* cs = bs + lcap * LDN;
    const float* ds = reinterpret_cast<const float*>(cs + lcap * LDN);

    cp_async_wait_all();
    // this chunk's tiles visible to all; the previous chunk's reads of the
    // other stage done, and its state written
    __syncthreads();
    if (c + 1 < nchunks) load_chunk(c0 + chunk, (c + 1) & 1);

    if (warp == 0) {
      // inclusive cumsum of dt·A·log2 e: 4 consecutive tokens a lane, then a
      // warp scan (dt is 0 past the chunk, so cum stays at its last value)
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = lane * 4 + q;
        run += t < lcap ? ds[t] * a_log2 : 0.f;
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
        if (t < lcap) cum[t] = excl + v[q];
      }
    }
    __syncthreads();
    const float c_last = cum[lc - 1];

    // row tiles warp and 7 − warp: the causal key loop then costs every warp
    // the same 9 key tiles at a chunk of 128
    for (int pass = 0; pass < 2; ++pass) {
      const int rt = pass == 0 ? warp : 2 * TC_NW - 1 - warp;
      if (rt >= nrt) continue;
      const int i0 = 16 * rt;
      // C's A-fragments: (rows 0-7, n 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
      unsigned ca[KN][4];
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        ldmatrix_x4(ca[kk], cs + (i0 + (lane & 15)) * LDN + kk * 16 + (lane >> 4) * 8);

      // inter-chunk: y = (C · (hi + lo)ᵀ) 2^{cum_i}; the state's B-fragments
      // for p-tiles 2np and 2np+1 from one ldmatrix.x4 of its rows
      float yacc[YT][4];
#pragma unroll
      for (int j = 0; j < YT; ++j) yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
#pragma unroll
        for (int np = 0; np < PB / 16; ++np) {
          const int o = (16 * np + (lane & 7) + ((lane >> 4) << 3)) * LDN + kk * 16 +
                        ((lane >> 3) & 1) * 8;
          unsigned sb[4];
          ldmatrix_x4(sb, Sh + o);
          mma_bf16_16816(yacc[2 * np], ca[kk], sb[0], sb[1]);
          mma_bf16_16816(yacc[2 * np + 1], ca[kk], sb[2], sb[3]);
          ldmatrix_x4(sb, Sl + o);
          mma_bf16_16816(yacc[2 * np], ca[kk], sb[0], sb[1]);
          mma_bf16_16816(yacc[2 * np + 1], ca[kk], sb[2], sb[3]);
        }
      }
      const float ci[2] = {cum[i0 + gr], cum[i0 + gr + 8]};
      const float ei[2] = {fast_exp2(ci[0]), fast_exp2(ci[1])};
#pragma unroll
      for (int j = 0; j < YT; ++j) {
        yacc[j][0] *= ei[0];
        yacc[j][1] *= ei[0];
        yacc[j][2] *= ei[1];
        yacc[j][3] *= ei[1];
      }

      // intra-chunk, one key tile of 16 tokens at a time up to the diagonal
      for (int kt = 0; kt <= rt; ++kt) {
        // S = C Bᵀ: key n-tiles 0 and 1 from one ldmatrix.x4 of B rows
        float s[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          unsigned bb[4];
          ldmatrix_x4(bb, bs + (16 * kt + (lane & 7) + ((lane >> 4) << 3)) * LDN + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16_16816(s[0], ca[kk], bb[0], bb[1]);
          mma_bf16_16816(s[1], ca[kk], bb[2], bb[3]);
        }
        // element e of n-tile nt: row i0 + gr + 8 (e >> 1), key
        // 16 kt + 8 nt + 2 tq + (e & 1); exact zeros above the diagonal
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = 16 * kt + 8 * nt + 2 * tq;
          const float2 cj = *reinterpret_cast<const float2*>(cum + j);
          const float2 dj = *reinterpret_cast<const float2*>(ds + j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + gr + 8 * (e >> 1);
            const float cjv = (e & 1) ? cj.y : cj.x;
            const float djv = (e & 1) ? dj.y : dj.x;
            s[nt][e] = j + (e & 1) <= i ? s[nt][e] * fast_exp2(ci[e >> 1] - cjv) * djv : 0.f;
          }
        }
        // the scores in bf16 are the A-fragment of y += scores · x; x's
        // B-fragments by ldmatrix.trans of x rows (keys 0-7, p 0-7),
        // (keys 8-15, p 0-7), (keys 0-7, p 8-15), (keys 8-15, p 8-15)
        const unsigned pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
        for (int dp = 0; dp < PB / 16; ++dp) {
          unsigned xb[4];
          ldmatrix_x4_trans(xb, xs + (16 * kt + (lane & 15)) * LDX + 16 * dp + (lane >> 4) * 8);
          mma_bf16_16816(yacc[2 * dp], pa, xb[0], xb[1]);
          mma_bf16_16816(yacc[2 * dp + 1], pa, xb[2], xb[3]);
        }
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = i0 + gr + 8 * i;
        if (row < lc) {
          T* yr = y + ((b * S + c0 + row) * H + h) * P + p0 + 2 * tq;
#pragma unroll
          for (int j = 0; j < YT; ++j)
            *reinterpret_cast<__nv_bfloat162*>(yr + 8 * j) =
                __floats2bfloat162_rn(yacc[j][2 * i], yacc[j][2 * i + 1]);
        }
      }
    }
    // every read of B and of the state's shared copy is done
    __syncthreads();

    // B becomes W = bf16(B ⊙ dt·2^{cum_last − cum}), in place, 8 at a time
    for (int e = tid; e < 16 * nrt * (N / 8); e += TC_NT) {
      const int t = e / (N / 8);
      const int c8 = (e % (N / 8)) * 8;
      const float w = ds[t] * fast_exp2(c_last - cum[t]);
      uint4 v = *reinterpret_cast<const uint4*>(bs + t * LDN + c8);
      __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(pv[q]);
        pv[q] = __floats2bfloat162_rn(f.x * w, f.y * w);
      }
      *reinterpret_cast<uint4*>(bs + t * LDN + c8) = v;
    }
    __syncthreads();

    // state = state·2^{cum_last} + xᵀ W: xᵀ's A-fragments by ldmatrix.trans
    // of x rows (keys 0-7, p 0-7), (keys 0-7, p 8-15), (keys 8-15, p 0-7),
    // (keys 8-15, p 8-15); W's B-fragments as x's in the y product
    if (owner) {
      const float dl = fast_exp2(c_last);
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        st[j][0] *= dl;
        st[j][1] *= dl;
        st[j][2] *= dl;
        st[j][3] *= dl;
      }
      for (int kt = 0; kt < nrt; ++kt) {
        unsigned xa[4];
        ldmatrix_x4_trans(xa, xs + (16 * kt + (lane & 7) + ((lane >> 4) << 3)) * LDX + sp +
                                  ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int np = 0; np < NW / 16; ++np) {
          unsigned wb[4];
          ldmatrix_x4_trans(wb, bs + (16 * kt + (lane & 15)) * LDN + sn + 16 * np + (lane >> 4) * 8);
          mma_bf16_16816(st[2 * np], xa, wb[0], wb[1]);
          mma_bf16_16816(st[2 * np + 1], xa, wb[2], wb[3]);
        }
      }
      if (c + 1 < nchunks) write_state();
    }
  }

  if (owner) {
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(final_state + s_off + 8 * i * N + 8 * j) =
            make_float2(st[j][2 * i], st[j][2 * i + 1]);
  }
}

template <int N, int PB>
int launch_mma(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
               const float* init_state, void* y, float* final_state, int Bsz, int S, int H,
               int P, int G, int chunk, cudaStream_t stream) {
  const int lcap = ((chunk < S ? chunk : S) + 15) / 16 * 16;
  const int stages = S > chunk ? 2 : 1;
  const size_t smem = TcLayout<N, PB>::bytes(lcap, stages);
  auto kern = ssd_scan_mma_kernel<N, PB>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(P / PB, H, Bsz);
  using T = __nv_bfloat16;
  kern<<<grid, TC_NT, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      init_state, static_cast<T*>(y), final_state, S, H, P, G, chunk, lcap, stages);
  return static_cast<int>(cudaGetLastError());
}

// the state rows a bf16 block takes: the widest slab of 64, 32 or 16 that
// divides P; 64 becomes 32 where the grid would fill under half the SMs
// (a block's chain of dependent steps, not the bytes, then sets the time)
int p_block(int Bsz, int H, int P, int sms) {
  const int pb = P % 64 == 0 ? 64 : P % 32 == 0 ? 32 : 16;
  return pb == 64 && 2LL * (P / 64) * H * Bsz < sms ? 32 : pb;
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
// states are fp32; all tensors contiguous in the layouts above (bf16 x, B
// and C 16-byte aligned).  init_state may be null (zero state).
// final_state may be init_state itself (the cache updated in place): each
// block reads its slice of the state before its first chunk and writes the
// same slice after its last, and no two blocks share a slice.  Built for
// state widths N = 32, 64 and 128 and 1 <= chunk <= 128, bf16 for P a
// multiple of 16; anything else returns cudaErrorInvalidValue without
// launching.  *kernel receives which kernel ran: 1 the tensor-core kernel,
// 0 the CUDA-core one.  Returns a cudaError_t (0 = success).
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A, const void* B,
                            const void* C, const float* init_state, void* y, float* final_state,
                            int Bsz, int S, int H, int P, int G, int N, int chunk, int dtype,
                            void* stream, int* kernel) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 || chunk <= 0 ||
      chunk > MAX_CHUNK || (dtype != 0 && dtype != 1) || (dtype == 1 && P % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *kernel = dtype;
  if (dtype == 0) {
#define SSD_INSTANCE(DIM) \
  return launch<float, DIM>(x, dt, A, B, C, init_state, y, final_state, Bsz, S, H, P, G, chunk, s)
    if (N == 32) SSD_INSTANCE(32);
    if (N == 64) SSD_INSTANCE(64);
    if (N == 128) SSD_INSTANCE(128);
#undef SSD_INSTANCE
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pb = p_block(Bsz, H, P, sms);
#define SSD_INSTANCE(DIM, PBW)                                                                  \
  return launch_mma<DIM, PBW>(x, dt, A, B, C, init_state, y, final_state, Bsz, S, H, P, G,     \
                              chunk, s)
  if (N == 32 && pb == 64) SSD_INSTANCE(32, 64);
  if (N == 32 && pb == 32) SSD_INSTANCE(32, 32);
  if (N == 32 && pb == 16) SSD_INSTANCE(32, 16);
  if (N == 64 && pb == 64) SSD_INSTANCE(64, 64);
  if (N == 64 && pb == 32) SSD_INSTANCE(64, 32);
  if (N == 64 && pb == 16) SSD_INSTANCE(64, 16);
  if (N == 128 && pb == 64) SSD_INSTANCE(128, 64);
  if (N == 128 && pb == 32) SSD_INSTANCE(128, 32);
  if (N == 128 && pb == 16) SSD_INSTANCE(128, 16);
#undef SSD_INSTANCE
  return static_cast<int>(cudaErrorInvalidValue);
}

