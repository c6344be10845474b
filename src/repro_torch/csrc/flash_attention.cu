// Flash attention for Hopper (sm_90a), dense and paged K/V, plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernels `_flash_kernel` (dense, via
// `flash_attention_pallas` and the wrapper `ops.py::flash_attention`) and
// `_flash_kernel_paged` (via `flash_attention_pallas_paged` and
// `ops.py::flash_attention_paged`) of
// src/repro/kernels/flash_attention/kernel.py.  Per batch row b and query
// head h, query i at absolute position qp = q_offsets[b] + i:
//   out = softmax(softcap(scale * q k^T)) v   over the visible keys kp with
//   kp < k_len, i < q_lens[b], causal kp <= qp, window kp > qp - window.
// A query row with no visible key, and every row i >= q_lens[b], is written
// as exact zeros (the fused mixed-batch padding contract).  Inputs are
// q [B, Sq, H, D], k/v [B, Sk, KV, D] (contiguous), float32 or bfloat16;
// all arithmetic is fp32, with the online-softmax recurrence
//   m' = max(m, rowmax(s));  l' = l e^{m-m'} + rowsum(e^{s-m'});
//   acc' = acc e^{m-m'} + e^{s-m'} v.
//
// Bound: bytes, at the main path's shapes.  A decode row (Sq = 1) reads
// its cache up to its depth once and does ~4 flops per key element for each
// of the `rep` query heads of its KV head.  A 64-token prefill chunk does
// 64·rep query rows per key, at most 256 flops per byte of K/V (112 at the
// mixed-row shape chip_smoke.py times): still under the card's ~295
// flop/byte bf16 ridge.  This version computes on the fp32 CUDA cores,
// not the tensor cores, so at chunk shapes its arithmetic, not the bytes,
// is what holds it back.
//
// Design.  One block per (query-row tile, KV head, batch row).  The tile's
// rows are (query position, head-in-group) pairs, so the `rep` query heads
// sharing one KV head read each K/V tile once — the TPU wrapper's per-group
// K/V broadcast and its 128-lane head-dim pad are layout choices of the TPU
// and are not copied; K/V are read straight from [B, Sk, KV, D] by stride.
// The block walks 64-key tiles through two shared-memory stages:
// `cp.async` copies the next tile in 16-byte pieces, bypassing the
// registers, while the current one is computed, so the copy latency is paid
// once and not per element.  K/V stay
// in the input type in shared memory (rows padded by 16 bytes against bank
// conflicts) and are read as pairs of elements.  In a prefill tile (64
// rows) four lanes own one query row: each scores 16 keys of the tile and
// accumulates D/4 output dims (16 at D = 64, 32 at D = 128); a decode tile
// has 4 rows of 16 lanes, 4 keys and D/16 dims a lane, so no lane idles on
// the few rows of a decode step with rep >= 4 (llama3.2-1b's GQA); at
// D = 80 it has 4 rows of 8 lanes, 8 keys and 10 dims a lane, since 16
// lanes would leave each an odd 5 dims and the pairwise P·V loop needs
// whole pairs (a static_assert holds every instance to that).  Without
// GQA (rep = 1, qwen2-moe) a decode step has one row per (b, KV head), and
// three of the tile's four rows idle: a known waste, not yet addressed.  Row max and sum are reduced across a row's lanes with shuffles,
// and the probabilities are exchanged by shuffle for the P·V product.  The
// key loop starts at the tile's first in-window key and stops at its last
// visible key, q_offset + min(q_len, last row) - 1, so idle rows cost
// nothing and no unwritten cache slot is read.  No mma, wgmma, TMA or warp
// specialisation yet: the products run on the fp32 CUDA cores.
//
// Paged K/V.  One kernel body, two ways to address a key row: the address
// of key kp of batch row b, KV head g, is a template policy.  `DenseKV`
// reads row (b, kp) of k/v [B, Sk, KV, D]; `PagedKV` reads the pools
// [num_pages+1, P, KV, D] at page table[b, kp / P], row kp % P, with a
// negative (unmapped) entry read as the trash page num_pages, as the TPU
// wrapper clamps it.  The logical key axis is pages_per_slot·P long and the
// softmax, masks, tiles and key-range trimming are the dense kernel's, so
// both compute the same function in the same order.  The copy loop tests
// `kp < k_end` before it reads the table, so no entry past a row's last
// visible key is read and a tile that straddles into unmapped pages copies
// zeros.  The 16-byte copies are per key row, so any page size P >= 1
// works: a 64-key tile need not line up with pages (the TPU kernel pins its
// key block to P; that is a choice of its DMA, not copied).
//
// Paged bound: bytes, the same mapped K/V bytes as dense at the same depths
// plus the table entries read (one int32 per page a tile touches, 4 bytes
// per P·KV·D·2 K/V bytes, under 0.01% at P = 64).  The table read costs an
// integer division and one cached 4-byte load per 16-byte copy; the loads
// of one key row hit the same entry in L1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float NEG = -1e30f;   // masked score (matches the TPU kernel)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

// two neighbouring elements of a shared-memory tile, as floats
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 16-byte global -> shared copy that bypasses the registers; src_bytes = 0
// fills the 16 bytes with zeros (keys past the tile's range)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

constexpr int BK = 64;          // keys per tile

// where key row kp of batch row b, KV head g starts, in elements of D:
// the only place the dense and the paged kernels differ
struct DenseKV {
  int Sk;   // rows of k/v per batch row
  __device__ __forceinline__ long long row(long long b, int kp, int KV, int g) const {
    return (b * Sk + kp) * KV + g;
  }
};

struct PagedKV {
  const int* table;     // [B, pages_per_slot]
  int pages_per_slot;
  int P;                // tokens per page
  int trash;            // num_pages: where an unmapped (negative) entry reads
  __device__ __forceinline__ long long row(long long b, int kp, int KV, int g) const {
    int page = table[b * pages_per_slot + kp / P];
    if (page < 0) page = trash;
    return (static_cast<long long>(page) * P + kp % P) * KV + g;
  }
};

// shared memory: Q tile in fp32 [BR][D+1], then two stages of K and V tiles
// in the input type, rows padded by 16 bytes against bank conflicts
template <typename T, int D, int BR>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(BR) * (D + 1) * sizeof(float) +
         4ull * BK * (D + 16 / sizeof(T)) * sizeof(T);
}

// BR query rows per block, TPR lanes per row (a power of two <= 32); Addr
// is DenseKV or PagedKV
template <typename T, int D, int BR, int TPR, typename Addr>
__global__ void __launch_bounds__(BR * TPR)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, const int* __restrict__ q_offsets,
                 const int* __restrict__ q_lens, int Sq, int H, Addr addr, int KV, float scale,
                 int causal, int window, float softcap, int k_len) {
  // each lane owns DPT/2 dim pairs 2*(i*TPR + t): D must split into whole
  // pairs per lane, or the dims past the last pair are never accumulated
  // nor written
  static_assert(D % (2 * TPR) == 0, "head dim must be a multiple of 2 * lanes per row");
  static_assert(BK % TPR == 0, "key tile must split evenly over a row's lanes");
  constexpr int KPT = BK / TPR;             // keys scored per thread per tile
  constexpr int DPT = D / TPR;              // output dims accumulated per thread
  constexpr int LDQ = D + 1;                // fp32 Q row, padded
  constexpr int LDK = D + 16 / sizeof(T);   // K/V row in elements, padded 16 bytes
  constexpr int EPC = 16 / sizeof(T);       // elements per 16-byte copy
  constexpr int CPR = D / EPC;              // copies per key row
  constexpr int NT = BR * TPR;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  T* KVs = reinterpret_cast<T*>(smem_raw + static_cast<size_t>(BR) * LDQ * sizeof(float));
  // stage s: K at KVs + (2s) * BK*LDK, V at KVs + (2s+1) * BK*LDK

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int t = tid % TPR;
  const int lane = tid & 31;
  const int g = blockIdx.y;
  const long long b = blockIdx.z;
  const int rep = H / KV;
  const int rows_total = Sq * rep;
  const int tile_lo = blockIdx.x * BR;

  const int q_off = q_offsets[b];
  const int q_len = q_lens[b];

  const int row = tile_lo + r;
  const bool row_in = row < rows_total;
  const int qi = row_in ? row / rep : 0;
  const int h = g * rep + (row_in ? row % rep : 0);
  const bool row_valid = row_in && qi < q_len;
  const int qp = q_off + qi;

  // the tile's key range: from its first in-window key to its last visible
  // key (block-uniform, so every lane runs the same number of tiles)
  const int qi_lo = tile_lo / rep;
  int qi_max = min(Sq - 1, (tile_lo + BR - 1) / rep);
  qi_max = min(qi_max, q_len - 1);
  int k_start = 0;
  int k_end = k_len;
  if (qi_max < qi_lo) {
    k_end = 0;
  } else {
    if (causal) k_end = min(k_len, q_off + qi_max + 1);
    if (window > 0) k_start = max(0, q_off + qi_lo - window + 1);
  }
  const int n_tiles = k_end > k_start ? (k_end - k_start + BK - 1) / BK : 0;

  // issue the asynchronous copies of key tile `it` into stage it & 1
  auto load_tile = [&](int it) {
    const int kt = k_start + it * BK;
    T* Kst = KVs + (2 * (it & 1)) * BK * LDK;
    T* Vst = Kst + BK * LDK;
    for (int e = tid; e < BK * CPR; e += NT) {
      const int j = e / CPR;
      const int c = e % CPR;
      const int kp = kt + j;
      const bool in = kp < k_end;
      // `in` first: no address (and no table entry) past the last visible key
      const long long off = in ? addr.row(b, kp, KV, g) * D + c * EPC : 0;
      cp_async16(Kst + j * LDK + c * EPC, k + off, in ? 16 : 0);
      cp_async16(Vst + j * LDK + c * EPC, v + off, in ? 16 : 0);
    }
    cp_async_commit();
  };

  if (n_tiles > 0) load_tile(0);

  for (int e = tid; e < BR * D; e += NT) {
    const int rr = e / D;
    const int dd = e % D;
    const int qrow = tile_lo + rr;
    float val = 0.f;
    if (qrow < rows_total) {
      const int qi_ = qrow / rep;
      const int h_ = g * rep + qrow % rep;
      val = to_f32(q[((b * Sq + qi_) * H + h_) * D + dd]);
    }
    Qs[rr * LDQ + dd] = val;
  }

  float m = NEG;
  float l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    // keep the next tile's copy in flight while this one is computed
    if (it + 1 < n_tiles) {
      load_tile(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile `it` (and, first time round, Q) visible to all
    const int kt = k_start + it * BK;
    const T* Kt = KVs + (2 * (it & 1)) * BK * LDK;
    const T* Vt = Kt + BK * LDK;

    float p[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) p[jj] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 2) {
      const float q0 = Qs[r * LDQ + dd];
      const float q1 = Qs[r * LDQ + dd + 1];
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const float2 kf = load2(Kt + (jj * TPR + t) * LDK + dd);
        p[jj] = fmaf(q0, kf.x, fmaf(q1, kf.y, p[jj]));
      }
    }
    unsigned visible = 0u;   // bit jj: key jj*TPR + t is visible to this row
    float mx = NEG;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int kp = kt + jj * TPR + t;
      float s = p[jj] * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      bool ok = row_valid && kp < k_end && kp < k_len;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      if (ok) visible |= 1u << jj;
      p[jj] = ok ? s : NEG;
      mx = fmaxf(mx, p[jj]);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      // a masked key contributes exactly 0, whatever the running max
      p[jj] = (visible >> jj) & 1u ? expf(p[jj] - m_new) : 0.f;
      sum += p[jj];
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;

    // P·V: thread t owns the dim pairs 2*(i*TPR + t), +1
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
#pragma unroll
      for (int tt = 0; tt < TPR; ++tt) {
        const float pj = __shfl_sync(0xffffffffu, p[jj], (lane & ~(TPR - 1)) | tt);
        const T* vrow = Vt + (jj * TPR + tt) * LDK;
#pragma unroll
        for (int i = 0; i < DPT / 2; ++i) {
          const float2 vf = load2(vrow + 2 * (i * TPR + t));
          acc[2 * i] = fmaf(pj, vf.x, acc[2 * i]);
          acc[2 * i + 1] = fmaf(pj, vf.y, acc[2 * i + 1]);
        }
      }
    }
    __syncthreads();   // every lane is done with this stage before it is refilled
  }

  if (row_in) {
    const float inv = row_valid ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    T* o = out + ((b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT / 2; ++i) {
      const int dd = 2 * (i * TPR + t);
      from_f32(row_valid ? acc[2 * i] * inv : 0.f, &o[dd]);
      from_f32(row_valid ? acc[2 * i + 1] * inv : 0.f, &o[dd + 1]);
    }
  }
}

template <typename T, int D, int BR, int TPR, typename Addr>
int launch(const void* q, const void* k, const void* v, void* out, const int* q_offsets,
           const int* q_lens, int B, int Sq, int H, Addr addr, int KV, float scale,
           int causal, int window, float softcap, int k_len, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D, BR>();
  auto kern = flash_fwd_kernel<T, D, BR, TPR, Addr>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows_total = Sq * (H / KV);
  dim3 grid((rows_total + BR - 1) / BR, KV, B);
  kern<<<grid, BR * TPR, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), q_offsets, q_lens, Sq, H, addr, KV, scale, causal, window, softcap,
      k_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, typename Addr>
int dispatch_rows(const void* q, const void* k, const void* v, void* out,
                  const int* q_offsets, const int* q_lens, int B, int Sq, int H, Addr addr,
                  int KV, float scale, int causal, int window, float softcap, int k_len,
                  cudaStream_t stream) {
  // decode batches carry only rep rows per (b, KV head): 4-row tiles with
  // 16 lanes a row keep every lane busy; prefill chunks take 64-row tiles
  // with 4 lanes a row.  A head dim that is not a multiple of 32 (80:
  // zamba2-2.7b) takes 8 lanes a decode row, so each lane owns whole dim
  // pairs (D % (2 * lanes) == 0)
  constexpr int DEC_TPR = D % 32 == 0 ? 16 : 8;
  if (Sq * (H / KV) <= 16)
    return launch<T, D, 4, DEC_TPR>(q, k, v, out, q_offsets, q_lens, B, Sq, H, addr, KV, scale,
                                    causal, window, softcap, k_len, stream);
  return launch<T, D, 64, 4>(q, k, v, out, q_offsets, q_lens, B, Sq, H, addr, KV, scale,
                             causal, window, softcap, k_len, stream);
}

// the instances built: head dim 64 (llama3.2-1b), 80 (zamba2-2.7b's shared
// attention) and 128 (qwen2-moe-a2.7b), each in fp32 and bf16; any other
// (D, dtype) returns cudaErrorInvalidValue
template <typename Addr>
int dispatch_head_dim(const void* q, const void* k, const void* v, void* out,
                      const int* q_offsets, const int* q_lens, int B, int Sq, int H, int D,
                      int dtype, Addr addr, int KV, float scale, int causal, int window,
                      float softcap, int k_len, cudaStream_t s) {
#define FLASH_INSTANCE(T, DIM)                                                                \
  return dispatch_rows<T, DIM>(q, k, v, out, q_offsets, q_lens, B, Sq, H, addr, KV, scale,    \
                               causal, window, softcap, k_len, s)
  if (D == 64 && dtype == 0) FLASH_INSTANCE(float, 64);
  if (D == 64 && dtype == 1) FLASH_INSTANCE(__nv_bfloat16, 64);
  if (D == 80 && dtype == 0) FLASH_INSTANCE(float, 80);
  if (D == 80 && dtype == 1) FLASH_INSTANCE(__nv_bfloat16, 80);
  if (D == 128 && dtype == 0) FLASH_INSTANCE(float, 128);
  if (D == 128 && dtype == 1) FLASH_INSTANCE(__nv_bfloat16, 128);
#undef FLASH_INSTANCE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  q_offsets
// and q_lens are device int32 [B].  window <= 0 and softcap <= 0 disable
// them.  Built for head dims 64 (llama3.2-1b), 80 (zamba2-2.7b) and 128
// (qwen2-moe-a2.7b); other head dims come with the configs that need them.  Returns a
// cudaError_t (0 = success); a shape the kernel does not take returns
// cudaErrorInvalidValue without launching.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   const int* q_offsets, const int* q_lens, int B, int Sq,
                                   int H, int Sk, int KV, int D, int dtype, float scale,
                                   int causal, int window, float softcap, int k_len,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || KV <= 0 || H % KV != 0 || k_len > Sk || k_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DenseKV addr{Sk};
  return dispatch_head_dim(q, k, v, out, q_offsets, q_lens, B, Sq, H, D, dtype, addr, KV,
                           scale, causal, window, softcap, k_len, s);
}

// The paged kernel: K/V read through `table` [B, pages_per_slot] (device
// int32, negative = unmapped: read as the trash page num_pages) from the
// pools pool_k/pool_v [num_pages_plus_1, P, KV, D]; the logical key axis is
// pages_per_slot·P long.  Everything else as flash_attention_fwd.  The
// caller keeps every non-negative entry below num_pages_plus_1.
extern "C" int flash_attention_paged_fwd(const void* q, const void* pool_k, const void* pool_v,
                                         const int* table, void* out, const int* q_offsets,
                                         const int* q_lens, int B, int Sq, int H, int KV, int D,
                                         int P, int pages_per_slot, int num_pages_plus_1,
                                         int dtype, float scale, int causal, int window,
                                         float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || KV <= 0 || H % KV != 0 || P <= 0 || pages_per_slot <= 0 ||
      num_pages_plus_1 <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PagedKV addr{table, pages_per_slot, P, num_pages_plus_1 - 1};
  const int k_len = pages_per_slot * P;
  return dispatch_head_dim(q, pool_k, pool_v, out, q_offsets, q_lens, B, Sq, H, D, dtype, addr,
                           KV, scale, causal, window, softcap, k_len, s);
}
