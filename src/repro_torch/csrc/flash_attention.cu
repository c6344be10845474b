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
// scores, softmax and sums are fp32, with the online-softmax recurrence
//   m' = max(m, rowmax(s));  l' = l e^{m-m'} + rowsum(e^{s-m'});
//   acc' = acc e^{m-m'} + e^{s-m'} v.
//
// Three kernels compute that function: a split-KV decode kernel for the
// few-row shapes, and two chunk tiles.  The chunk tiles are one block per
// (query-row tile, KV head, batch row), whose rows are (query position,
// head-in-group) pairs, so the `rep` query heads sharing one KV head read
// each K/V tile once — the TPU wrapper's per-group K/V broadcast and its
// 128-lane head-dim pad are layout choices of the TPU and are not copied;
// K/V are read straight from [B, Sk, KV, D] by stride.  Both walk 64-key tiles
// through two shared-memory stages: `cp.async` copies the next tile in
// 16-byte pieces, bypassing the registers, while the current one is
// computed, so the copy latency is paid once and not per element.  K/V
// stay in the input type in shared memory, rows padded by 16 bytes against
// bank conflicts.  The key loop starts at the tile's first in-window key
// and stops at its last visible key, q_offset + min(q_len, last row) - 1,
// so idle rows cost nothing and no unwritten cache slot is read.
//
// The bf16 chunk tile (`flash_fwd_mma_kernel`, Sq·rep over the decode
// kernel's rows) runs both products on the tensor cores, in the
// FlashAttention-2 shape.
//   Bound: a 64-token chunk does 64·rep query rows per key, at most 256
//   flops per byte of K/V (112 at the mixed-row shape chip_smoke.py times):
//   under the card's ~295 flop/byte bf16 ridge, so bytes bound it over the
//   whole grid.  But the grid is small (8 rows × KV heads: 128–256 blocks)
//   and the deepest row's block walks its ~32 key tiles in order on one SM,
//   so that block's arithmetic sets the pace; on the fp32 CUDA cores (the
//   old tile) it ran at a fifth of one SM's fp32 rate.
//   Design: 64 rows, 4 warps of 16 rows (128 threads).  Q is copied to
//   shared memory once as bf16 (`cp.async`, with key tile 0) and each warp
//   keeps its D/16 A-fragments in registers (`ldmatrix.x4`), or at D 256,
//   where O's 128 fp32 registers a lane leave no room for them, reads each
//   k-step's fragment from that tile again (169 KB of shared memory: one
//   block an SM).  S = Q·Kᵀ is
//   `mma.sync.m16n8k16` bf16 with fp32 accumulators, K's B-fragments
//   straight from the padded rows by `ldmatrix` (row strides of 144, 176,
//   272 and 528 bytes put the 8 rows of each read on 8 distinct groups of
//   four banks: no swizzle).  Scale, softcap and the softmax run in fp32 on the
//   accumulators, in log2 units so each exponential is one `ex2.approx`;
//   each row's max and sum are reduced over the quad of lanes that owns it.
//   The masks are applied only on a warp's boundary tiles, as one key range
//   [lo, hi) a row.  P is packed to bf16 pairs in registers — an m16n8
//   accumulator pair is already the A-fragment of the next m16n8k16 — and
//   P·V takes V's B-fragments by `ldmatrix.trans`; O stays fp32 in
//   registers (D/8 n-tiles).  One barrier a key tile: after it, the stage
//   of the previous tile is refilled while this one is computed.  A warp
//   whose 16 rows are all invalid, or that sees none of a key tile, skips
//   that tile's products and softmax (an all-masked tile leaves m, l and O
//   exactly as they were) but still issues its copies and reaches every
//   barrier.  A deep row's block is alone on its SM, one warp to each
//   scheduler, so the tile is paced by the latency of that warp's chain of
//   products and softmax, not by the copies (a deeper ring does not help).
//   No wgmma, TMA, warp specialisation or split-KV yet.
//   Rounding: P is rounded to bf16 for P·V only (`l` sums the fp32
//   probabilities), where the old tile and the reference keep P in fp32;
//   tests/test_torch_kernels.py bounds the difference with a plain model of
//   this arithmetic, well inside the bf16 tolerance.
//
// The split-KV decode kernel (`flash_fwd_decode_kernel`, then
// `flash_fwd_decode_merge_kernel`) takes every call with Sq·rep <= 16 rows
// per (batch row, KV head), 8 at D 256 (`dec_rows`): decode steps, and
// short query runs with few heads, in fp32 and bf16, dense and paged.
//   Bound: bytes.  A decode row reads its cache up to its depth once and
//   does ~4 flops per key element for each of its `rep` query heads; at
//   chip_smoke.py's decode shape the bound is a few microseconds, so what
//   sets the time is how many bytes are in flight and how many SMs work.
//   Design (FlashDecoding): the key axis is cut at fixed absolute positions
//   into splits of L keys (`dec_split`: 256, 128 or 64 as a K row takes at
//   most 128, 512 or more bytes); split s covers keys
//   [s·L, (s+1)·L) of the (b, g) group's range.  The grid is (k_len / L,
//   KV, B), so a deep row spreads over many SMs; a block whose split misses
//   the group's range returns at once.  A block (128 threads, 4 warps) holds
//   all Sq·rep rows of its group, so one read of a K/V row serves every
//   query head of the group.  It issues the copies of ALL its L/64 key
//   tiles at once, one `cp.async` stage each (68 KB in flight at bf16
//   D 128, 132 KB at D 256), after one pass that computes the tiles'
//   key-row offsets into shared
//   memory (a paged row's one table read, division and remainder, not one
//   per 16-byte copy).  Each warp owns 16 keys of every tile and keeps its
//   own online softmax: two lanes a key score it over half the dims each
//   (K in 16-byte pieces, Q in fp32 from shared memory, every row's dot
//   product in registers), one shuffle joins the halves, four give the
//   warp's row max; P goes through shared memory, and P·V runs with dim
//   pairs over lanes (2·32·ceil(D/64) >= D: a static_assert refuses an
//   instance that would drop a dim, as 16 lanes of 5 dims at D 80 once
//   would have).  At the end the four warps' (m, l, O) merge in shared
//   memory in a fixed order.
//   A group whose range lies in one split writes its output there; else
//   each split writes fp32 (m, l, O[D]) per row to a workspace the wrapper
//   allocates, and the merge kernel, launched by the same entry point on
//   the same stream, combines splits s0..s1 with weights 2^(m_s - M).
//   Scores, softmax, l and O are fp32 in both types (P is not rounded).
//   The split boundaries depend on neither k_len nor the card, and no sum
//   uses atomics, so dense and paged at the same depths, and two launches,
//   give the same bits.
//
// The old tile (`flash_fwd_kernel`) keeps fp32 chunks (Sq·rep over the
// decode kernel's rows), whose token-identity checks need fp32 products
// (TF32 or bf16 would break them), on the fp32 CUDA cores.  Q is held in
// fp32 in shared memory and K/V are read as pairs of elements; four lanes
// own one of the tile's 64 query rows: each scores a quarter of a key
// tile and accumulates D/4 output dims (a static_assert holds every
// instance to whole dim pairs a lane).  The key tile is 64 keys, 32 at
// D 256 (`ct_bk`), where 64 would overflow shared memory.  Row max and
// sum are reduced across a row's lanes with shuffles, and the
// probabilities are exchanged by shuffle for the P·V product.
//
// Paged K/V.  One kernel body, two ways to address a key row: the address
// of key kp of batch row b, KV head g, is a template policy.  `DenseKV`
// reads row (b, kp) of k/v [B, Sk, KV, D]; `PagedKV` reads the pools
// [num_pages+1, P, KV, D] at page table[b, kp / P], row kp % P, with a
// negative (unmapped) entry read as the trash page num_pages, as the TPU
// wrapper clamps it.  The logical key axis is pages_per_slot·P long and the
// softmax, masks, tiles and key-range trimming are the dense kernel's, so
// both compute the same function in the same order.  Every kernel tests
// that a key is in the block's range before it reads the table, so no
// entry past a row's last visible key is read and a tile that straddles
// into unmapped pages copies zeros.  The 16-byte copies are per key row, so
// any page size P >= 1 works: a 64-key tile need not line up with pages
// (the TPU kernel pins its key block to P; that is a choice of its DMA,
// not copied).
//
// Paged bound: bytes, the same mapped K/V bytes as dense at the same depths
// plus the table entries read (one int32 per page a tile touches, 4 bytes
// per P·KV·D·2 K/V bytes, under 0.01% at P = 64).  In the two chunk tiles
// the table read costs an integer division and one cached 4-byte load per
// 16-byte copy (the loads of one key row hit the same entry in L1); the
// decode kernel does it once a key row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr float NEG = -1e30f;   // masked score (matches the TPU kernel)

__device__ __forceinline__ float to_f32(float v) { return v; }
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

// 2^x on the special-function unit: one instruction, results below 2^-126
// flushed to 0 (so 2^(NEG - m) is exactly 0 for any finite m)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// programmatic dependent launch: let the grid launched after this one on
// the stream start now, and (in that grid) wait until this one's memory is
// complete and visible; both are no-ops without the launch attribute
__device__ __forceinline__ void pdl_trigger() { asm volatile("griddepcontrol.launch_dependents;\n" ::); }
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// two floats rounded to one bf16 pair, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

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

// The key range (the tensor-core tile and the decode kernels) and the tile
// copy (the tensor-core tile).  `flash_fwd_kernel` keeps its own inline
// copies of both, as it was measured.

// the keys [start, end) that the tile rows row_lo..row_hi of one batch row
// may see: from the first row's first in-window key to the last valid
// row's last visible key; end = 0 when no row of the range is valid
struct KeyRange {
  int start, end;
};
__device__ __forceinline__ KeyRange key_range(int row_lo, int row_hi, int rep, int Sq, int q_off,
                                              int q_len, int causal, int window, int k_len) {
  const int qi_lo = row_lo / rep;
  int qi_max = min(Sq - 1, row_hi / rep);
  qi_max = min(qi_max, q_len - 1);
  KeyRange r{0, k_len};
  if (qi_max < qi_lo) {
    r.end = 0;
  } else {
    if (causal) r.end = min(k_len, q_off + qi_max + 1);
    if (window > 0) r.start = max(0, q_off + qi_lo - window + 1);
  }
  return r;
}

// issue the asynchronous copies of the BK-key tile that starts at key kt
// into one stage (K rows at Kst, V rows at Vst, LDK elements apart), by NT
// threads; keys at or past k_end are filled with zeros
template <typename T, int D, int NT, typename Addr>
__device__ __forceinline__ void load_kv_tile(T* Kst, T* Vst, const T* k, const T* v,
                                             const Addr& addr, long long b, int g, int KV, int kt,
                                             int k_end, int tid) {
  constexpr int LDK = D + 16 / sizeof(T);   // K/V row in elements, padded 16 bytes
  constexpr int EPC = 16 / sizeof(T);       // elements per 16-byte copy
  constexpr int CPR = D / EPC;              // copies per key row
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
}

// the fp32 chunk tile: CT_BR query rows per block, CT_TPR lanes per row
constexpr int CT_BR = 64;
constexpr int CT_TPR = 4;

// its key tile: 64 keys, or 32 at D 256, where two stages of 64 fp32 K
// and V rows (266 KB) would not fit a block's 227 KB of shared memory
template <int D>
__host__ __device__ constexpr int ct_bk() {
  return D > 128 ? 32 : BK;
}

// shared memory: Q tile in fp32 [BR][D+1], then two stages of K and V tiles,
// rows padded by 16 bytes against bank conflicts (199 KB at D 256)
template <int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(CT_BR) * (D + 1) * sizeof(float) +
         4ull * ct_bk<D>() * (D + 16 / sizeof(float)) * sizeof(float);
}

// fp32 only; Addr is DenseKV or PagedKV
template <int D, typename Addr>
__global__ void __launch_bounds__(CT_BR * CT_TPR)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 const int* __restrict__ q_offsets, const int* __restrict__ q_lens, int Sq, int H,
                 Addr addr, int KV, float scale, int causal, int window, float softcap,
                 int k_len) {
  using T = float;
  constexpr int BR = CT_BR;                 // query rows per block
  constexpr int TPR = CT_TPR;               // lanes per row (a power of two <= 32)
  constexpr int BK = ct_bk<D>();            // keys per tile (shadows the 64 of the others)
  // each lane owns DPT/2 dim pairs 2*(i*TPR + t): D must split into whole
  // pairs per lane, or the dims past the last pair are never accumulated
  // nor written
  static_assert(D % (2 * TPR) == 0, "head dim must be a multiple of 2 * lanes per row");
  static_assert(BK % TPR == 0, "key tile must split evenly over a row's lanes");
  constexpr int KPT = BK / TPR;             // keys scored per thread per tile
  static_assert(KPT <= 32, "the visible-key mask is one 32-bit word");
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

// ------------------------------------------------------- bf16 chunk tile
constexpr int MMA_BR = 64;      // tile rows per block: 4 warps of 16
constexpr int MMA_NT = 128;

// shared memory: the Q tile, then two stages of K and V tiles, all bf16
// rows of D + 8 elements (16 bytes of pad)
template <int D>
constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(MMA_BR + 4 * BK) * (D + 8) * sizeof(__nv_bfloat16);
}

template <int D, typename Addr>
__global__ void __launch_bounds__(MMA_NT)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     const int* __restrict__ q_offsets, const int* __restrict__ q_lens, int Sq,
                     int H, Addr addr, int KV, float scale, int causal, int window,
                     float softcap, int k_len) {
  using T = __nv_bfloat16;
  static_assert(D % 16 == 0, "head dim must be a multiple of the mma depth, 16");
  constexpr int LD = D + 8;          // shared row in elements
  constexpr int KSTEPS = D / 16;     // k-steps of Q·Kᵀ
  constexpr int NS = BK / 8;         // n-tiles of S (8 keys each)
  constexpr int NO = D / 8;          // n-tiles of O (8 dims each)
  // at D 256, O alone is 128 fp32 registers a lane and Q's fragments would
  // be 64 more: Q's A-fragments are then read from shared memory at each
  // k-step (the Q tile is never overwritten) and not held in registers
  constexpr bool Q_REGS = D <= 128;
  constexpr int QREG = Q_REGS ? KSTEPS : 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* KVs = Qs + MMA_BR * LD;
  // stage s: K at KVs + (2s) * BK*LD, V at KVs + (2s+1) * BK*LD

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;         // fragment row (and +8)
  const int tq = lane & 3;          // fragment column pair
  const int g = blockIdx.y;
  const long long b = blockIdx.z;
  const int rep = H / KV;
  const int rows_total = Sq * rep;
  const int tile_lo = blockIdx.x * MMA_BR;
  const int w_lo = tile_lo + 16 * warp;

  const int q_off = q_offsets[b];
  const int q_len = q_lens[b];

  // the block's key range (every warp copies and waits on every tile) and
  // the warp's own (it computes only the tiles it can see)
  const KeyRange kr =
      key_range(tile_lo, tile_lo + MMA_BR - 1, rep, Sq, q_off, q_len, causal, window, k_len);
  const KeyRange wr = key_range(w_lo, w_lo + 15, rep, Sq, q_off, q_len, causal, window, k_len);
  const int k_start = kr.start;
  const int k_end = kr.end;
  const int n_tiles = k_end > k_start ? (k_end - k_start + BK - 1) / BK : 0;

  // issue the asynchronous copies of key tile `it` into stage it & 1
  auto load_tile = [&](int it) {
    T* Kst = KVs + (2 * (it & 1)) * BK * LD;
    load_kv_tile<T, D, MMA_NT>(Kst, Kst + BK * LD, k, v, addr, b, g, KV, k_start + it * BK,
                               k_end, tid);
  };

  // Q's rows in 16-byte pieces (zeros past the last row), in one copy
  // group with key tile 0
  if (n_tiles > 0) {
    for (int e = tid; e < MMA_BR * (D / 8); e += MMA_NT) {
      const int rr = e / (D / 8);
      const int c = e % (D / 8);
      const int qrow = tile_lo + rr;
      const bool in = qrow < rows_total;
      const long long off =
          in ? ((b * Sq + qrow / rep) * H + g * rep + qrow % rep) * D + c * 8 : 0;
      cp_async16(Qs + rr * LD + c * 8, q + off, in ? 16 : 0);
    }
    load_tile(0);
  }

  // the two rows this lane owns in every fragment, w_lo + gr and + 8: the
  // keys [lo, hi) each sees (empty for an invalid row)
  int lo[2], hi[2];
  bool row_in[2], row_valid[2];
  long long o_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w_lo + gr + 8 * i;
    row_in[i] = row < rows_total;
    const int qi = row_in[i] ? row / rep : 0;
    const int h = g * rep + (row_in[i] ? row % rep : 0);
    row_valid[i] = row_in[i] && qi < q_len;
    const int qp = q_off + qi;
    lo[i] = window > 0 ? qp - window + 1 : 0;
    hi[i] = row_valid[i] ? (causal ? min(k_end, qp + 1) : k_end) : 0;
    o_off[i] = ((b * Sq + qi) * H + h) * D;
  }
  // a key tile inside [int_lo, int_hi) is seen whole by every row of a
  // warp whose 16 rows are all valid: no mask there
  const int qw_lo = w_lo / rep;
  const int qw_hi = (w_lo + 15) / rep;
  const bool warp_full = w_lo + 15 < rows_total && qw_hi < q_len;
  const int int_lo = window > 0 ? q_off + qw_hi - window + 1 : 0;
  const int int_hi = causal ? min(k_end, q_off + qw_lo + 1) : k_end;
  // scores are kept in log2 units, s = x log2 e, so 2^(s - m) = e^(x - m / log2 e)
  constexpr float LOG2E = 1.4426950408889634f;
  const float scale_log2 = scale * LOG2E;
  const float cap_log2 = softcap * LOG2E;
  const float scale_over_cap = softcap > 0.f ? scale / softcap : 0.f;

  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};   // this lane's share of the row sums
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  // the warp's Q A-fragments, one per k-step: matrices (rows 0-7, k 0-7),
  // (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15) of its 16 rows
  const T* q_frag = Qs + (16 * warp + (lane & 15)) * LD + (lane >> 4) * 8;
  unsigned qa[QREG][4];
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    // tile `it` (and Q) visible to all, and every warp done with tile
    // it - 1, whose stage the next copy refills while this one is computed
    __syncthreads();
    if (it + 1 < n_tiles) load_tile(it + 1);
    if constexpr (Q_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(qa[kk], q_frag + kk * 16);
      }
    }
    const int kt = k_start + it * BK;
    const T* Kt = KVs + (2 * (it & 1)) * BK * LD;
    const T* Vt = Kt + BK * LD;

    // warp-uniform: skipping an all-masked tile changes nothing, since it
    // would leave m, l and o exactly as they are
    if (kt < wr.end && kt + BK > wr.start) {
      // S = Q Kᵀ: n-tiles 2np and 2np+1 from one ldmatrix.x4 of K rows
      // (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d 0-7), (8-15, 8-15)
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int qk = Q_REGS ? kk : 0;
        if constexpr (!Q_REGS) ldmatrix_x4(qa[0], q_frag + kk * 16);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          unsigned kb[4];
          ldmatrix_x4(kb, Kt + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16_16816(s[2 * np], qa[qk], kb[0], kb[1]);
          mma_bf16_16816(s[2 * np + 1], qa[qk], kb[2], kb[3]);
        }
      }

      // scale and softcap in fp32, in log2 units (one uniform branch); the
      // masks only on a boundary tile.  Element e of n-tile j is row
      // gr + 8 (e >> 1), key kt + 8 j + 2 tq + (e & 1)
      if (softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = cap_log2 * tanhf(s[j][e] * scale_over_cap);
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
      }
      if (!(warp_full && kt >= int_lo && kt + BK <= int_hi)) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kt + 8 * j + 2 * tq + (e & 1);
            if (kp < lo[e >> 1] || kp >= hi[e >> 1]) s[j][e] = NEG;
          }
      }
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float alpha[2], m_sub[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // the quad of lanes 4 gr .. 4 gr + 3 holds the row's 64 keys
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = fast_exp2(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
        // a masked key (NEG) contributes exactly 0: against a finite running
        // max, and against none yet, where 0 is subtracted instead
        m_sub[i] = m_new == NEG ? 0.f : m_new;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = fast_exp2(s[j][e] - m_sub[e >> 1]);
          l[e >> 1] += s[j][e];
        }
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }

      // O += P V: P's n-tiles 2kk and 2kk+1, rounded to bf16, are the
      // A-fragment of k-step kk; V's B-fragments by ldmatrix.trans of V rows
      // (keys 0-7, d 0-7), (keys 8-15, d 0-7), (keys 0-7, d 8-15), (8-15, 8-15)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const unsigned pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          unsigned vb[4];
          ldmatrix_x4_trans(vb, Vt + (16 * kk + (lane & 15)) * LD + 16 * dp + (lane >> 4) * 8);
          mma_bf16_16816(o[2 * dp], pa, vb[0], vb[1]);
          mma_bf16_16816(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_in[i]) continue;
    const float inv = row_valid[i] ? 1.f / fmaxf(l[i], 1e-30f) : 0.f;
    T* orow = out + o_off[i];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const float x0 = row_valid[i] ? o[j][2 * i] * inv : 0.f;
      const float x1 = row_valid[i] ? o[j][2 * i + 1] * inv : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * tq) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

// ------------------------------------------------------- split-KV decode
constexpr int DEC_NT = 128;           // threads a block
constexpr int DEC_NW = DEC_NT / 32;   // warps: each owns 16 keys of every tile
constexpr int DEC_ROWS = 16;          // most rows (Sq·rep) a decode block holds

// keys per split: the block's L / BK tiles are all in flight at once, one
// shared-memory stage each.  256 keys where a K row is at most 128 bytes
// (bf16 at D 64: a 72 KiB ring, two or three blocks an SM), 128 where it
// is at most 512 (bf16 at D 80, 128 and 256: rings of 44, 68 and 132 KiB;
// fp32 up to 130 KiB), else 64 (fp32 at D 256: one 130 KiB stage, where
// 128 keys would need 260 KiB).  A 256-key ring at bf16 D 128 (136 KiB)
// left one block an SM and decoded slower on an H100
template <typename T, int D>
__host__ __device__ constexpr int dec_split() {
  return D * sizeof(T) <= 128 ? 256 : D * sizeof(T) <= 512 ? 128 : 64;
}

// the most rows (Sq·rep) a decode block holds at head dim D: 16, or 8 at
// D 256, where 16 rows' O (16 x 8 dim pairs a lane) alone would be 128
// fp32 registers a thread and the block would spill; 9-16 rows at D 256
// take the chunk tiles, which compute the same function
template <int D>
__host__ __device__ constexpr int dec_rows() {
  return D > 128 ? 8 : DEC_ROWS;
}

// shared memory: the ring of K and V stages in the input type (rows padded
// by 16 bytes), Q in fp32 [RMAX][D], each warp's P [16 keys][RMAX], and the
// element offsets of the split's key rows
template <typename T, int D>
__host__ __device__ constexpr size_t dec_ring_bytes() {
  return static_cast<size_t>(dec_split<T, D>() / BK) * 2 * BK * (D + 16 / sizeof(T)) * sizeof(T);
}
template <typename T, int D, int RMAX>
constexpr size_t dec_smem_bytes() {
  return dec_ring_bytes<T, D>() + static_cast<size_t>(RMAX) * D * sizeof(float) +
         static_cast<size_t>(DEC_NW) * 16 * RMAX * sizeof(float) +
         static_cast<size_t>(dec_split<T, D>()) * sizeof(long long);
}

// the splits s0..s1 that meet the (b, g) group's key range; a group that
// sees no key has the one empty split 0
struct SplitRange {
  int s0, s1;
};
__device__ __forceinline__ SplitRange split_range(const KeyRange& kr, int L) {
  if (kr.end <= kr.start) return {0, 0};
  return {kr.start / L, (kr.end - 1) / L};
}

// wait until at most n copy groups are pending (n <= 3)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// 16 bytes of a shared-memory row as floats
__device__ __forceinline__ void load_piece(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load_piece(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = y.x;
    f[2 * i + 1] = y.y;
  }
}

// One block per (split, KV head, batch row): the partial softmax of all
// rows of the group over the split's keys.  RMAX >= Sq·rep is the rows the
// registers hold (1, 4 or 16; 1 or 8 at D 256).  ws_o [B, KV, nsplit,
// rows, D] and ws_ml [B, KV, nsplit, rows] take the partials of a group
// with several splits.
template <typename T, int D, int RMAX, typename Addr>
__global__ void __launch_bounds__(DEC_NT)
flash_fwd_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        T* __restrict__ out, float* __restrict__ ws_o, float2* __restrict__ ws_ml,
                        const int* __restrict__ q_offsets, const int* __restrict__ q_lens, int Sq,
                        int H, Addr addr, int KV, float scale, int causal, int window,
                        float softcap, int k_len) {
  constexpr int L = dec_split<T, D>();
  constexpr int NSTAGE = L / BK;
  constexpr int LDK = D + 16 / sizeof(T);   // K/V row in elements, padded 16 bytes
  constexpr int EPC = 16 / sizeof(T);       // elements per 16-byte piece
  constexpr int CPR = D / EPC;              // pieces per key row
  constexpr int HALF = D / 2;               // dims each of a key's two lanes scores
  constexpr int HPC = HALF / EPC;           // pieces per half row
  constexpr int NPL = (HALF + 31) / 32;     // dim pairs a lane accumulates in P·V
  static_assert(L % BK == 0 && NSTAGE >= 1 && NSTAGE <= 4, "a split is 1-4 key tiles");
  static_assert(2 * HPC * EPC == D, "the two halves must score every dim in whole pieces");
  static_assert(32 * NPL * 2 >= D, "P·V must accumulate every dim");
  static_assert(RMAX == 1 || RMAX % 4 == 0, "P rows are read as float4");
  static_assert(RMAX <= dec_rows<D>(), "more rows than the registers of this head dim hold");
  static_assert(static_cast<size_t>(DEC_NW) * RMAX * (D + 2) * sizeof(float) <=
                    dec_ring_bytes<T, D>(),
                "the warps' partials must fit in the ring they reuse");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);   // stage i: K at 2i·BK·LDK, V after it
  float* Qs = reinterpret_cast<float*>(smem_raw + dec_ring_bytes<T, D>());
  float* Ps = Qs + RMAX * D;
  long long* koff = reinterpret_cast<long long*>(Ps + DEC_NW * 16 * RMAX);

  pdl_trigger();   // the merge grid may launch; it waits for this one's end
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int jj = lane & 15;    // the lane's key among its warp's 16 of a tile
  const int hh = lane >> 4;    // the half of the dims it scores
  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const long long b = blockIdx.z;
  const int rep = H / KV;
  const int rows = Sq * rep;
  const int q_off = q_offsets[b];
  const int q_len = q_lens[b];

  const KeyRange kr = key_range(0, rows - 1, rep, Sq, q_off, q_len, causal, window, k_len);
  const SplitRange sr = split_range(kr, L);
  if (s < sr.s0 || s > sr.s1) return;       // block-uniform: the split misses the range
  const int lo_blk = max(kr.start, s * L);
  const int hi_blk = min(kr.end, (s + 1) * L);
  const int t0 = lo_blk & ~(BK - 1);         // tiles at absolute multiples of BK
  const int n_tiles = hi_blk > lo_blk ? (hi_blk - t0 + BK - 1) / BK : 0;

  // every key row's element offset, once (a paged row's one table read);
  // -1 outside [lo_blk, hi_blk), tested before the table is read
  for (int j = tid; j < n_tiles * BK; j += DEC_NT) {
    const int kp = t0 + j;
    koff[j] = kp >= lo_blk && kp < hi_blk ? addr.row(b, kp, KV, g) * D : -1;
  }
  __syncthreads();   // the offsets visible to every copying thread

  // the copies of every tile of the split, one group each (always NSTAGE
  // groups, so the waits below count the same in every block)
#pragma unroll
  for (int i = 0; i < NSTAGE; ++i) {
    if (i < n_tiles) {
      T* Kst = ring + 2 * i * BK * LDK;
      T* Vst = Kst + BK * LDK;
      for (int e = tid; e < BK * CPR; e += DEC_NT) {
        const int j = e / CPR;
        const int c = e % CPR;
        const long long off = koff[i * BK + j];
        const bool in = off >= 0;
        cp_async16(Kst + j * LDK + c * EPC, k + (in ? off + c * EPC : 0), in ? 16 : 0);
        cp_async16(Vst + j * LDK + c * EPC, v + (in ? off + c * EPC : 0), in ? 16 : 0);
      }
    }
    cp_async_commit();
  }
  // Q rows in fp32, zeros past the last row, read while the copies fly
  // (the first tile's barrier makes them visible)
  for (int e = tid; e < RMAX * CPR; e += DEC_NT) {
    const int r = e / CPR;
    const int c = e % CPR;
    float f[EPC];
    if (r < rows) {
      load_piece(q + ((b * Sq + r / rep) * H + g * rep + r % rep) * D + c * EPC, f);
    } else {
#pragma unroll
      for (int i = 0; i < EPC; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < EPC; i += 4)
      *reinterpret_cast<float4*>(Qs + r * D + c * EPC + i) = make_float4(f[i], f[i + 1], f[i + 2],
                                                                         f[i + 3]);
  }

  // each row's visible keys [lo, hi) (empty for a row past rows or q_len)
  int lo[RMAX], hi[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int qi = r / rep;
    const bool valid = r < rows && qi < q_len;
    const int qp = q_off + qi;
    lo[r] = window > 0 ? qp - window + 1 : 0;
    hi[r] = valid ? (causal ? min(kr.end, qp + 1) : kr.end) : 0;
  }
  // scores in log2 units, s = x log2 e, so 2^(s - m) = e^(x - m / log2 e)
  constexpr float LOG2E = 1.4426950408889634f;
  const float scale_log2 = scale * LOG2E;
  const float cap_log2 = softcap * LOG2E;
  const float scale_over_cap = softcap > 0.f ? scale / softcap : 0.f;

  float m[RMAX], l[RMAX], o[RMAX][NPL][2];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m[r] = NEG;
    l[r] = 0.f;   // this lane's share: the terms of its keys
#pragma unroll
    for (int i = 0; i < NPL; ++i) o[r][i][0] = o[r][i][1] = 0.f;
  }
  float* Pw = Ps + warp * 16 * RMAX;
  const float* qh = Qs + hh * HALF;

#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_upto(NSTAGE - 1 - it);   // this thread's copies of tile `it` landed
    __syncthreads();                       // and everyone else's (and Q, first time round)
    const T* Kt = ring + 2 * it * BK * LDK;
    const T* Vt = Kt + BK * LDK;
    const int kw = 16 * warp;              // the warp's first key in the tile
    const int kp = t0 + it * BK + kw + jj;

    // this lane's half of key kw + jj's dot product with every row
    float sc[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) sc[r] = 0.f;
    const T* krow = Kt + (kw + jj) * LDK + hh * HALF;
#pragma unroll
    for (int c = 0; c < HPC; ++c) {
      float kf[EPC];
      load_piece(krow + c * EPC, kf);
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
#pragma unroll
        for (int i = 0; i < EPC; i += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qh + r * D + c * EPC + i);
          sc[r] = fmaf(qv.x, kf[i], sc[r]);
          sc[r] = fmaf(qv.y, kf[i + 1], sc[r]);
          sc[r] = fmaf(qv.z, kf[i + 2], sc[r]);
          sc[r] = fmaf(qv.w, kf[i + 3], sc[r]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      // both lanes of the key add the same two halves: the same bits
      float x = sc[r] + __shfl_xor_sync(0xffffffffu, sc[r], 16);
      if (softcap > 0.f)
        x = cap_log2 * tanhf(x * scale_over_cap);
      else
        x *= scale_log2;
      if (kp < lo[r] || kp >= hi[r]) x = NEG;
      // the row's max over the warp's 16 keys (lanes 16-31 mirror 0-15)
      float mx = x;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = fast_exp2(m[r] - m_new);
      // a masked key (NEG) contributes exactly 0: against a finite running
      // max, and against none yet, where 0 is subtracted instead
      const float p = fast_exp2(x - (m_new == NEG ? 0.f : m_new));
      m[r] = m_new;
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        o[r][i][0] *= alpha;
        o[r][i][1] *= alpha;
      }
      sc[r] = p;
    }
    if (hh == 0) {
      if constexpr (RMAX == 1) {
        Pw[jj] = sc[0];
      } else {
#pragma unroll
        for (int r = 0; r < RMAX; r += 4)
          *reinterpret_cast<float4*>(Pw + jj * RMAX + r) =
              make_float4(sc[r], sc[r + 1], sc[r + 2], sc[r + 3]);
      }
    }
    __syncwarp();

    // O += P V over the warp's 16 keys: the lane owns dim pairs lane + 32 i
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const T* vrow = Vt + (kw + j) * LDK;
      float pj[RMAX];
      if constexpr (RMAX == 1) {
        pj[0] = Pw[j];
      } else {
#pragma unroll
        for (int r = 0; r < RMAX; r += 4) {
          const float4 x = *reinterpret_cast<const float4*>(Pw + j * RMAX + r);
          pj[r] = x.x;
          pj[r + 1] = x.y;
          pj[r + 2] = x.z;
          pj[r + 3] = x.w;
        }
      }
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int dp = lane + 32 * i;
        if (dp < HALF) {
          const float2 vf = load2(vrow + 2 * dp);
#pragma unroll
          for (int r = 0; r < RMAX; ++r) {
            o[r][i][0] = fmaf(pj[r], vf.x, o[r][i][0]);
            o[r][i][1] = fmaf(pj[r], vf.y, o[r][i][1]);
          }
        }
      }
    }
    __syncwarp();   // every lane has read P before the next tile rewrites it
  }

  // the warp's row sums: its 16 key lanes' shares
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 4);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 8);
  }
  __syncthreads();   // every warp is done with the ring: it now takes their partials
  float* Os = reinterpret_cast<float*>(smem_raw);   // [NW][RMAX][D]
  float* Ms = Os + DEC_NW * RMAX * D;               // [NW][RMAX]
  float* Ls = Ms + DEC_NW * RMAX;
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int dp = lane + 32 * i;
      if (dp < HALF)
        *reinterpret_cast<float2*>(Os + (warp * RMAX + r) * D + 2 * dp) =
            make_float2(o[r][i][0], o[r][i][1]);
    }
    if (lane == 0) {
      Ms[warp * RMAX + r] = m[r];
      Ls[warp * RMAX + r] = l[r];
    }
  }
  __syncthreads();

  // the warps merged in order; the group's output when this is its only
  // split, else this split's partial
  const bool single = sr.s0 == sr.s1;
  const long long part = ((b * KV + g) * gridDim.x + s) * rows;
  for (int e = tid; e < rows * D; e += DEC_NT) {
    const int r = e / D;
    const int d = e % D;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < DEC_NW; ++w) M = fmaxf(M, Ms[w * RMAX + r]);
    const float m_sub = M == NEG ? 0.f : M;
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_NW; ++w) {
      const float a = fast_exp2(Ms[w * RMAX + r] - m_sub);
      lsum += a * Ls[w * RMAX + r];
      acc += a * Os[(w * RMAX + r) * D + d];
    }
    if (single) {
      const int qi = r / rep;
      const bool valid = qi < q_len;
      const float inv = valid ? 1.f / fmaxf(lsum, 1e-30f) : 0.f;
      from_f32(valid ? acc * inv : 0.f, &out[((b * Sq + qi) * H + g * rep + r % rep) * D + d]);
    } else {
      ws_o[(part + r) * D + d] = acc;
      if (d == 0) ws_ml[part + r] = make_float2(M, lsum);
    }
  }
}

// One block per (KV head, batch row): combine the partials of splits
// s0..s1 of a group that has several, in order, into the output; rows past
// q_len are written as zeros.  A group with one split was written by it.
// Launched as a programmatic dependent of the decode kernel: its blocks
// start while the decode grid drains, read what the decode kernel does not
// write, and wait (griddepcontrol.wait) before they read the partials.
// One thread a row takes the row's max and sum over the splits; the
// weights 2^(m_s - M) of MERGE_CHUNK splits at a time go to shared memory,
// and each thread sums O over the splits for its output elements.
constexpr int MERGE_CHUNK = 32;

template <typename T, int D>
__global__ void __launch_bounds__(DEC_NT)
flash_fwd_decode_merge_kernel(T* __restrict__ out, const float* __restrict__ ws_o,
                              const float2* __restrict__ ws_ml, const int* __restrict__ q_offsets,
                              const int* __restrict__ q_lens, int Sq, int H, int KV, int causal,
                              int window, int k_len, int nsplit) {
  constexpr int R = dec_rows<D>();                      // most rows of a group
  constexpr int EPT = (R * D + DEC_NT - 1) / DEC_NT;    // output elements a thread
  __shared__ float wts[MERGE_CHUNK * R];
  __shared__ float m_row[R], inv_row[R];
  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const long long b = blockIdx.y;
  const int rep = H / KV;
  const int rows = Sq * rep;
  const int q_len = q_lens[b];
  const KeyRange kr =
      key_range(0, rows - 1, rep, Sq, q_offsets[b], q_len, causal, window, k_len);
  const SplitRange sr = split_range(kr, dec_split<T, D>());
  if (sr.s0 == sr.s1) return;
  pdl_wait();   // the decode grid's partials are complete and visible
  const int n = sr.s1 - sr.s0 + 1;
  const long long part = ((b * KV + g) * nsplit + sr.s0) * rows;
  const float2* ml = ws_ml + part;              // [n][rows]
  const float* os = ws_o + part * D;            // [n][rows][D]
  if (tid < rows) {
    float M = NEG;
    for (int s = 0; s < n; ++s) M = fmaxf(M, ml[s * rows + tid].x);
    const float m_sub = M == NEG ? 0.f : M;
    float lsum = 0.f;
    for (int s = 0; s < n; ++s) {
      const float2 x = ml[s * rows + tid];
      lsum += fast_exp2(x.x - m_sub) * x.y;
    }
    m_row[tid] = m_sub;
    inv_row[tid] = tid / rep < q_len ? 1.f / fmaxf(lsum, 1e-30f) : 0.f;
  }
  float acc[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc[i] = 0.f;
  for (int c0 = 0; c0 < n; c0 += MERGE_CHUNK) {
    const int cn = min(MERGE_CHUNK, n - c0);
    __syncthreads();   // m_row written (first chunk); the last chunk's weights read
    for (int i = tid; i < cn * rows; i += DEC_NT)
      wts[i] = fast_exp2(ml[c0 * rows + i].x - m_row[i % rows]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = tid + i * DEC_NT;
      if (e < rows * D) {
        const int r = e / D;
#pragma unroll 4
        for (int s = 0; s < cn; ++s)
          acc[i] += wts[s * rows + r] * os[((c0 + s) * rows + r) * D + e % D];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = tid + i * DEC_NT;
    if (e < rows * D) {
      const int r = e / D;
      const int qi = r / rep;
      from_f32(qi < q_len ? acc[i] * inv_row[r] : 0.f,
               &out[((b * Sq + qi) * H + g * rep + r % rep) * D + e % D]);
    }
  }
}

// the decode kernel, then (when k_len spans several splits) the merge, on
// one stream; ws holds ws_floats fp32 of scratch (null with one split)
template <typename T, int D, int RMAX, typename Addr>
int launch_decode(const void* q, const void* k, const void* v, void* out, void* ws,
                  long long ws_floats, const int* q_offsets, const int* q_lens, int B, int Sq,
                  int H, Addr addr, int KV, float scale, int causal, int window, float softcap,
                  int k_len, cudaStream_t stream) {
  constexpr int L = dec_split<T, D>();
  constexpr size_t smem = dec_smem_bytes<T, D, RMAX>();
  const int rows = Sq * (H / KV);
  const int nsplit = k_len > L ? (k_len + L - 1) / L : 1;
  const long long parts = static_cast<long long>(B) * KV * nsplit * rows;
  if (nsplit > 1 && (ws == nullptr || ws_floats < parts * (D + 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* ws_o = static_cast<float*>(ws);
  float2* ws_ml = nsplit > 1 ? reinterpret_cast<float2*>(ws_o + parts * D) : nullptr;
  auto kern = flash_fwd_decode_kernel<T, D, RMAX, Addr>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(nsplit, KV, B), DEC_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), ws_o, ws_ml, q_offsets, q_lens, Sq, H, addr, KV, scale, causal,
      window, softcap, k_len);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return static_cast<int>(e);
  // the merge as a programmatic dependent launch: it may start while the
  // decode grid drains, and waits for its partials inside
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KV, B);
  cfg.blockDim = dim3(DEC_NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, flash_fwd_decode_merge_kernel<T, D>,
                                             static_cast<T*>(out),
                                             static_cast<const float*>(ws_o),
                                             static_cast<const float2*>(ws_ml), q_offsets, q_lens,
                                             Sq, H, KV, causal, window, k_len, nsplit));
}

template <int D, typename Addr>
int launch_mma(const void* q, const void* k, const void* v, void* out, const int* q_offsets,
               const int* q_lens, int B, int Sq, int H, Addr addr, int KV, float scale,
               int causal, int window, float softcap, int k_len, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  auto kern = flash_fwd_mma_kernel<D, Addr>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows_total = Sq * (H / KV);
  dim3 grid((rows_total + MMA_BR - 1) / MMA_BR, KV, B);
  using T = __nv_bfloat16;
  kern<<<grid, MMA_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), q_offsets, q_lens, Sq, H, addr, KV, scale, causal, window, softcap,
      k_len);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename Addr>
int launch(const void* q, const void* k, const void* v, void* out, const int* q_offsets,
           const int* q_lens, int B, int Sq, int H, Addr addr, int KV, float scale,
           int causal, int window, float softcap, int k_len, cudaStream_t stream) {
  using T = float;
  constexpr int BR = CT_BR;
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<D, Addr>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows_total = Sq * (H / KV);
  dim3 grid((rows_total + BR - 1) / BR, KV, B);
  kern<<<grid, BR * CT_TPR, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), q_offsets, q_lens, Sq, H, addr, KV, scale, causal, window, softcap,
      k_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, typename Addr>
int dispatch_rows(const void* q, const void* k, const void* v, void* out, void* ws,
                  long long ws_floats, const int* q_offsets, const int* q_lens, int B, int Sq,
                  int H, Addr addr, int KV, float scale, int causal, int window, float softcap,
                  int k_len, cudaStream_t stream) {
  // up to dec_rows<D> rows per (b, KV head) (16, or 8 at D 256): the
  // split-KV decode kernel, its registers sized for 1, 4 or that many
  // rows; at D 256 for 1 or 8 (ptxas spilled a 4-row instance there, at
  // 96 registers).  Chunks: bf16 on the tensor-core tile, fp32 on the
  // 64-row tile with 4 lanes a row
  const int rows = Sq * (H / KV);
  constexpr int RTOP = dec_rows<D>();
#define DECODE_INSTANCE(RMAX)                                                                 \
  return launch_decode<T, D, RMAX>(q, k, v, out, ws, ws_floats, q_offsets, q_lens, B, Sq, H, \
                                   addr, KV, scale, causal, window, softcap, k_len, stream)
  if (rows == 1) DECODE_INSTANCE(1);
  if constexpr (RTOP > 8) {
    if (rows <= 4) DECODE_INSTANCE(4);
  }
  if (rows <= RTOP) DECODE_INSTANCE(RTOP);
#undef DECODE_INSTANCE
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_mma<D>(q, k, v, out, q_offsets, q_lens, B, Sq, H, addr, KV, scale, causal,
                         window, softcap, k_len, stream);
  else
    return launch<D>(q, k, v, out, q_offsets, q_lens, B, Sq, H, addr, KV, scale, causal, window,
                     softcap, k_len, stream);
}

// the instances built: head dim 32 (every config's smoke size), 64
// (llama3.2-1b), 80 (zamba2-2.7b's shared attention), 128 (qwen2-moe-a2.7b,
// qwen3-14b, gemma2-27b) and 256 (gemma-7b), each in fp32 and bf16; any
// other (D, dtype) returns cudaErrorInvalidValue
template <typename Addr>
int dispatch_head_dim(const void* q, const void* k, const void* v, void* out, void* ws,
                      long long ws_floats, const int* q_offsets, const int* q_lens, int B, int Sq,
                      int H, int D, int dtype, Addr addr, int KV, float scale, int causal,
                      int window, float softcap, int k_len, cudaStream_t s) {
#define FLASH_INSTANCE(T, DIM)                                                                \
  return dispatch_rows<T, DIM>(q, k, v, out, ws, ws_floats, q_offsets, q_lens, B, Sq, H, addr, \
                               KV, scale, causal, window, softcap, k_len, s)
  if (D == 32 && dtype == 0) FLASH_INSTANCE(float, 32);
  if (D == 32 && dtype == 1) FLASH_INSTANCE(__nv_bfloat16, 32);
  if (D == 64 && dtype == 0) FLASH_INSTANCE(float, 64);
  if (D == 64 && dtype == 1) FLASH_INSTANCE(__nv_bfloat16, 64);
  if (D == 80 && dtype == 0) FLASH_INSTANCE(float, 80);
  if (D == 80 && dtype == 1) FLASH_INSTANCE(__nv_bfloat16, 80);
  if (D == 128 && dtype == 0) FLASH_INSTANCE(float, 128);
  if (D == 128 && dtype == 1) FLASH_INSTANCE(__nv_bfloat16, 128);
  if (D == 256 && dtype == 0) FLASH_INSTANCE(float, 256);
  if (D == 256 && dtype == 1) FLASH_INSTANCE(__nv_bfloat16, 256);
#undef FLASH_INSTANCE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  q_offsets
// and q_lens are device int32 [B].  window <= 0 and softcap <= 0 disable
// them.  ws is the decode kernel's fp32 scratch of ws_floats elements: a
// call with Sq·H/KV <= dec_rows<D> rows (16, or 8 at D 256) and k_len over
// one split (dec_split: 256, 128 or 64 keys by the bytes of a K row) needs
// B·KV·ceil(k_len / split)·Sq·(H/KV)·(D + 2); any other call may pass
// null.  Built for head dims 32 (the smoke configs), 64 (llama3.2-1b), 80
// (zamba2-2.7b), 128 (qwen2-moe-a2.7b, qwen3-14b, gemma2-27b) and 256
// (gemma-7b); other head dims come with the configs that need them.  Returns a cudaError_t (0 =
// success); a shape the kernels do not take, or too small a workspace,
// returns cudaErrorInvalidValue without launching.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* ws, long long ws_floats, const int* q_offsets,
                                   const int* q_lens, int B, int Sq, int H, int Sk, int KV, int D,
                                   int dtype, float scale, int causal, int window, float softcap,
                                   int k_len, void* stream) {
  if (B <= 0 || Sq <= 0 || KV <= 0 || H % KV != 0 || k_len > Sk || k_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DenseKV addr{Sk};
  return dispatch_head_dim(q, k, v, out, ws, ws_floats, q_offsets, q_lens, B, Sq, H, D, dtype,
                           addr, KV, scale, causal, window, softcap, k_len, s);
}

// The paged kernels: K/V read through `table` [B, pages_per_slot] (device
// int32, negative = unmapped: read as the trash page num_pages) from the
// pools pool_k/pool_v [num_pages_plus_1, P, KV, D]; the logical key axis is
// pages_per_slot·P long.  Everything else as flash_attention_fwd.  The
// caller keeps every non-negative entry below num_pages_plus_1.
extern "C" int flash_attention_paged_fwd(const void* q, const void* pool_k, const void* pool_v,
                                         const int* table, void* out, void* ws,
                                         long long ws_floats, const int* q_offsets,
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
  return dispatch_head_dim(q, pool_k, pool_v, out, ws, ws_floats, q_offsets, q_lens, B, Sq, H, D,
                           dtype, addr, KV, scale, causal, window, softcap, k_len, s);
}
