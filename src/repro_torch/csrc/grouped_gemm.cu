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
// ~26 experts, about one row each, so the call is the touched experts'
// weights read once (K·N·2 bytes each, 5.8 MB at qwen2-moe's 2048 × 1408).
// A fused 64-token chunk of 8 slots routes 2048 rows over all 60 real
// experts, ~34 rows each: ~5 flops per weight byte, far under the card's
// ~295 flop/byte bf16 ridge.  What must hold is that each (expert, N-tile)
// of weights is read from device memory once per row tile, never once per
// row, and that every SM streams weights for the whole call.
//
// Work units.  The TPU wrapper pads every group to whole 128-row blocks in a
// copy of x (megablocks packing), hands the kernel a block → expert map by
// scalar prefetch, and gathers the output rows back: BlockSpecs need whole
// blocks.  Here a row tile is BM rows of one expert's range (or of the rows
// after the last group), read from x in place with the ragged row edge
// masked at the store: no padded copy of x and no gather afterwards.  A
// warp finds row tile t's (expert, first row, rows) by a shuffle prefix sum
// over ceil(size/BM), 32 experts at a time, from the group sizes on the
// device; the host never reads them.
//
// bf16 (the serving path): a persistent kernel (`grouped_gemm_wgmma_kernel`)
// of two blocks an SM walks the work units, a unit being (row tile,
// 128-column tile, K split), numbered so that the K splits of one output
// tile, then the column tiles of one row tile, are neighbours: they run at
// about the same time and share x's rows in L2.  Block b takes unit b first,
// then the next number from a counter in device memory, so a block that
// streams faster takes more units and the SMs finish together; an expert
// with no rows has no units, so no block is launched to exit.
//   Split-K.  At decode routing (~26 row tiles × 11 column tiles) whole
//   tiles would give 264 blocks uneven work, so the host
//   (`kernels/grouped_gemm.py::split_k`) cuts K into S splits of whole
//   64-deep steps (the last may end in a K tail) when the expected tiles
//   are under four waves of the SMs.  A split stores its fp32 partial for
//   the tile's valid rows to a workspace [S, M, N] and hands the tile to
//   the block's epilogue warp, which counts the tile's arrivals; the last
//   of its S units to arrive sums the S partials in split order and writes
//   bf16, while the consumers go on.  No float atomics: two launches are
//   bit-identical.
//   Pipeline.  A producer warp issues TMA loads (`cp.async.bulk.tensor`,
//   completion on an mbarrier) into a ring of RING stages of 24 KB — the x
//   tile [64 rows × 64] and the w tile [64 × 128] as two 64-column boxes,
//   both 128-byte swizzled — running ahead across units (192 KB in flight
//   an SM), and hands the unit numbers to the consumers through a small
//   queue.  x is seen 2-D [M, K] (rows past M and a K tail zero-fill) and w
//   3-D [E, K, N] (a K tail zero-fills instead of reading the next
//   expert's rows; an N tail zero-fills); w's loads carry an evict-first L2
//   policy (read once a call).  Rows of x past the expert's range are
//   loaded and their outputs never stored.  One consumer warpgroup runs
//   `wgmma.mma_async.m64n128k16` on the ring (A K-major, B N-major, i.e.
//   transposed, both from the swizzled stages), fp32 accumulators in
//   registers, and stores bf16 pairs of the valid rows itself: a TMA store
//   would write rows of the next expert's tile.  Two consumer warpgroups
//   sharing one ring were tried and dropped: a stage's mbarrier phase
//   parity cannot tell a consumer that is one lap ahead from one that is
//   one lap behind, and they deadlocked; two blocks an SM, each with its own
//   ring, give the same overlap.
//   Not done: thread-block clusters with multicast of the x tile, and
//   fusing gate and up into one call.
//
// fp32 (the parity path, not timed): the CUDA-core kernel
// (`grouped_gemm_kernel`), one block per (row tile, column tile) on a grid
// of ceil(M/BM) + E row tiles (blocks past the last tile exit), BK-deep
// `cp.async` stages, 8 × 8 outputs a thread.

#include <cuda.h>   // CUtensorMap and its enums (types only: nothing of libcuda is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;       // rows of one expert per tile
constexpr int BN = 128;      // output columns per tile
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------ row tiles
struct Tile {
  int expert;   // -1: rows after the last group
  int row_lo;   // first row
  int rows;     // valid rows (<= 0: nothing to do)
};

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// row tiles of all experts, plus those of the rows after the last group
// (warp-collective; every lane returns the count)
__device__ int count_tiles(const int* __restrict__ group_sizes, int E, int M, int lane) {
  int tiles = 0;
  int rows = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    const int gs = e < E ? max(group_sizes[e], 0) : 0;
    tiles += warp_sum((gs + BM - 1) / BM);
    rows += warp_sum(gs);
  }
  return tiles + (max(M - rows, 0) + BM - 1) / BM;
}

// row tile t: prefix sums over the experts of their sizes and of their tile
// counts ceil(size/BM), 32 at a time (warp-collective)
__device__ Tile locate(const int* __restrict__ group_sizes, int E, int M, int t, int lane) {
  int tiles_before = 0;
  int rows_before = 0;
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
    const unsigned hit = __ballot_sync(FULL, t >= t_lo && t < t_lo + nt);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const int start = __shfl_sync(FULL, rows_before + gs_inc - gs, src);
      const int first = __shfl_sync(FULL, t_lo, src);
      const int size = __shfl_sync(FULL, gs, src);
      const int r0 = start + (t - first) * BM;
      return {e0 + src, r0, min(min(r0 + BM, start + size), M) - r0};
    }
    tiles_before += __shfl_sync(FULL, nt_inc, 31);
    rows_before += __shfl_sync(FULL, gs_inc, 31);
  }
  // past every expert's tiles: the rows after the last group, BM a tile
  const int r0 = rows_before + (t - tiles_before) * BM;
  return {-1, r0, min(r0 + BM, M) - r0};
}

// ======================================================= bf16: TMA + wgmma
constexpr int WK = 64;                         // K depth of a stage: one 128-byte bf16 row
constexpr int RING = 4;                        // stages in a block's ring (96 KB)
constexpr int BLOCKS_PER_SM = 2;               // two pipelines an SM, 192 KB in flight
constexpr int A_BYTES = BM * WK * 2;           // x tile [64 rows][64 k], 128-byte swizzled
constexpr int B_HALF = WK * 64 * 2;            // one 64-column box of w [64 k][64 n]
constexpr int STAGE_BYTES = A_BYTES + 2 * B_HALF;
constexpr int QUEUE = 4;                       // unit queue entries, producer -> consumers
constexpr int WG_THREADS = 128 + 64;           // a consumer warpgroup, a producer and an epilogue warp
constexpr int MAX_SPLITS = 16;                 // kernels/grouped_gemm.py::MAX_SPLITS
// the ring (1024-byte aligned), the mbarriers (ring, queue, epilogue slot),
// the queue entries (unit numbers) and the epilogue slot
constexpr size_t WG_SMEM = 1024 + static_cast<size_t>(RING) * STAGE_BYTES +
                           (2 * RING + 2 * QUEUE + 2) * 8 + QUEUE * 4 + 4 * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// w is read once a call: an evict-first L2 policy keeps x and the split-K
// partials in L2 instead
__device__ __forceinline__ void tma_load_3d_evict_first(uint32_t dst, const CUtensorMap* map,
                                                        int c0, int c1, int c2, uint32_t bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's fence and wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a · b for a 64 × 128 × 16 bf16 piece: A K-major, B N-major
// (transposed), fp32 accumulators, 64 a thread
__device__ __forceinline__ void wgmma_64x128x16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// one work unit: row tile, column tile, K split and its K steps [kt_lo, kt_hi)
struct Unit {
  Tile tile;
  int tile_idx;
  int n_tile;
  int split;
  int kt_lo;
  int kt_hi;
};

__device__ __forceinline__ Unit unit_of(int u, const int* __restrict__ group_sizes, int E, int M,
                                        int n_tiles_n, int S, int n_k, int lane) {
  Unit U;
  const int per_tile = n_tiles_n * S;
  U.tile_idx = u / per_tile;
  const int rem = u - U.tile_idx * per_tile;
  U.n_tile = rem / S;
  U.split = rem - U.n_tile * S;
  const int q = (n_k + S - 1) / S;   // K steps a split (the host keeps every split non-empty)
  U.kt_lo = U.split * q;
  U.kt_hi = min(n_k, U.kt_lo + q);
  U.tile = locate(group_sizes, E, M, U.tile_idx, lane);
  return U;
}

// hand unit u (-1: no more) to the consumers through queue entry j % QUEUE
__device__ __forceinline__ void push_unit(int* queue, uint32_t qfull, uint32_t qempty, int j,
                                          int u) {
  const int e = j % QUEUE;
  mbar_wait(qempty + 8 * e, ((j / QUEUE) & 1) ^ 1);
  queue[e] = u;
  mbar_arrive(qfull + 8 * e);   // release: the entry is seen by the waiting consumers
}

// the consumer warpgroup hands split tile number k (index -1: no more) to
// the epilogue warp: thread 0 fills the slot once the epilogue warp has
// read the last one; each warp arrives after its own partial stores
__device__ __forceinline__ void hand_over(int* slot, uint32_t efull, uint32_t eempty, int k,
                                          int tile, int row_lo, int rows, int tid, int lane) {
  if (tid == 0) {
    mbar_wait(eempty, (k & 1) ^ 1);
    slot[0] = tile;
    slot[1] = row_lo;
    slot[2] = rows;
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");   // the 4 warps arrive for the same k
  __syncwarp();
  if (lane == 0) mbar_arrive(efull);
}

// counters: [0] the next unit to hand out, [1] blocks done, [2 + t · n_tiles_n
// + n] the arrivals at output tile (t, n); all zero between calls
__global__ void __launch_bounds__(WG_THREADS, BLOCKS_PER_SM)
grouped_gemm_wgmma_kernel(__grid_constant__ const CUtensorMap xmap,
                          __grid_constant__ const CUtensorMap wmap,
                          const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ out,
                          float* __restrict__ ws, int* __restrict__ counters, int M, int K, int N,
                          int E, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: the ring starts on one
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t ring = (base + 1023u) & ~1023u;
  const uint32_t full = ring + RING * STAGE_BYTES;   // stage loaded (producer + TMA bytes)
  const uint32_t empty = full + RING * 8;            // stage consumed (4 warps)
  const uint32_t qfull = empty + RING * 8;           // queue entry written (producer)
  const uint32_t qempty = qfull + QUEUE * 8;         // queue entry read (4 warps)
  const uint32_t efull = qempty + QUEUE * 8;         // epilogue slot written (4 warps)
  const uint32_t eempty = efull + 8;                 // epilogue slot read (epilogue warp)
  int* queue = reinterpret_cast<int*>(smem_raw + (eempty + 8 - base));
  int* slot = queue + QUEUE;                         // split tile: index, first row, rows
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4);
    }
    for (int i = 0; i < QUEUE; ++i) {
      mbar_init(qfull + 8 * i, 1);
      mbar_init(qempty + 8 * i, 4);
    }
    mbar_init(efull, 4);
    mbar_init(eempty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tiles_n = (N + BN - 1) / BN;
  const int n_k = (K + WK - 1) / WK;
  const int units = count_tiles(group_sizes, E, M, lane) * n_tiles_n * S;
  int* next_unit = counters;
  int* blocks_done = counters + 1;
  int* arrivals = counters + 2;

  // ring position, carried across units: stage and its phase parity
  int stage = 0;
  uint32_t phase = 0;

  if (warp == 4) {
    // producer warp: takes units from the shared counter in order (a
    // faster block takes more), hands each live one to the consumers, and
    // lane 0 keeps the ring full
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap)) : "memory");
    }
    int j = 0;               // live units handed to the consumers
    int u = blockIdx.x;      // the first unit is the block's own number, the rest come from the counter
    while (u < units) {
      int next = 0;
      if (lane == 0) next = gridDim.x + atomicAdd(next_unit, 1);   // in flight during the loads
      const Unit U = unit_of(u, group_sizes, E, M, n_tiles_n, S, n_k, lane);
      // rows after the last group take no loads, and only split 0 zeroes them
      const bool live = U.tile.rows > 0 && (U.tile.expert >= 0 || U.split == 0);
      if (live && lane == 0) {
        push_unit(queue, qfull, qempty, j, u);
        const int n0 = U.n_tile * BN;
        for (int kt = U.kt_lo; U.tile.expert >= 0 && kt < U.kt_hi; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);   // the first pass finds it free
          const uint32_t a = ring + stage * STAGE_BYTES;
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load_2d(a, &xmap, kt * WK, U.tile.row_lo, bar);
          tma_load_3d_evict_first(a + A_BYTES, &wmap, n0, kt * WK, U.tile.expert, bar);
          tma_load_3d_evict_first(a + A_BYTES + B_HALF, &wmap, n0 + 64, kt * WK, U.tile.expert,
                                  bar);
          if (++stage == RING) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      j += live;
      u = __shfl_sync(FULL, next, 0);
    }
    if (lane == 0) {
      push_unit(queue, qfull, qempty, j, -1);
      // the last block out resets the schedule for the next call: every
      // block has taken its last unit number by now
      if (atomicAdd(blocks_done, 1) == static_cast<int>(gridDim.x) - 1) {
        *next_unit = 0;
        *blocks_done = 0;
      }
    }
    return;
  }

  if (warp == 5) {
    // epilogue warp: for each split tile the consumers hand over, count its
    // arrival; the tile's last split to arrive sums all S partials in split
    // order and writes bf16, while the consumers go on to the next unit
    for (int k = 0;; ++k) {
      mbar_wait(efull, k & 1);
      const int tile = slot[0];
      const long long row0 = slot[1];
      const int rows = slot[2];
      __syncwarp();
      if (lane == 0) mbar_arrive(eempty);
      if (tile < 0) break;
      int last = 0;
      if (lane == 0) {
        // release: this tile's partial, stored by the consumers before they
        // handed it over, is visible before the count; acquire: so are the
        // other splits' partials to the last
        int* counter = &arrivals[tile];
        int arrived;
        asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                     : "=r"(arrived)
                     : "l"(counter)
                     : "memory");
        last = arrived == S - 1;
        if (last) *counter = 0;   // every split has arrived: ready for the next call
      }
      if (!__shfl_sync(FULL, last, 0)) continue;
      __syncwarp();   // lane 0's acquire orders every lane's reads below
      const int n0 = (tile % n_tiles_n) * BN;
      for (int p = lane; p < rows * (BN / 2); p += 32) {
        const int c = n0 + (p % (BN / 2)) * 2;
        if (c >= N) continue;
        const long long off = (row0 + p / (BN / 2)) * N + c;
        float2 v[MAX_SPLITS];   // all S partials in flight at once
#pragma unroll
        for (int s = 0; s < MAX_SPLITS; ++s)
          if (s < S)
            v[s] = __ldcg(
                reinterpret_cast<const float2*>(&ws[static_cast<long long>(s) * M * N + off]));
        float2 sum = make_float2(0.f, 0.f);
#pragma unroll
        for (int s = 0; s < MAX_SPLITS; ++s) {
          if (s < S) {
            sum.x += v[s].x;
            sum.y += v[s].y;
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(&out[off]) = __floats2bfloat162_rn(sum.x, sum.y);
      }
    }
    return;
  }

  // consumer warpgroup: the units in the order the producer took them.
  // Accumulator d[4j + 2h + c] is row warp·16 + lane/4 + 8h, column 8j +
  // 2·(lane % 4) + c of the 64 × 128 tile.
  const int r_in = warp * 16 + (lane >> 2);
  const int c_in = (lane & 3) * 2;
  int n_split = 0;   // split tiles handed to the epilogue warp
  for (int j = 0;; ++j) {
    const int e = j % QUEUE;
    mbar_wait(qfull + 8 * e, (j / QUEUE) & 1);
    const int u = queue[e];
    __syncwarp();
    if (lane == 0) mbar_arrive(qempty + 8 * e);
    if (u < 0) {
      hand_over(slot, efull, eempty, n_split++, -1, 0, 0, tid, lane);   // the epilogue warp stops
      break;
    }
    const Unit U = unit_of(u, group_sizes, E, M, n_tiles_n, S, n_k, lane);
    const int rows = U.tile.rows;
    const int n0 = U.n_tile * BN;
    if (U.tile.expert < 0) {
      // rows after the last group are zeros
      for (int p = tid; p < rows * (BN / 2); p += 128) {
        const int c = n0 + (p % (BN / 2)) * 2;
        if (c < N)
          *reinterpret_cast<__nv_bfloat162*>(
              &out[static_cast<long long>(U.tile.row_lo + p / (BN / 2)) * N + c]) =
              __floats2bfloat162_rn(0.f, 0.f);
      }
      continue;
    }

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = U.kt_lo; kt < U.kt_hi; ++kt) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t a = ring + stage * STAGE_BYTES;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) {
        // A: 8-row groups 1024 bytes apart, k16 steps 32 bytes into the
        // swizzled row; B: the two 64-column boxes B_HALF apart (leading),
        // 8-k groups 1024 apart (stride), k16 steps 16 rows = 2048 bytes
        wgmma_64x128x16(acc, sw128_desc(a + kk * 32, 16, 1024),
                        sw128_desc(a + A_BYTES + kk * 2048, B_HALF, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      if (++stage == RING) {
        stage = 0;
        phase ^= 1;
      }
    }

    const long long row0 = U.tile.row_lo;
    if (S == 1) {
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const int c = n0 + jn * 8 + c_in;
        if (c >= N) continue;        // N % 8 == 0: a pair is in or out whole
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_in + 8 * h;
          if (r >= rows) continue;
          *reinterpret_cast<__nv_bfloat162*>(&out[(row0 + r) * N + c]) =
              __floats2bfloat162_rn(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
        }
      }
      continue;
    }

    // split-K: store this split's partial and hand the tile to the
    // epilogue warp
    float* part = ws + static_cast<long long>(U.split) * M * N;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      const int c = n0 + jn * 8 + c_in;
      if (c >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_in + 8 * h;
        if (r >= rows) continue;
        *reinterpret_cast<float2*>(&part[(row0 + r) * N + c]) =
            make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
      }
    }
    hand_over(slot, efull, eempty, n_split++, U.tile_idx * n_tiles_n + U.n_tile, U.tile.row_lo,
              rows, tid, lane);
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query,
// so the library links against the CUDA runtime alone
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor map with 128-byte swizzled boxes of 64 elements inner
bool encode(CUtensorMap* map, EncodeTiled fn, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapL2promotion l2) {
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, l2,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* x, const void* w, const int* group_sizes, void* out, float* ws,
                int* counters, int M, int K, int N, int E, int S, int sms, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap xmap, wmap;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t x_box[2] = {WK, BM};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(E)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                   static_cast<cuuint64_t>(K) * N * 2};
  const cuuint32_t w_box[3] = {64, WK, 1};
  if (!encode(&xmap, fn, x, 2, x_dims, x_strides, x_box, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode(&wmap, fn, w, 3, w_dims, w_strides, w_box, CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(grouped_gemm_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(WG_SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  // at most ceil(M/BM) + E + 1 live row tiles: no block is launched past them
  const long long units =
      (static_cast<long long>((M + BM - 1) / BM) + E + 1) * ((N + BN - 1) / BN) * S;
  const long long slots = static_cast<long long>(sms) * BLOCKS_PER_SM;
  const int grid = static_cast<int>(units < slots ? units : slots);
  grouped_gemm_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, stream>>>(
      xmap, wmap, group_sizes, static_cast<__nv_bfloat16*>(out), ws, counters, M, K, N, E, S);
  return static_cast<int>(cudaGetLastError());
}

// ========================================================= fp32: CUDA cores
constexpr int BK = 32;       // depth of one pipeline stage
constexpr int STAGES = 4;    // cp.async ring depth
constexpr int NT = 128;      // threads per block (four warps)
constexpr int EPC = 4;       // fp32 elements per 16-byte copy
constexpr int LDA = BK + EPC;
constexpr int LDB = BN + EPC;
constexpr int A_ELEMS = BM * LDA;
constexpr int STAGE_ELEMS = A_ELEMS + BK * LDB;
constexpr size_t F32_SMEM = static_cast<size_t>(STAGES) * STAGE_ELEMS * sizeof(float);

// 16-byte global -> shared copy that bypasses the registers; src_bytes = 0
// fills the 16 bytes with zeros (a K or N tail)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__global__ void __launch_bounds__(NT)
grouped_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ group_sizes, float* __restrict__ out, int M, int K,
                    int N, int E) {
  __shared__ int s_tile[3];   // expert (-1: rows no group covers), first row, valid rows
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.y * BN;
  if (warp == 0) {
    const Tile t = locate(group_sizes, E, M, blockIdx.x, lane);
    if (lane == 0) {
      s_tile[0] = t.expert;
      s_tile[1] = t.row_lo;
      s_tile[2] = t.rows;
    }
  }
  __syncthreads();
  const int expert = s_tile[0];
  const int row_lo = s_tile[1];
  const int rows = s_tile[2];
  if (rows <= 0) return;                          // block-uniform
  if (expert < 0) {
    for (int e = tid; e < rows * BN; e += NT) {
      const int c = n0 + e % BN;
      if (c < N) out[static_cast<long long>(row_lo + e / BN) * N + c] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const float* wexp = w + static_cast<long long>(expert) * K * N;
  const int n_k = (K + BK - 1) / BK;

  // start the copies of K step kt into stage kt % STAGES (rows past the
  // tile's are not copied: a product row reads only its own x row, and those
  // output rows are never stored)
  auto load = [&](int kt) {
    float* As = smem + (kt % STAGES) * STAGE_ELEMS;
    float* Bs = As + A_ELEMS;
    const int k0 = kt * BK;
    for (int c = tid; c < BM * (BK / EPC); c += NT) {
      const int r = c / (BK / EPC);
      const int kc = (c % (BK / EPC)) * EPC;
      if (r >= rows) break;                       // r grows with c
      const bool in = k0 + kc < K;
      const float* src = in ? x + static_cast<long long>(row_lo + r) * K + k0 + kc : x;
      cp_async16(As + r * LDA + kc, src, in ? 16 : 0);
    }
    for (int c = tid; c < BK * (BN / EPC); c += NT) {
      const int kr = c / (BN / EPC);
      const int nc = (c % (BN / EPC)) * EPC;
      const bool in = k0 + kr < K && n0 + nc < N;
      const float* src = in ? wexp + static_cast<long long>(k0 + kr) * N + n0 + nc : w;
      cp_async16(Bs + kr * LDB + nc, src, in ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load(s);
    cp_async_commit();   // empty groups keep the count uniform
  }

  // thread (ty, tx) owns rows ty + 8i, cols tx + 16j
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
    const float* As = smem + (kt % STAGES) * STAGE_ELEMS;
    const float* Bs = As + A_ELEMS;
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

int launch_f32(const void* x, const void* w, const int* group_sizes, void* out, int M, int K,
               int N, int E, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(grouped_gemm_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(F32_SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((M + BM - 1) / BM + E, (N + BN - 1) / BN);
  grouped_gemm_kernel<<<grid, NT, F32_SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), group_sizes,
      static_cast<float*>(out), M, K, N, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace


// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).  x [M, K], w
// [E, K, N] and out [M, N] are contiguous and 16-byte aligned; group_sizes
// is device int32 [E].  K and N must be multiples of 8.  bf16 only: the K
// split count `splits` (1..MAX_SPLITS, every split non-empty), zeroed int32
// counters [2 + (ceil(M/64) + E + 1) · ceil(N/128)], which the kernel leaves
// zeroed, for splits > 1 an fp32 workspace ws [splits, M, N], and `sms`, the
// persistent grid's size.  float32 takes splits = 1 and neither buffer.
// Returns a cudaError_t (0 = success); a shape the kernel does not take
// returns cudaErrorInvalidValue without launching.
extern "C" int grouped_gemm_fwd(const void* x, const void* w, const int* group_sizes, void* out,
                                void* ws, int* counters, int M, int K, int N, int E, int dtype,
                                int splits, int sms, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 != 0 || N % 8 != 0 || splits < 1 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_f32(x, w, group_sizes, out, M, K, N, E, s);
  }
  if (dtype == 1) {
    const int n_k = (K + WK - 1) / WK;
    const int q = (n_k + splits - 1) / splits;
    if ((splits - 1) * q >= n_k) return static_cast<int>(cudaErrorInvalidValue);   // an empty split
    if (counters == nullptr || splits > MAX_SPLITS || (splits > 1 && ws == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16(x, w, group_sizes, out, static_cast<float*>(ws), counters, M, K, N, E,
                       splits, sms, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
