// K2, K3 and K5: stage 1, the banded eval and the propagation of the v3
// align pipe.
//
// Replace the XLA device programs of the JAX package's `_row_core_v3` (its
// ops/align_tpu.py): stage 1, the occupancy product with its packed maxes
// (:1108-1157), stages 2-4, the window gather, the band counts and their
// election (:1162-1230), and stages 5-6, the neighbour propagation and the
// final flags (:1235-1290). All are bit-exact with the plain torch
// versions beside their wrappers in ops/align_gpu.py (`stage1_pack_plain`,
// `bands_v3_plain`, `propagate_v3_plain`).
//
// K2 (k2_stage1). For every task (dispatch row x query) it forms
// M = qocc . rocc^T, (2*NQB) query half-blocks x NRB reference blocks over
// H hashed canonical 8-mers, {0,1} int8, and keeps per query block q and
// over reference blocks rr the maxima of ((Ma + Mb) << 13) | rr,
// (Ma << 13) | rr and (Mb << 13) | rr, Ma and Mb being rows 2q and 2q+1.
// Counts stay <= 64 (a half block holds at most 64 distinct buckets), so
// << 13 cannot overflow, and the packed max gives ties to the larger rr.
// What bounds it on an H100 SXM, and what the design does about it:
//   * Operations: 2 * 2*NQB * NRB * H u8 products a task against the 1,979
//     TOPS dense int8 tensor rate, which only `wgmma` reaches. Two consumer
//     warpgroups each issue m64n256k32 u8 x u8 -> s32 with both operands
//     read from shared memory (K-major, 128-byte swizzle), on a 128 x 256
//     tile (query half-blocks x reference blocks); a k-block is 128
//     buckets. The score matrix never leaves the registers.
//   * Operand bytes: a k-block brings 16 KB of A and 32 KB of B for 8.4M
//     products. A producer thread keeps a 4-stage ring full with TMA copies
//     from tensor maps over the arenas; it reads q_rows[task] and
//     r_rows[task / K] itself and passes them as the arena coordinate. TMA
//     fills rows past M2 and NRB with zeros. CTAs are persistent and walk
//     the tiles in the order (dispatch row, reference tile, query, query
//     tile), so the CTAs in flight share one reference tile of one arena
//     row (the K queries of a row share their reference) and a row's
//     operands stay in the 50 MB L2 while it is worked on.
//   * Epilogue, the part that does not overlap the products: the query
//     arena's map is 5-D, (H, 8 blocks, 2 halves, NQB / 8, G), so a 16-row
//     group of the A tile holds 8 query blocks' even half rows, then their
//     odd ones. Rows g and g + 8 of the m16n8 accumulator fragment, which
//     one thread holds, are then half rows 2q and 2q + 1 of one block: the
//     three packs need no shuffle, are reduced over the tile's columns in
//     registers and across the 4 lanes of a row, and atomicMax (order-free:
//     the result is deterministic) adds them into the three (tasks, NQB)
//     outputs, which the wrapper zeroes. The producer loads the next
//     tile's stages meanwhile. (A shuffle a value to pair rows g and
//     g + 1 instead cost a third of the kernel's time.)
//   * Small buckets (2*NQB <= 64 and NRB <= 128, bucket 4,096): the same
//     kernel with one consumer warpgroup on a 64 x 128 tile, two CTAs an
//     SM, so no product runs on rows that are all padding.
//
// K3 (k3_row_bands). Stages 2-4 in one launch. For every fine block f (32
// query bases) and each of the four bands (candidate 1 and 2, forward at
// the candidate's reference block g and reverse at its mirror block), the
// count of valid query bases equal to the window base at each of BAND =
// WQ + 96 shifts, written as int8 (stages 5-6 read them), and the
// election, decoded: the max over bands and shifts of (count << 12) | tag
// | shift, tags 3072 (candidate 1, forward), 2048 (candidate 1, reverse),
// 1024 (candidate 2, forward), 0 (candidate 2, reverse), so ties go to
// candidate 1, then the forward strand, then the larger shift; then its
// count, strand and diagonal, and whether it passes the candidate's gate
// and the block's threshold. The windows are read in place: band i's
// window of fine block f is bytes 16 + 32 (f % FPB) .. + WIN of row g_i of
// the wide rows `roww_f` (bands 0, 2) or `roww_r` (1, 3); no window tensor
// exists. Code contract: a code is a base only in 0-3 (the path's codes
// are 0-4, N and the row pads being 4), which is what makes the bit
// planes below equal to the plain byte compares.
// What bounds it, and what the design does about it:
//   * Operations: a base is three bits (low, high, "is a base"), so a fine
//     block's 32 compares at one shift are one word each of three planes:
//     3 funnel shifts align the window's planes to the shift, 3 logic ops
//     give ~(ql ^ wl) & ~(qh ^ wh) & qv & wv, a population count (4 issue
//     slots) and 3 for the packed max: 13 int32 issue slots a fine block,
//     band and shift against 64 slots an SM and clock.
//   * Bytes: the counts written once (382 MB at the B = 26 dispatch at
//     65,536), the distinct wide rows and the query codes read (41 and 14
//     MB there), the election written: under half the operations' time.
//   * Design: one warp a coarse block (FPB fine blocks), the bands one
//     after the other. The FPB windows of a band lie in one row and overlap
//     by WIN - 32 bytes, so a lane loads one byte of each of the row's
//     2 FPB + 3 words and __ballot_sync builds each plane word once a
//     coarse block and band (11 words at V3_WQ = 128, against 32 when
//     each fine block built its window's own); fine block k's
//     window starts at word k, so a lane's shift is one funnel shift of two
//     of the row's words. Lanes take the shifts, so a warp's byte stores
//     of a count row are contiguous; the election stays in registers until
//     one __reduce_max_sync a fine block, and lane k decodes block k. No
//     shared memory, no __syncthreads. A band whose row and query hold
//     only codes 0-3 (most of them: N runs and pads are rare) skips the
//     "is a base" planes: 2 funnel shifts and 1 logic op a shift.
//     Templated on FPB (2-13), so every array index is a constant.
//
// K5 (k5_propagate). Per fine block of a directed pair, EXT_ITERS rounds of
// neighbour adoption (from the block before, then from the block after),
// each reading the neighbour's (strand, diagonal) from before the step and
// its count from the band counts K3 wrote (the largest over the bands that
// hold that strand and diagonal), in the rescue and continuity tiers; then
// the final flags m1 on the block's own (strand, diagonal) and m0 on the
// previous block's where the block is switchable, each a query base equal
// to the window base at the diagonal in any band that holds it.
// What bounds it, and what the design does about it:
//   * Bytes, in 32-byte sectors: the count a step gathers for a block whose
//     neighbour differs (one sector each), the query bases and the window
//     bytes of the bands that hold a flag's diagonal (one or two sectors of
//     the wide rows K3 read: a window of block f in band i is bytes 16 +
//     32 (f % FPB) .. of row g_i, the band's first diagonal 32 g_i -
//     (f / FPB + 1) WQ - 16), the candidates g1, g2 and the per-block
//     state read once and the flags written once. The band counts and rows
//     are read only where a gather needs them (a few percent of the 382 MB
//     of counts of the B = 26 dispatch).
//   * Latency and the L1's wavefronts: a gather that first waits on the
//     load of its band's first diagonal, a warp that walks its blocks one
//     load at a time, or a load instruction whose 32 lanes read 32
//     different rows leaves the memory system idle or the L1 busy.
//   * Design: the work is cut into tiles of K5_TILE = 128 blocks of one
//     pair, one warp each (N * ceil(NBF / (128 - 2 * EXT_ITERS - 1))
//     warps, 4 a CTA), blocks lane + 32 j (j < 4) in a lane, so that every
//     per-block load and store is coalesced. A block's state after the
//     2 * EXT_ITERS steps is the initial state of a block at most
//     EXT_ITERS away (each step reads one neighbour, and the sides
//     alternate), so a tile computes EXT_ITERS + 1 blocks of halo on its
//     left (one more for the previous block's state) and EXT_ITERS on its
//     right, and writes the blocks between; tiles never wait on each
//     other. Before the first step the warp gathers, for each block, the
//     count at the initial (strand, diagonal) of each of the
//     2 * EXT_ITERS + 1 blocks of its cone (the candidate table, in
//     shared memory), a block's candidates on neighbouring lanes, so that
//     a load instruction reads a few count rows, not 32, and every load is
//     independent. The steps exchange the neighbours' states by shuffles
//     and carry each block's source block, whose count is one
//     shared-memory read; the adoption still compares (strand, diagonal),
//     not sources. The flags then go 4 blocks at a time over the warp, 8
//     lanes a block and a word (4 positions) a lane: the query bases, each
//     band's window (two aligned words funnel-shifted) and the two flag
//     rows are 32 consecutive bytes a block, compared 4 bytes at a time
//     (__vcmpeq4), with the windows' bands and shifts taken from shared
//     memory and 16 blocks' loads in flight.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// Devices a process may launch on (launch state is kept per device).
constexpr int MAX_DEVICES = 64;

// ---- shared-memory barriers, TMA and wgmma (as in csrc/occupancy.cu) ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
               "r"(bar), "r"(bytes) : "memory");
}

// The box of `map` at (k, row, arena row g) into shared memory at dst.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int k, int row,
                                            int g) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row),
      "r"(g)
      : "memory");
}

// The box of the 5-D `map` at (k, 0, 0, q, g) into shared memory at dst.
__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int k, int q,
                                            int g) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(0),
      "r"(q), "r"(g)
      : "memory");
}

// Shared-memory descriptor of a K-major tile of 128-byte rows written by TMA
// with the 128-byte swizzle: 8-row groups 1,024 bytes apart (SBO), layout 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

#define D8(i)                                                           \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x N, s32, the warpgroup's fragment) = (acc ? d : 0) + a (64 x 32
// u8) * b (N x 32 u8)^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(int (&d)[64], uint64_t a, uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(int (&d)[128], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56),
        D8(64), D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "l"(a), "l"(b), "r"(acc));
}

#undef D8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_operand(int& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// ---- K2 ----------------------------------------------------------------
constexpr int K2_KB = 128;      // hash buckets a k-block: one 128-byte row
constexpr int K2_KSTEP = 32;    // buckets a wgmma (k32)
constexpr int K2_STAGES = 4;
constexpr int RB_BITS = 13;

// CONS consumer warpgroups of 64 tile rows each, a BN-column tile.
template <int CONS, int BN>
struct K2Tile {
  static constexpr int BM = 64 * CONS;
  static constexpr int THREADS = (CONS + 1) * 128;
  static constexpr int CTAS_PER_SM = CONS == 1 ? 2 : 1;
  static constexpr int A_BYTES = BM * K2_KB;
  static constexpr int B_BYTES = BN * K2_KB;
  static constexpr int SMEM =
      K2_STAGES * (A_BYTES + B_BYTES) + 2 * K2_STAGES * 8 + 1024;
};

// Tile `tile` of the walk (dispatch row, reference tile, query of the row,
// query tile): its task, first query half-block row and reference block.
__device__ __forceinline__ void k2_tile(int tile, int K, int ntm, int ntn,
                                        int bm, int bn, int& task, int& m0,
                                        int& n0) {
  const int per_n = K * ntm;
  const int row = tile / (per_n * ntn);
  const int rem = tile - row * per_n * ntn;
  const int nt = rem / per_n;
  const int rem2 = rem - nt * per_n;
  task = row * K + rem2 / ntm;
  m0 = (rem2 % ntm) * bm;
  n0 = nt * bn;
}

template <int CONS, int BN>
__global__ void __launch_bounds__(K2Tile<CONS, BN>::THREADS,
                                  K2Tile<CONS, BN>::CTAS_PER_SM)
stage1_kernel(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap r_map,
              const int32_t* __restrict__ r_rows,
              const int32_t* __restrict__ q_rows, int n_tiles, int K,
              int M2, int NRB, int H, int32_t* __restrict__ p_sum,
              int32_t* __restrict__ p_a, int32_t* __restrict__ p_b) {
  using T = K2Tile<CONS, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzle atoms
  const uint32_t sA = base, sB = sA + K2_STAGES * T::A_BYTES;
  const uint32_t full = sB + K2_STAGES * T::B_BYTES;
  const uint32_t empty = full + K2_STAGES * 8;
  const int ntm = (M2 + T::BM - 1) / T::BM;
  const int ntn = (NRB + BN - 1) / BN;
  const int nkb = (H + K2_KB - 1) / K2_KB;

  if (threadIdx.x == 0) {
    for (int s = 0; s < K2_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONS) {
    // Producer: one thread keeps the ring full.
    if constexpr (CONS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int task, m0, n0;
        k2_tile(tile, K, ntm, ntn, T::BM, BN, task, m0, n0);
        const int qg = q_rows[task], rg = r_rows[task / K];
        for (int kb = 0; kb < nkb; ++kb) {
          const uint32_t f = full + 8 * stage;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(f, T::A_BYTES + T::B_BYTES);
          tma_load_5d(sA + stage * T::A_BYTES, &q_map, f, kb * K2_KB,
                      m0 / 16, qg);
          tma_load_3d(sB + stage * T::B_BYTES, &r_map, f, kb * K2_KB, n0, rg);
          if (++stage == K2_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumers: 64 tile rows each.
  if constexpr (CONS == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int NQB = M2 >> 1;
  int acc[BN / 2];
#pragma unroll
  for (int c = 0; c < BN / 2; ++c) acc[c] = 0;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int task, m0, n0;
    k2_tile(tile, K, ntm, ntn, T::BM, BN, task, m0, n0);
    int prev = -1;  // the stage in use until its products are done
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(full + 8 * stage, phase);
      const uint64_t a_desc =
          smem_desc(sA + stage * T::A_BYTES + wg * 64 * K2_KB);
      const uint64_t b_desc = smem_desc(sB + stage * T::B_BYTES);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < K2_KB / K2_KSTEP; ++s)  // +32 bytes a step
        wgmma_ss(acc, a_desc + 2 * s, b_desc + 2 * s, kb | s);
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && tid == 0) mbar_arrive(empty + 8 * prev);
      prev = stage;
      if (++stage == K2_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (tid == 0) mbar_arrive(empty + 8 * prev);
#pragma unroll
    for (int c = 0; c < BN / 2; ++c) fence_operand(acc[c]);

    // Epilogue. acc[4 * c8 + 2 * h + e] is row 16 * warp + g + 8 * h of the
    // warpgroup's 64, column 8 * c8 + 2 * t + e of the tile; the A tile
    // holds the half rows of 8 query blocks a 16-row group, even halves
    // first, so rows g and g + 8 are half rows 2q and 2q + 1 of one query
    // block q: Ma and Mb sit in one thread. Columns past NRB (zeros from
    // TMA) count as column NRB - 1 with Ma = Mb = 0, which never beats it.
    int best_s = -1, best_a = -1, best_b = -1;
#pragma unroll
    for (int c8 = 0; c8 < BN / 8; ++c8) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ma = acc[4 * c8 + e], mb = acc[4 * c8 + 2 + e];
        const int col = min(n0 + 8 * c8 + 2 * t + e, NRB - 1);
        best_s = max(best_s, ((ma + mb) << RB_BITS) | col);
        best_a = max(best_a, (ma << RB_BITS) | col);
        best_b = max(best_b, (mb << RB_BITS) | col);
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      best_s = max(best_s, __shfl_xor_sync(FULL, best_s, o));
      best_a = max(best_a, __shfl_xor_sync(FULL, best_a, o));
      best_b = max(best_b, __shfl_xor_sync(FULL, best_b, o));
    }
    const int q = (m0 >> 1) + (wg * 4 + warp) * 8 + g;
    if (t == 0 && q < NQB) {
      const size_t o = (size_t)task * NQB + q;
      atomicMax(p_sum + o, best_s);
      atomicMax(p_a + o, best_a);
      atomicMax(p_b + o, best_b);
    }
  }
}

// ---- K3 ----------------------------------------------------------------
constexpr int K3_WARPS = 8;  // warps a CTA, a coarse block each
constexpr int NBANDS = 4;
constexpr int FINE = 32;
constexpr int K3_MIN_FPB = 2, K3_MAX_FPB = 13;  // V3_WQ 64-416
constexpr int T_BITS = 9;  // the election's shift (BAND <= 512)

struct BandArgs {
  const int8_t *roww_f, *roww_r, *fwd;
  const int32_t *r_rows, *rlens, *q_rows, *cnt1, *g1, *cnt2, *g2;
  int N, K, NQB, NRB, tband, smin, smin2;
  int8_t* cnt;
  int32_t* best;
  uint8_t *A, *S;
  int32_t* D;
};

__device__ __forceinline__ int band_tag(int b) {
  return (b < 2 ? 2048 : 0) | ((b & 1) ? 0 : 1024);
}

// The mirror of reference block g on the reverse strand of a reference of
// rlen bases, floor((rlen - 32 g - 32) / 32) clamped to [0, NRB - 1]: an
// int, so that >> is an arithmetic shift where the difference is negative.
__device__ __forceinline__ int mirror_block(int rlen, int g, int NRB) {
  return min(max((rlen - 32 * g - 32) >> 5, 0), NRB - 1);
}

// The wide row of band b (0, 2: candidates 1, 2 forward; 1, 3: their
// mirrors on the reverse strand) of a coarse block with candidates g1, g2.
__device__ __forceinline__ int band_row(int b, int g1, int g2, int rlen,
                                        int NRB) {
  const int g = b < 2 ? g1 : g2;
  return (b & 1) ? mirror_block(rlen, g, NRB) : g;
}

// Fine block k's counts in one band at every shift, and its running
// election max. Word c of a plane holds the row's bytes 16 + 32 c .. 47 +
// 32 c, so fine block k's window (row bytes 16 + 32 k ..) is words k ..,
// and lane `lane` takes shift t = 32 j + lane from bits lane .. lane + 31
// of words k + j and k + j + 1. VALID: the row or the query has codes
// other than 0-3, so the "is a base" planes take part.
template <int FPB, bool VALID>
__device__ __forceinline__ void fine_shifts(const uint32_t (&wl)[2 * FPB + 3],
                                            const uint32_t (&wh)[2 * FPB + 3],
                                            const uint32_t (&wv)[2 * FPB + 3],
                                            int k, uint32_t ql, uint32_t qh,
                                            uint32_t qv, int lane, int tag,
                                            int8_t* out, int& best) {
#pragma unroll
  for (int j = 0; j < FPB + 3; ++j) {
    uint32_t m = ~((ql ^ __funnelshift_r(wl[k + j], wl[k + j + 1], lane)) |
                   (qh ^ __funnelshift_r(wh[k + j], wh[k + j + 1], lane)));
    if (VALID) m &= __funnelshift_r(wv[k + j], wv[k + j + 1], lane) & qv;
    const int c = __popc(m);
    const int t = 32 * j + lane;
    out[t] = (int8_t)c;
    best = max(best, (c << 12) | tag | t);
  }
}

// A warp a coarse block q of task n (FPB fine blocks), the four bands one
// after the other. WQ = 32 FPB, BAND = WQ + 96 = 32 (FPB + 3) shifts, the
// windows WIN = BAND + 32 bytes, a row ROWW = 32 (2 FPB + 4) bytes: the
// 2 FPB + 3 plane words of a row hold every window of the coarse block.
template <int FPB>
__global__ void __launch_bounds__(K3_WARPS * 32)
bands_kernel(BandArgs a) {
  constexpr int WQ = FINE * FPB, BAND = WQ + 96, NW = 2 * FPB + 3;
  constexpr int ROWW = FINE * (2 * FPB + 4);
  const int lane = threadIdx.x & 31;
  const long long unit =
      (long long)blockIdx.x * K3_WARPS + (threadIdx.x >> 5);
  if (unit >= (long long)a.N * a.NQB) return;   // the whole warp leaves
  const int n = (int)(unit / a.NQB), q = (int)(unit % a.NQB);
  const int NBF = a.NQB * FPB;
  const int r = __ldg(a.r_rows + n / a.K), rlen = __ldg(a.rlens + n / a.K);
  const size_t o = (size_t)n * a.NQB + q;
  const int g1 = __ldg(a.g1 + o), g2 = __ldg(a.g2 + o);

  // The query's planes, a word a fine block (bit p: base p of the block).
  const int8_t* qp = a.fwd + (size_t)__ldg(a.q_rows + n) * NBF * FINE +
                     (size_t)q * WQ;
  int qc[FPB];
#pragma unroll
  for (int k = 0; k < FPB; ++k) qc[k] = __ldg(qp + FINE * k + lane);
  uint32_t ql[FPB], qh[FPB], qv[FPB];
#pragma unroll
  for (int k = 0; k < FPB; ++k) {
    ql[k] = __ballot_sync(FULL, qc[k] & 1);
    qh[k] = __ballot_sync(FULL, qc[k] & 2);
    qv[k] = __ballot_sync(FULL, (unsigned)qc[k] < 4u);
  }
  int best[FPB];
#pragma unroll
  for (int k = 0; k < FPB; ++k) best[k] = -1;

#pragma unroll 1
  for (int b = 0; b < NBANDS; ++b) {
    // The band's row, read in place: lane p loads byte p of each word.
    const int8_t* rp =
        ((b & 1) ? a.roww_r : a.roww_f) +
        ((size_t)r * a.NRB + band_row(b, g1, g2, rlen, a.NRB)) * ROWW + 16;
    int x[NW], any = 0;
#pragma unroll
    for (int c = 0; c < NW; ++c) {
      x[c] = __ldg(rp + FINE * c + lane);
      any |= x[c];
    }
    uint32_t wl[NW], wh[NW], wv[NW];
#pragma unroll
    for (int c = 0; c < NW; ++c) {
      wl[c] = __ballot_sync(FULL, x[c] & 1);
      wh[c] = __ballot_sync(FULL, x[c] & 2);
    }
    // Codes all in 0-3 (any other code sets a bit above bit 1): the
    // row's "is a base" plane is all ones.
    const bool bases = __all_sync(FULL, (unsigned)any < 4u);
    if (bases) {
#pragma unroll
      for (int c = 0; c < NW; ++c) wv[c] = FULL;
    } else {
#pragma unroll
      for (int c = 0; c < NW; ++c)
        wv[c] = __ballot_sync(FULL, (unsigned)x[c] < 4u);
    }
    const int tag = band_tag(b);
    int8_t* out =
        a.cnt + (((size_t)b * a.N + n) * NBF + (size_t)q * FPB) * BAND;
#pragma unroll
    for (int k = 0; k < FPB; ++k) {
      if (bases && qv[k] == FULL)
        fine_shifts<FPB, false>(wl, wh, wv, k, ql[k], qh[k], qv[k], lane,
                                tag, out + k * BAND, best[k]);
      else
        fine_shifts<FPB, true>(wl, wh, wv, k, ql[k], qh[k], qv[k], lane,
                               tag, out + k * BAND, best[k]);
    }
  }

  // The election of each fine block, decoded by lane k: the count, the
  // strand, the diagonal (the band's first, 32 g - (q + 1) WQ - 16, plus
  // the shift) and whether it is assigned.
#pragma unroll
  for (int k = 0; k < FPB; ++k) best[k] = __reduce_max_sync(FULL, best[k]);
  if (lane < FPB) {
    int bb = best[0];
    uint32_t v = qv[0];
#pragma unroll
    for (int k = 1; k < FPB; ++k)
      if (lane == k) {
        bb = best[k];
        v = qv[k];
      }
    const int cb = bb >> 12;
    const bool c1 = (bb & 2048) != 0, rev = (bb & 1024) == 0;
    const int g = band_row((c1 ? 0 : 2) + rev, g1, g2, rlen, a.NRB);
    // Candidate 2 carries half-block counts: its gate is smin2.
    const bool gate = c1 ? __ldg(a.cnt1 + o) >= a.smin
                         : __ldg(a.cnt2 + o) >= a.smin2;
    // The threshold scales down on blocks with fewer valid query bases.
    const int tb = min(max((__popc(v) * a.tband) >> 5, 4), a.tband);
    const size_t f = (size_t)n * NBF + (size_t)q * FPB + lane;
    a.best[f] = cb;
    a.A[f] = (uint8_t)(cb >= tb && gate);
    a.S[f] = (uint8_t)rev;
    a.D[f] = 32 * g - (q + 1) * WQ - 16 + (bb & ((1 << T_BITS) - 1));
  }
}

template <int FPB>
int launch_bands(const BandArgs& a, cudaStream_t s) {
  const long long warps = (long long)a.N * a.NQB;
  const long long ctas = (warps + K3_WARPS - 1) / K3_WARPS;
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  bands_kernel<FPB><<<(int)ctas, K3_WARPS * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// ---- K5 ----------------------------------------------------------------
constexpr int K5_WARPS = 4;               // warps a CTA, a tile each
constexpr int K5_BPT = 4;                 // blocks a lane: lane + 32 j
constexpr int K5_TILE = 32 * K5_BPT;      // blocks a tile holds, halo included
constexpr int K5_MAX_ITERS = 16;          // VCLUST_ALIGN_EXTI's range
constexpr int K5_MAX_NBF = 8192;          // 2^13 reference blocks (R2's guard)
constexpr int K5_UNROLL = 4;              // 4-block groups whose flags load at once
constexpr int K5_GATHER = 8;              // candidate tasks a lane loads at once

struct PropArgs {
  const int8_t* cnt;
  const uint8_t *A0, *S0;
  const int32_t *D0, *best;
  const int8_t *roww_f, *roww_r, *fwd;
  const int32_t *r_rows, *rlens, *q_rows, *g1, *g2;
  int N, K, NBF, FPB, NRB, roww, band, iters, ext_min, ext_margin, cont, out,
      tiles;
  unsigned long long fpb_magic;   // ceil(2^32 / FPB): f / FPB as a product
  uint8_t *m1, *m0, *sw, *A, *S;
  int32_t* D;
  uint8_t *Ap, *Sp;
  int32_t* Dp;
};

// Shared memory of a warp, by tile index: the four bands' first diagonals,
// the initial diagonals, the windows the flags read (4 x int32: strand <<
// 30 | the window's byte in its reference's rows of that strand, or -1;
// m1's two bands, then m0's), the initial strands (bit 0; bit 1 marks a
// block outside the pair, bit 2 an assigned one) and the candidate table.
constexpr int K5_AT_D0 = 16 * K5_TILE, K5_AT_FP = 20 * K5_TILE,
              K5_AT_S0 = 36 * K5_TILE, K5_AT_CAND = 37 * K5_TILE;
__host__ __device__ constexpr int k5_warp_bytes(int iters) {
  return (K5_AT_CAND + K5_TILE * (2 * iters + 1) + 15) / 16 * 16;
}

// A block's state in a register: its source block in the tile (bits
// 0-7), strand (bit 8), assigned (bit 9); the diagonal beside it.
constexpr uint32_t K5_SRC = 255u, K5_STRAND = 256u, K5_ASG = 512u;

// f / FPB for 0 <= f < 2^28, with magic = ceil(2^32 / FPB) (FPB <= 13).
__device__ __forceinline__ int coarse_of(int f, unsigned long long magic) {
  return (int)(((unsigned long long)(unsigned)f * magic) >> 32);
}

// The window of one flag array of a block in band b (strand s: bands s
// and s + 2) holding diagonal d: strand << 30 | its byte at that shift in
// the reference's rows of the strand, row (first + lead) / 32 (lead = (fc
// + 1) WQ + 16) at byte `at` (16 + 32 (f % FPB)) plus the shift; or -1.
__device__ __forceinline__ int k5_window(const int32_t* bs, int i, int b,
                                         int d, int band, int lead, int at,
                                         int roww) {
  const int first = bs[b * K5_TILE + i], tn = d - first;
  return (unsigned)tn < (unsigned)band
             ? (b & 1) << 30 | (((first + lead) >> 5) * roww + at + tn)
             : -1;
}

__global__ void __launch_bounds__(K5_WARPS * 32)
propagate_kernel(PropArgs a) {
  extern __shared__ __align__(16) uint8_t k5_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long unit = (long long)blockIdx.x * K5_WARPS + warp;
  if (unit >= (long long)a.N * a.tiles) return;   // the whole warp leaves
  const int E = a.iters, C = 2 * E + 1;
  uint8_t* mine = k5_smem + warp * k5_warp_bytes(E);
  int32_t* bs = reinterpret_cast<int32_t*>(mine);   // [4][K5_TILE]
  int32_t* d0s = reinterpret_cast<int32_t*>(mine + K5_AT_D0);
  int4* fp = reinterpret_cast<int4*>(mine + K5_AT_FP);
  uint8_t* s0s = mine + K5_AT_S0;
  int8_t* cand = reinterpret_cast<int8_t*>(mine + K5_AT_CAND);
  const int n = (int)(unit / a.tiles), t = (int)(unit % a.tiles);
  // Tile t writes blocks o_t .. and holds blocks f_lo .. f_lo + K5_TILE - 1:
  // the first tile from block 0 (nothing lies left of it), the others with
  // EXT_ITERS + 1 blocks of halo on their left; each writes up to
  // EXT_ITERS blocks before the end of what it holds, or to the pair's end
  // where it holds it.
  const int o_t = t ? K5_TILE - E + (t - 1) * a.out : 0;
  const int f_lo = t ? o_t - (E + 1) : 0;   // the block at tile index 0
  const int f_end = f_lo + K5_TILE >= a.NBF ? a.NBF : f_lo + K5_TILE - E;
  const size_t row = (size_t)n * a.NBF;
  const size_t plane = (size_t)a.N * a.NBF;   // a band's blocks
  const int NQB = a.NBF / a.FPB, WQ = FINE * a.FPB;
  const int r = __ldg(a.r_rows + n / a.K), rlen = __ldg(a.rlens + n / a.K);

  // 1. The tile's blocks, lane + 32 j in lane j: state, count, the four
  //    bands' first diagonals from the coarse block's candidates, 32 g -
  //    (fc + 1) WQ - 16 (every load coalesced, all issued before the first
  //    use). Blocks outside the pair are unassigned at (forward, 0), as the
  //    plain version's shifts fill them, and adopt nothing.
  int d[K5_BPT], cc[K5_BPT], bsj[K5_BPT][4];
  uint32_t mt[K5_BPT];
  uint8_t s0[K5_BPT], a0[K5_BPT];
  unsigned real = 0;
#pragma unroll
  for (int j = 0; j < K5_BPT; ++j) {
    const int f = f_lo + lane + 32 * j;
    const bool in = f >= 0 && f < a.NBF;
    const size_t o = row + (in ? f : 0);
    const int fc = in ? coarse_of(f, a.fpb_magic) : 0;
    const size_t oc = (size_t)n * NQB + fc;
    real |= (unsigned)in << j;
    d[j] = in ? __ldg(a.D0 + o) : 0;
    s0[j] = in ? __ldg(a.S0 + o) : 0;
    a0[j] = in ? __ldg(a.A0 + o) : 0;
    cc[j] = in ? __ldg(a.best + o) : -1;
    const int g1 = in ? __ldg(a.g1 + oc) : 0, g2 = in ? __ldg(a.g2 + oc) : 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      bsj[j][b] = in ? 32 * band_row(b, g1, g2, rlen, a.NRB) -
                           (fc + 1) * WQ - 16
                     : 0;
  }
#pragma unroll
  for (int j = 0; j < K5_BPT; ++j) {
    const int i = lane + 32 * j;
    mt[j] = (uint32_t)i | (s0[j] ? K5_STRAND : 0u) | (a0[j] ? K5_ASG : 0u);
    if (!a0[j]) cc[j] = -1;
#pragma unroll
    for (int b = 0; b < 4; ++b) bs[b * K5_TILE + i] = bsj[j][b];
    d0s[i] = d[j];
    s0s[i] = (uint8_t)((s0[j] ? 1u : 0u) | ((real >> j) & 1u ? 0u : 2u) |
                       (a0[j] ? 4u : 0u));
  }
  __syncwarp();

  // 2. The candidate table: cand[i * C + c] is block i's count at the
  //    initial (strand, diagonal) of block g = i - E + c, the largest over
  //    the two bands of that strand that hold the diagonal, or -1. Only an
  //    initially assigned g's state ever reaches a neighbour as an assigned
  //    state (adopting replaces the source), so the others are never read
  //    and load nothing; nor does a candidate whose state equals the one
  //    before it (a diagonal holds over runs of blocks): it takes the first
  //    of its run's count, in a second pass. cp lanes a block (cp >= C, a
  //    power of two), so a load instruction reads 32 / cp rows; a lane
  //    issues K5_GATHER tasks' loads before it uses any.
  {
    int cp = 1;
    while (cp < C) cp <<= 1;
    const int lg = __ffs(cp) - 1;
    const int r_lo = max(0, -f_lo), r_hi = min(K5_TILE, a.NBF - f_lo);
    for (int t0 = r_lo * cp; t0 < r_hi * cp; t0 += 32 * K5_GATHER) {
      int x0[K5_GATHER], x2[K5_GATHER], head[K5_GATHER];
#pragma unroll
      for (int u = 0; u < K5_GATHER; ++u) {
        const int task = t0 + 32 * u + lane;
        const int i = task >> lg, c = task & (cp - 1), g = i - E + c;
        head[u] = -1;   // -1: nothing to store; c: a load; < c: a copy
        x0[u] = x2[u] = -1;
        if (task >= r_hi * cp || c >= C) continue;
        head[u] = c;
        if (g < 0 || g >= K5_TILE || !(s0s[g] & 4)) continue;
        const int s = s0s[g] & 1, dg = d0s[g];
        int h = c;   // the first candidate of this state's run
        while (h > 0 && g - (c - h) - 1 >= 0 &&
               (s0s[g - (c - h) - 1] & 5) == (4 | s) &&
               d0s[g - (c - h) - 1] == dg)
          --h;
        head[u] = h;
        if (h < c) continue;
        const size_t o = row + f_lo + i;
        const int t_a = dg - bs[s * K5_TILE + i];
        const int t_b = dg - bs[(s + 2) * K5_TILE + i];
        if ((unsigned)t_a < (unsigned)a.band)
          x0[u] = __ldg(a.cnt + (s * plane + o) * a.band + t_a);
        if ((unsigned)t_b < (unsigned)a.band)
          x2[u] = __ldg(a.cnt + ((s + 2) * plane + o) * a.band + t_b);
      }
#pragma unroll
      for (int u = 0; u < K5_GATHER; ++u) {
        const int task = t0 + 32 * u + lane;
        const int i = task >> lg, c = task & (cp - 1);
        if (head[u] < 0) continue;
        cand[i * C + c] =
            (int8_t)(head[u] < c ? -2 - head[u] : max(x0[u], x2[u]));
      }
    }
    __syncwarp();
    for (int task = r_lo * cp + lane; task < r_hi * cp; task += 32) {
      const int i = task >> lg, c = task & (cp - 1);
      if (c >= C) continue;
      const int v = cand[i * C + c];
      if (v <= -2) cand[i * C + c] = cand[i * C + (-2 - v)];
    }
  }
  __syncwarp();

  // 3. The steps, from the block before, then from the block after. A
  //    neighbour's state is read from before the step; past the tile's
  //    ends the neighbour counts as unassigned (only the halo is wrong).
  for (int step = 0; step < 2 * E; ++step) {
    int nd[K5_BPT];
    uint32_t nm[K5_BPT];
    if (step & 1) {            // block i + 1: lane + 1, or lane 0 of j + 1
#pragma unroll
      for (int j = 0; j < K5_BPT; ++j) {
        nd[j] = __shfl_down_sync(FULL, d[j], 1);
        nm[j] = __shfl_down_sync(FULL, mt[j], 1);
        const int wd = __shfl_sync(FULL, d[(j + 1) % K5_BPT], 0);
        const uint32_t wm = __shfl_sync(FULL, mt[(j + 1) % K5_BPT], 0);
        if (lane == 31) {
          nd[j] = wd;
          nm[j] = j + 1 < K5_BPT ? wm : 0u;
        }
      }
    } else {                   // block i - 1: lane - 1, or lane 31 of j - 1
#pragma unroll
      for (int j = 0; j < K5_BPT; ++j) {
        nd[j] = __shfl_up_sync(FULL, d[j], 1);
        nm[j] = __shfl_up_sync(FULL, mt[j], 1);
        const int wd = __shfl_sync(FULL, d[(j + K5_BPT - 1) % K5_BPT], 31);
        const uint32_t wm =
            __shfl_sync(FULL, mt[(j + K5_BPT - 1) % K5_BPT], 31);
        if (lane == 0) {
          nd[j] = wd;
          nm[j] = j ? wm : 0u;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < K5_BPT; ++j) {
      const int i = lane + 32 * j;
      int cn = -1;
      if (((real >> j) & 1u) && (nm[j] & K5_ASG) &&
          (nd[j] != d[j] || ((nm[j] ^ mt[j]) & K5_STRAND)))
        cn = cand[i * C + (int)(nm[j] & K5_SRC) - i + E];
      const bool asg = (mt[j] & K5_ASG) != 0;
      const bool better = cn >= a.ext_min && cn > cc[j] + a.ext_margin;
      const bool cont = asg && cn >= a.ext_min && cn + a.cont >= cc[j] &&
                        cn <= cc[j];
      if (better || cont) {
        d[j] = nd[j];
        mt[j] = (nm[j] & (K5_SRC | K5_STRAND)) | (mt[j] & K5_ASG);
        cc[j] = cn;
      }
      if (better) mt[j] |= K5_ASG;
    }
  }

  // 4. The tile's own blocks, o_t .. f_end - 1: the state and the previous
  //    block's (none before block 0), coalesced; the windows their flags
  //    read, into shared memory.
  const int i_lo = o_t - f_lo, i_hi = f_end - f_lo;
#pragma unroll
  for (int j = 0; j < K5_BPT; ++j) {
    int dp = __shfl_up_sync(FULL, d[j], 1);
    uint32_t mp = __shfl_up_sync(FULL, mt[j], 1);
    const int wd = __shfl_sync(FULL, d[(j + K5_BPT - 1) % K5_BPT], 31);
    const uint32_t wm = __shfl_sync(FULL, mt[(j + K5_BPT - 1) % K5_BPT], 31);
    if (lane == 0) {
      dp = j ? wd : 0;
      mp = j ? wm : 0u;
    }
    const int i = lane + 32 * j;
    if (i < i_lo || i >= i_hi) continue;
    const int s = (mt[j] & K5_STRAND) != 0, sp = (mp & K5_STRAND) != 0;
    const bool asg = (mt[j] & K5_ASG) != 0, ap = (mp & K5_ASG) != 0;
    const bool sw = asg && ap && (d[j] != dp || s != sp);
    const size_t o = row + f_lo + i;
    a.D[o] = d[j];
    a.S[o] = (uint8_t)s;
    a.A[o] = (uint8_t)asg;
    a.Dp[o] = dp;
    a.Sp[o] = (uint8_t)sp;
    a.Ap[o] = (uint8_t)ap;
    a.sw[o] = (uint8_t)sw;
    const int fc = coarse_of(f_lo + i, a.fpb_magic);
    const int lead = (fc + 1) * WQ + 16;
    const int at = 16 + FINE * (f_lo + i - fc * a.FPB);
    int4 w = make_int4(-1, -1, -1, -1);
    if (asg) {
      w.x = k5_window(bs, i, s, d[j], a.band, lead, at, a.roww);
      w.y = k5_window(bs, i, s + 2, d[j], a.band, lead, at, a.roww);
    }
    if (sw) {
      w.z = k5_window(bs, i, sp, dp, a.band, lead, at, a.roww);
      w.w = k5_window(bs, i, sp + 2, dp, a.band, lead, at, a.roww);
    }
    fp[i] = w;
  }
  __syncwarp();

  // 5. The flags, 4 blocks at a time over the warp, 8 lanes a block and
  //    4 positions a lane: the query bases and each band's window are read
  //    as words (a window's two aligned words funnel-shifted to its shift)
  //    and compared 4 bytes at a time; each lane writes a word of each flag
  //    row. K5_UNROLL such groups' loads are in flight at once. Band b's
  //    window of block f is bytes 16 + 32 (f % FPB) .. of its row g, whose
  //    first diagonal is 32 g - (f / FPB + 1) WQ - 16 (step 4 put the byte
  //    at the shift in the table); the query bases are the query's codes
  //    32 f .. 32 f + 31.
  const int gi = lane >> 3, gk = lane & 7;
  const int8_t* qrow = a.fwd + (size_t)__ldg(a.q_rows + n) * a.NBF * FINE;
  const size_t ref = (size_t)r * a.NRB * a.roww;
  const int8_t *rows_f = a.roww_f + ref, *rows_r = a.roww_r + ref;
  for (int i0 = i_lo; i0 < i_hi; i0 += 4 * K5_UNROLL) {
    uint32_t q[K5_UNROLL], lo[K5_UNROLL][4], hi[K5_UNROLL][4];
#pragma unroll
    for (int u = 0; u < K5_UNROLL; ++u) {
      const int i = i0 + 4 * u + gi;
      q[u] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) lo[u][k] = hi[u][k] = 0xffffffffu;
      if (i >= i_hi) continue;
      const int4 wp = fp[i];
      const int ws[4] = {wp.x, wp.y, wp.z, wp.w};
      if ((ws[0] & ws[1] & ws[2] & ws[3]) >= 0)   // a window is used
        q[u] = __ldg(reinterpret_cast<const uint32_t*>(
                         qrow + (size_t)(f_lo + i) * FINE) + gk);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (ws[k] < 0) continue;
        const int at = ws[k] & ((1 << 30) - 1);
        const uint32_t* p = reinterpret_cast<const uint32_t*>(
            ((ws[k] >> 30) ? rows_r : rows_f) + (at & ~3)) + gk;
        lo[u][k] = __ldg(p);
        if (at & 3) hi[u][k] = __ldg(p + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < K5_UNROLL; ++u) {
      const int i = i0 + 4 * u + gi;
      if (i >= i_hi) continue;
      const size_t o = (row + f_lo + i) * FINE;
      const int4 wp = fp[i];
      const int ws[4] = {wp.x, wp.y, wp.z, wp.w};
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)   // an unused window stays 0xffffffff
        w[k] = __funnelshift_r(lo[u][k], hi[u][k], 8 * (ws[k] & 3));
      // Bytes 1 where the query base is a base (< 4) and equals a window's;
      // an unused window (0xff bytes) equals no code.
      const uint32_t qok = __vcmpltu4(q[u], 0x04040404u) & 0x01010101u;
      const uint32_t h1 = __vcmpeq4(w[0], q[u]) | __vcmpeq4(w[1], q[u]);
      const uint32_t h0 = __vcmpeq4(w[2], q[u]) | __vcmpeq4(w[3], q[u]);
      reinterpret_cast<uint32_t*>(a.m1 + o)[gk] = h1 & qok;
      reinterpret_cast<uint32_t*>(a.m0 + o)[gk] = h0 & qok;
    }
  }
}

int launch_propagate(const PropArgs& a, cudaStream_t s) {
  const long long warps = (long long)a.N * a.tiles;
  const long long ctas = (warps + K5_WARPS - 1) / K5_WARPS;
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  propagate_kernel<<<(int)ctas, K5_WARPS * 32,
                     K5_WARPS * k5_warp_bytes(a.iters), s>>>(a);
  return (int)cudaGetLastError();
}

// ---- host: tensor maps and launches -------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes from this on are CUresult values of the tensor-map encoder.
constexpr int ENCODE_ERROR = 100000;

// A u8 tensor map of `rank` dimensions (innermost first, strides in bytes
// of dimensions 1 on), read in boxes of 128 bytes x ... with the 128-byte
// swizzle; zeros outside the tensor.
int encode_u8(CUtensorMap* map, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  CUresult cr = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
                       const_cast<void*>(ptr), dims, strides, box, elem,
                       CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return cr == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)cr;
}

// The reference arena (G, NRB, H): boxes of box_rows blocks x 128 buckets.
int encode_rocc(CUtensorMap* map, const void* ptr, int G, int NRB, int H,
                int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)NRB, (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)H, (cuuint64_t)NRB * H};
  const cuuint32_t box[3] = {K2_KB, (cuuint32_t)box_rows, 1};
  return encode_u8(map, ptr, 3, dims, strides, box);
}

// The query arena (G, M2, H) seen as (G, NQB / 8, 2, 8, H): query block
// 8 qh + ql, half p at (k, ql, p, qh, g). A box of box_rows half rows holds
// box_rows / 16 groups of 8 query blocks, each as their 8 even half rows,
// then their 8 odd ones. M2 % 16 == 0.
int encode_qocc(CUtensorMap* map, const void* ptr, int G, int M2, int H,
                int box_rows) {
  const cuuint64_t dims[5] = {(cuuint64_t)H, 8, 2, (cuuint64_t)M2 / 16,
                              (cuuint64_t)G};
  const cuuint64_t strides[4] = {2 * (cuuint64_t)H, (cuuint64_t)H,
                                 16 * (cuuint64_t)H, (cuuint64_t)M2 * H};
  const cuuint32_t box[5] = {K2_KB, 8, 2, (cuuint32_t)box_rows / 16, 1};
  return encode_u8(map, ptr, 5, dims, strides, box);
}

template <int CONS, int BN>
int launch_stage1(const uint8_t* qocc, const uint8_t* rocc,
                  const int32_t* r_rows, const int32_t* q_rows, int tasks,
                  int K, int Gq, int Gr, int M2, int NRB, int H,
                  int32_t* p_sum, int32_t* p_a, int32_t* p_b,
                  cudaStream_t s) {
  using T = K2Tile<CONS, BN>;
  static bool configured[MAX_DEVICES] = {};  // the attribute is per device
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        stage1_kernel<CONS, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  CUtensorMap q_map, r_map;
  int rc;
  if ((rc = encode_qocc(&q_map, qocc, Gq, M2, H, T::BM)) ||
      (rc = encode_rocc(&r_map, rocc, Gr, NRB, H, BN)))
    return rc;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (long long)tasks * ((M2 + T::BM - 1) / T::BM) *
                          ((NRB + BN - 1) / BN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int ctas = (int)(tiles < (long long)sms * T::CTAS_PER_SM
                             ? tiles
                             : (long long)sms * T::CTAS_PER_SM);
  stage1_kernel<CONS, BN><<<ctas, T::THREADS, T::SMEM, s>>>(
      q_map, r_map, r_rows, q_rows, (int)tiles, K, M2, NRB, H, p_sum, p_a,
      p_b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2. qocc: (Gq, M2, H) int8 {0,1}; rocc: (Gr, NRB, H) int8 {0,1}; both
// contiguous and 16-byte aligned, H % 16 == 0 (TMA), M2 % 16 == 0 (the
// query arena is read in groups of 8 query blocks); r_rows: (tasks / K,)
// int32; q_rows: (tasks,) int32; p_sum, p_a, p_b: (tasks, M2 / 2) int32,
// zeroed by the caller. Returns 0 or an error code.
int k2_stage1(const uint8_t* qocc, const uint8_t* rocc, const int32_t* r_rows,
              const int32_t* q_rows, int tasks, int K, int Gq, int Gr, int M2,
              int NRB, int H, int32_t* p_sum, int32_t* p_a, int32_t* p_b,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tasks < 1 || K < 1 || tasks % K || M2 < 16 || M2 % 16 || NRB < 1 ||
      H < 16 || H % 16 || Gq < 1 || Gr < 1)
    return (int)cudaErrorInvalidValue;
  if (M2 <= 64 && NRB <= 128)
    return launch_stage1<1, 128>(qocc, rocc, r_rows, q_rows, tasks, K, Gq, Gr,
                                 M2, NRB, H, p_sum, p_a, p_b, s);
  return launch_stage1<2, 256>(qocc, rocc, r_rows, q_rows, tasks, K, Gq, Gr,
                               M2, NRB, H, p_sum, p_a, p_b, s);
}

// K3. roww_f, roww_r: (Gr, NRB, 32 (2 FPB + 4)) int8, the wide rows of
// both strands; fwd: (Gq, NQB * 32 FPB) int8, the query codes; codes 0-4
// (a base is 0-3); r_rows, rlens: (N / K,) int32; q_rows: (N,) int32;
// cnt1, g1, cnt2, g2: (N, NQB) int32, stage 1's candidates (g1, g2 in
// [0, NRB)); 2 <= FPB <= 13. Writes cnt: (4, N, NQB * FPB, 32 (FPB + 3))
// int8, the band counts, and the decoded election best, D: (N, NQB * FPB)
// int32, A, S: (N, NQB * FPB) bool. Returns cudaGetLastError().
int k3_row_bands(const int8_t* roww_f, const int8_t* roww_r,
                 const int8_t* fwd, const int32_t* r_rows,
                 const int32_t* rlens, const int32_t* q_rows,
                 const int32_t* cnt1, const int32_t* g1, const int32_t* cnt2,
                 const int32_t* g2, int N, int K, int NQB, int NRB, int FPB,
                 int tband, int smin, int smin2, int8_t* cnt, int32_t* best,
                 uint8_t* A, uint8_t* S, int32_t* D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || K < 1 || N % K || NQB < 1 || NRB < 1 || FPB < K3_MIN_FPB ||
      FPB > K3_MAX_FPB)
    return (int)cudaErrorInvalidValue;
  const BandArgs a{roww_f, roww_r, fwd, r_rows, rlens, q_rows, cnt1, g1,
                   cnt2,   g2,     N,   K,      NQB,   NRB,    tband, smin,
                   smin2,  cnt,    best, A,     S,     D};
  switch (FPB) {
#define K3_CASE(fpb) \
  case fpb:          \
    return launch_bands<fpb>(a, s);
    K3_CASE(2) K3_CASE(3) K3_CASE(4) K3_CASE(5) K3_CASE(6) K3_CASE(7)
    K3_CASE(8) K3_CASE(9) K3_CASE(10) K3_CASE(11) K3_CASE(12) K3_CASE(13)
#undef K3_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// K5. cnt: (4, N, NBF, band) int8, K3's band counts (band a multiple of 4);
// A0, S0: (N, NBF) bool, D0, best: (N, NBF) int32, the election; roww_f,
// roww_r: (Gr, NRB, roww) int8, the wide rows K3 read, and fwd: (Gq, NBF *
// 32) int8, the query codes, each 4-byte aligned (roww a multiple of 32, at
// least 32 FPB - 16 + band + 32: a window never leaves its row); r_rows,
// rlens: (N / K,) int32; q_rows: (N,) int32; g1, g2: (N, NBF / FPB) int32,
// stage 1's candidates in [0, NRB). Writes m1, m0: (N, NBF * 32) bool
// (4-byte aligned) and sw, A, S, Ap, Sp: (N, NBF) bool, D, Dp: (N, NBF)
// int32. NBF <= 8192, 0 <= iters <= 16, ext_min >= 1, ext_margin >= 0 (a
// block that reads no count adopts nothing). Returns cudaGetLastError().
int k5_propagate(const int8_t* cnt, const uint8_t* A0, const uint8_t* S0,
                 const int32_t* D0, const int32_t* best, const int8_t* roww_f,
                 const int8_t* roww_r, const int8_t* fwd,
                 const int32_t* r_rows, const int32_t* rlens,
                 const int32_t* q_rows, const int32_t* g1, const int32_t* g2,
                 int N, int K, int NBF, int FPB, int NRB, int roww, int band,
                 int iters, int ext_min, int ext_margin, int cont,
                 uint8_t* m1, uint8_t* m0, uint8_t* sw, uint8_t* A,
                 uint8_t* S, int32_t* D, uint8_t* Ap, uint8_t* Sp,
                 int32_t* Dp, void* stream) {
  if (N < 1 || K < 1 || N % K || NBF < 1 || NBF > K5_MAX_NBF || FPB < 1 ||
      FPB > 64 || NBF % FPB || NRB < 1 || roww % 32 ||
      (long long)NRB * roww >= 1 << 30 ||
      roww < FINE * FPB - 16 + band + FINE || band < 4 || band > 1024 ||
      band % 4 || iters < 0 || iters > K5_MAX_ITERS || ext_min < 1 ||
      ext_margin < 0)
    return (int)cudaErrorInvalidValue;
  // Blocks a tile after the first writes; the first writes K5_TILE -
  // iters, or the whole pair if it holds it.
  const int out = K5_TILE - 2 * iters - 1;
  const int tiles = 1 + (max(NBF - K5_TILE, 0) + out - 1) / out;
  const unsigned long long magic = ((1ull << 32) + FPB - 1) / FPB;
  const PropArgs a{cnt,    A0,     S0,     D0,     best,   roww_f, roww_r,
                   fwd,    r_rows, rlens,  q_rows, g1,     g2,     N,
                   K,      NBF,    FPB,    NRB,    roww,   band,   iters,
                   ext_min, ext_margin, cont, out, tiles, magic, m1, m0, sw,
                   A,      S,      D,      Ap,     Sp,     Dp};
  return launch_propagate(a, static_cast<cudaStream_t>(stream));
}

const char* vk_error_string(int code) {
  static char buf[64];
  if (code >= ENCODE_ERROR) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - ENCODE_ERROR);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
