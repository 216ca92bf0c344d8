// K2, K3 and K5: stage 1, the banded eval and the propagation of the v3
// align pipe.
//
// Replace the XLA device programs of the JAX package's `_row_core_v3` (its
// ops/align_tpu.py): stage 1, the occupancy product with its packed maxes
// (:1108-1157), stages 3-4, the band counts and their election
// (:1175-1212), and stages 5-6, the neighbour propagation and the final
// flags (:1235-1290). All are bit-exact with the plain torch versions
// beside their wrappers in ops/align_gpu.py (`stage1_pack_plain`,
// `band_counts_plain`, `propagate_v3_plain`).
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
// K3 (k3_bands). For every fine block f (32 query bases) and each of the
// four bands (candidate 1 and 2, forward and reverse), the count of valid
// query bases equal to the window base at each of BAND = WIN-32 shifts,
// written as int8 (stages 5-6 read them), and the election: the max over
// bands and shifts of (count << 12) | tag | shift, tags 3072 (candidate 1,
// forward), 2048 (candidate 1, reverse), 1024 (candidate 2, forward), 0
// (candidate 2, reverse), so ties go to candidate 1, then the forward
// strand, then the larger shift. Code contract: a code is a base only in
// 0-3 (the path's codes are 0-4, N and the window pads being 4), which is
// what makes the bit planes below equal to the plain byte compares.
// What bounds it, and what the design does about it:
//   * Operations: a base is three bits (low, high, "is a base"), so a fine
//     block's 32 compares at one shift are one word each of three planes:
//     3 funnel shifts align the window's planes to the shift, 3 logic ops
//     give ~(ql ^ wl) & ~(qh ^ wh) & qv & wv, a population count (4 issue
//     slots) and 3 for the packed max: 13 int32 issue slots a fine block,
//     band and shift against 64 slots an SM and clock.
//   * Bytes: the windows read once and the counts written once (at the B =
//     26 dispatch 436 and 382 MB), nearly as long as the operations.
//   * Design: one warp a fine block, persistent CTAs in a grid stride. A
//     lane loads one byte of each 32-byte chunk of the four windows (all
//     loads issued before the first use) and __ballot_sync turns a chunk
//     into one word of each plane, the same in every lane; lanes then take
//     the shifts, so a warp's byte stores of a count row are contiguous;
//     the election stays in a register until one __reduce_max_sync. No
//     shared memory, no __syncthreads. A band whose window and query hold
//     only codes 0-3 (most of them: N runs and pads are rare) skips the
//     "is a base" planes: 2 votes a chunk, 2 funnel shifts and 1 logic op
//     a shift. The loop is uniform across the CTA (a warp past the last
//     block recounts it and stores the same bytes), so the votes compile
//     without reconvergence code.
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
//     bytes of the bands that hold a flag's diagonal (one or two sectors),
//     the per-block state read once and the flags written once. The band
//     counts and windows are read only where a gather needs them (a few
//     percent of the 436 and 382 MB of the B = 26 dispatch).
//   * Design: one CTA a pair; the pair's (diagonal, strand, assigned,
//     count) of all NBF blocks (at most 8,192 under R2's guard) live in
//     shared memory, twice, so a step reads the state from before it and
//     writes the other copy, with one __syncthreads a step. Then a warp a
//     block writes the flags, a lane a position: 32 consecutive bytes of
//     the window and of the output each.

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
constexpr int K3_WARPS = 8;  // warps a CTA, one fine block each at a time
constexpr int NBANDS = 4;
constexpr int FINE = 32;
constexpr int MAX_CHUNKS = (512 + FINE) / 32;  // BAND <= 512 (9 bits)

__device__ __forceinline__ int band_tag(int b) {
  return (b < 2 ? 2048 : 0) | ((b & 1) ? 0 : 1024);
}

// One band's counts at every shift and its running election max. Lane
// `lane` takes shift t = 32 j + lane: window bases t .. t + 31 are bits
// lane .. lane + 31 of plane words j and j + 1. VALID: the window or the
// query has codes other than 0-3, so the "is a base" planes take part.
template <int NC, bool VALID>
__device__ __forceinline__ void band_shifts(const int (&x)[NC], uint32_t ql,
                                            uint32_t qh, uint32_t qv,
                                            int lane, int band, int tag,
                                            int8_t* out, int& best) {
  uint32_t wl[NC], wh[NC], wv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    wl[c] = __ballot_sync(FULL, x[c] & 1);
    wh[c] = __ballot_sync(FULL, x[c] & 2);
    if (VALID) wv[c] = __ballot_sync(FULL, (unsigned)x[c] < 4u);
  }
#pragma unroll
  for (int j = 0; j + 1 < NC; ++j) {
    const int tt = 32 * j + lane;
    uint32_t m = ~((ql ^ __funnelshift_r(wl[j], wl[j + 1], lane)) |
                   (qh ^ __funnelshift_r(wh[j], wh[j + 1], lane)));
    if (VALID) m &= __funnelshift_r(wv[j], wv[j + 1], lane) & qv;
    const int c = __popc(m);
    if (tt < band) {
      out[tt] = (int8_t)c;
      best = max(best, (c << 12) | tag | tt);
    }
  }
}

// NC: 32-byte chunks of a window, WIN <= 32 * NC < WIN + 32.
template <int NC>
__global__ void __launch_bounds__(K3_WARPS * 32)
band_kernel(const int8_t* __restrict__ wins, const int8_t* __restrict__ q,
            int n, int win, int8_t* __restrict__ cnt,
            int32_t* __restrict__ bb) {
  const int band = win - FINE;
  const int lane = threadIdx.x & 31;
  // The loop and every branch around the warp votes are uniform across
  // the CTA, so the votes need no reconvergence code: a warp past n
  // recounts block n - 1 and stores the same bytes as the warp it shares
  // the block with.
  for (int f0 = blockIdx.x * K3_WARPS; f0 < n; f0 += gridDim.x * K3_WARPS) {
    const int f = min(f0 + (int)(threadIdx.x >> 5), n - 1);
    // Byte `lane` of every chunk of the four windows, and the query base;
    // past WIN an invalid code.
    int x[NBANDS][NC];
#pragma unroll
    for (int b = 0; b < NBANDS; ++b) {
      const int8_t* w = wins + ((size_t)b * n + f) * win;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        x[b][c] = 32 * c + lane < win ? __ldg(w + 32 * c + lane) : 4;
    }
    const int qc = __ldg(q + (size_t)f * FINE + lane);
    // Planes: bit p of a word is base p of the chunk.
    const uint32_t ql = __ballot_sync(FULL, qc & 1);
    const uint32_t qh = __ballot_sync(FULL, qc & 2);
    const uint32_t qv = __ballot_sync(FULL, (unsigned)qc < 4u);
    int best = -1;
#pragma unroll
    for (int b = 0; b < NBANDS; ++b) {
      int8_t* out = cnt + ((size_t)b * n + f) * band;
      const int tag = band_tag(b);
      // Codes all in 0-3 (any other code sets a bit above bit 1): no
      // "is a base" planes needed.
      int o = 0;
#pragma unroll
      for (int c = 0; c < NC; ++c) o |= x[b][c];
      if (qv == FULL && __all_sync(FULL, (unsigned)o < 4u))
        band_shifts<NC, false>(x[b], ql, qh, qv, lane, band, tag, out, best);
      else
        band_shifts<NC, true>(x[b], ql, qh, qv, lane, band, tag, out, best);
    }
    best = __reduce_max_sync(FULL, best);
    if (lane == 0) bb[f] = best;
  }
}

template <int NC>
int launch_bands(const int8_t* wins, const int8_t* qb, int n, int win,
                 int8_t* cnt, int32_t* bb, cudaStream_t s) {
  static int per_sm_of[MAX_DEVICES] = {};
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int& per_sm = per_sm_of[dev];
  if (!per_sm) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, band_kernel<NC>, K3_WARPS * 32, 0);
    if (err != cudaSuccess) return (int)err;
  }
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int need = (n + K3_WARPS - 1) / K3_WARPS;  // CTAs with a block
  const int blocks = need < sms * per_sm ? need : sms * per_sm;
  band_kernel<NC><<<blocks, K3_WARPS * 32, 0, s>>>(wins, qb, n, win, cnt, bb);
  return (int)cudaGetLastError();
}

// ---- K5 ----------------------------------------------------------------
constexpr int K5_THREADS = 256;
constexpr int K5_MAX_NBF = 8192;   // 2^13 reference blocks (R2's guard)

struct PropArgs {
  const int8_t *cnt, *win;
  const int32_t* base;
  const int8_t* qb;
  const uint8_t *A0, *S0;
  const int32_t *D0, *best;
  int N, NBF, band, win_w, iters, ext_min, ext_margin, cont;
  uint8_t *m1, *m0, *sw, *A, *S;
  int32_t* D;
  uint8_t *Ap, *Sp;
  int32_t* Dp;
};

// The largest band count of block f at (strand s, diagonal d) over the
// bands of that strand that hold d (band b is reverse when b is odd); -1
// if none.
__device__ __forceinline__ int count_at(const PropArgs& a, int n, int f,
                                        int s, int d) {
  int out = -1;
#pragma unroll
  for (int b = s; b < NBANDS; b += 2) {
    const size_t o = ((size_t)b * a.N + n) * a.NBF + f;
    const int tn = d - a.base[o];
    if (tn >= 0 && tn < a.band) out = max(out, (int)a.cnt[o * a.band + tn]);
  }
  return out;
}

// Position `lane` of block f matches at (s, d) in some band that holds it.
__device__ __forceinline__ bool flag_at(const PropArgs& a, int n, int f,
                                        int s, int d, int lane, int8_t q) {
  bool hit = false;
#pragma unroll
  for (int b = s; b < NBANDS; b += 2) {
    const size_t o = ((size_t)b * a.N + n) * a.NBF + f;
    const int tn = d - a.base[o];
    if (tn >= 0 && tn < a.band) hit |= a.win[o * a.win_w + tn + lane] == q;
  }
  return hit;
}

// State of a block in shared memory: the diagonal, and count + 1 (bits
// 0-7), strand (bit 8), assigned (bit 9).
__device__ __forceinline__ uint32_t k5_meta(int cc, int s, int asg) {
  return (uint32_t)(cc + 1) | (uint32_t)s << 8 | (uint32_t)asg << 9;
}

__global__ void __launch_bounds__(K5_THREADS)
propagate_kernel(PropArgs a) {
  extern __shared__ int32_t k5_smem[];
  const int n = blockIdx.x, NBF = a.NBF;
  int32_t* dbuf = k5_smem;                                   // [2][NBF]
  uint16_t* mbuf = reinterpret_cast<uint16_t*>(k5_smem + 2 * NBF);
  const size_t row = (size_t)n * NBF;
  for (int f = threadIdx.x; f < NBF; f += blockDim.x) {
    const int asg = a.A0[row + f] != 0;
    dbuf[f] = a.D0[row + f];
    mbuf[f] = (uint16_t)k5_meta(asg ? a.best[row + f] : -1,
                                a.S0[row + f] != 0, asg);
  }
  __syncthreads();
  int cur = 0;
  for (int step = 0; step < 2 * a.iters; ++step) {
    const int dir = (step & 1) ? 1 : -1;   // the block before, then after
    const int32_t* dc = dbuf + cur * NBF;
    const uint16_t* mc = mbuf + cur * NBF;
    int32_t* dn_out = dbuf + (cur ^ 1) * NBF;
    uint16_t* mn_out = mbuf + (cur ^ 1) * NBF;
    for (int f = threadIdx.x; f < NBF; f += blockDim.x) {
      int d = dc[f];
      const int mt = mc[f];
      int s = (mt >> 8) & 1, asg = (mt >> 9) & 1, cc = (mt & 255) - 1;
      const int g = f + dir;
      int dn = 0, sn = 0, an = 0;
      if (g >= 0 && g < NBF) {
        dn = dc[g];
        sn = (mc[g] >> 8) & 1;
        an = (mc[g] >> 9) & 1;
      }
      const int cn = an && (dn != d || sn != s) ? count_at(a, n, f, sn, dn)
                                                : -1;
      const bool better = cn >= a.ext_min && cn > cc + a.ext_margin;
      const bool cont = asg && cn >= a.ext_min && cn + a.cont >= cc &&
                        cn <= cc;
      if (better || cont) {
        d = dn;
        s = sn;
        cc = cn;
      }
      asg |= better;
      dn_out[f] = d;
      mn_out[f] = (uint16_t)k5_meta(cc, s, asg);
    }
    __syncthreads();
    cur ^= 1;
  }
  const int32_t* df = dbuf + cur * NBF;
  const uint16_t* mf = mbuf + cur * NBF;
  for (int f = threadIdx.x; f < NBF; f += blockDim.x) {
    const int d = df[f], s = (mf[f] >> 8) & 1, asg = (mf[f] >> 9) & 1;
    const int dp = f ? df[f - 1] : 0;
    const int sp = f ? (mf[f - 1] >> 8) & 1 : 0;
    const int ap = f ? (mf[f - 1] >> 9) & 1 : 0;
    a.D[row + f] = d;
    a.S[row + f] = (uint8_t)s;
    a.A[row + f] = (uint8_t)asg;
    a.Dp[row + f] = dp;
    a.Sp[row + f] = (uint8_t)sp;
    a.Ap[row + f] = (uint8_t)ap;
    a.sw[row + f] = (uint8_t)(asg && ap && (d != dp || s != sp));
  }
  const int lane = threadIdx.x & 31;
  for (int f = threadIdx.x >> 5; f < NBF; f += blockDim.x >> 5) {
    const int d = df[f], s = (mf[f] >> 8) & 1, asg = (mf[f] >> 9) & 1;
    const int dp = f ? df[f - 1] : 0;
    const int sp = f ? (mf[f - 1] >> 8) & 1 : 0;
    const int ap = f ? (mf[f - 1] >> 9) & 1 : 0;
    const bool sw = asg && ap && (d != dp || s != sp);
    const size_t o = (row + f) * FINE + lane;
    const int8_t q = a.qb[o];
    const bool qok = q < 4;
    a.m1[o] = (uint8_t)(qok && asg && flag_at(a, n, f, s, d, lane, q));
    a.m0[o] = (uint8_t)(qok && sw && flag_at(a, n, f, sp, dp, lane, q));
  }
}

int launch_propagate(const PropArgs& a, cudaStream_t s) {
  static bool configured[MAX_DEVICES] = {};  // the attribute is per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        propagate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        12 * K5_MAX_NBF);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  propagate_kernel<<<a.N, K5_THREADS, 12 * a.NBF, s>>>(a);
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

// K3. wins: (4, n, win) int8; qb: (n, 32) int8; codes 0-4 (a base is 0-3);
// cnt: (4, n, win - 32) int8; bb: (n,) int32. 32 < win <= 544. Returns
// cudaGetLastError().
int k3_bands(const int8_t* wins, const int8_t* qb, int n, int win,
             int8_t* cnt, int32_t* bb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || win <= FINE || win > 32 * MAX_CHUNKS)
    return (int)cudaErrorInvalidValue;
  switch ((win + 31) / 32) {
#define K3_CASE(nc) \
  case nc:          \
    return launch_bands<nc>(wins, qb, n, win, cnt, bb, s);
    K3_CASE(2) K3_CASE(3) K3_CASE(4) K3_CASE(5) K3_CASE(6) K3_CASE(7)
    K3_CASE(8) K3_CASE(9) K3_CASE(10) K3_CASE(11) K3_CASE(12) K3_CASE(13)
    K3_CASE(14) K3_CASE(15) K3_CASE(16) K3_CASE(17)
#undef K3_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// K5. cnt: (4, N, NBF, band) int8 and win: (4, N, NBF, win_w) int8, the
// band counts and windows of K3 (win_w = band + 32); base: (4, N, NBF)
// int32, each band's first diagonal; qb: (N, NBF, 32) int8; A0, S0: (N,
// NBF) bool, D0, best: (N, NBF) int32, the election. Writes m1, m0: (N,
// NBF * 32) bool and sw, A, S, Ap, Sp: (N, NBF) bool, D, Dp: (N, NBF)
// int32. NBF <= 8192. Returns cudaGetLastError().
int k5_propagate(const int8_t* cnt, const int8_t* win, const int32_t* base,
                 const int8_t* qb, const uint8_t* A0, const uint8_t* S0,
                 const int32_t* D0, const int32_t* best, int N, int NBF,
                 int band, int win_w, int iters, int ext_min, int ext_margin,
                 int cont, uint8_t* m1, uint8_t* m0, uint8_t* sw, uint8_t* A,
                 uint8_t* S, int32_t* D, uint8_t* Ap, uint8_t* Sp,
                 int32_t* Dp, void* stream) {
  if (N < 1 || NBF < 1 || NBF > K5_MAX_NBF || band < 1 ||
      win_w != band + FINE || iters < 0)
    return (int)cudaErrorInvalidValue;
  const PropArgs a{cnt, win, base, qb, A0, S0, D0, best, N, NBF, band, win_w,
                   iters, ext_min, ext_margin, cont, m1, m0, sw, A, S, D, Ap,
                   Sp, Dp};
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
