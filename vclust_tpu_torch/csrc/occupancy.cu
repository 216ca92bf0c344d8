// K1: exact weighted occupancy count for the prefilter.
//
// Replaces the jitted XLA program `_group_matmul_accum_w` of the JAX
// package (its ops/prefilter.py:275-302), which scatters one chunk of the
// pattern COO into a {0,1} bf16 (patterns x genomes) occupancy and
// accumulates counts += occ^T (w * occ) in f32, one byte limb of w at a time.
//
// One pass of `ng` patterns (one or more consecutive chunks of the JAX
// package's chunking, merged by the host while their occupancy fits):
//   1. a memset and `scatter_kernel` (one warp per pattern) build the uint8
//      occupancy occT[g, r] in {0, 1}, genome-major (n x ld, ld = ng
//      rounded up to a 128-pattern k-block), so both product operands are
//      K-major, the only layout 8-bit `wgmma` takes; or, when each CTA
//      walks at most two k-blocks and the COO is small (the host decides),
//      the count kernel builds its tiles' occupancy in shared memory;
//   2. `count_kernel<L>` adds counts[i, j] += sum_r occ[r,i] w[r] occ[r,j]
//      into the int32 (n x n) counts. The weight is split into byte limbs
//      (w < 2^24, so at most 3); limb l's product has its own s32
//      accumulator, recombined as sum_l acc_l << 8l in the epilogue. Every
//      sum is an exact integer, so the result equals the JAX package's
//      rint(f32) counts bit for bit while those are exact (< 2^24), and stays
//      exact up to 2^31.
//
// What bounds it on an H100 SXM, and what the design does about it:
//   * Operations: 2 * rows * n^2 u8 products per limb against the 1,979
//     TOPS dense int8 tensor rate. Only `wgmma` reaches that rate: two
//     consumer warpgroups each issue m64n128k32 u8 x u8 -> s32 on a 128 x
//     128 genome tile. The weighted operand occ * byte_l(w) is built in
//     registers (occupancy bytes x 0xFF as a byte mask, AND the packed limb
//     bytes) and is wgmma's A operand, which may come from registers; B is
//     the plain occupancy, read by wgmma from shared memory. The fragments
//     alternate between two register sets, so a group of products (a
//     k-step's limbs; one limb at L = 3, where two sets of three would not
//     fit beside the accumulators and ptxas would serialize the products)
//     runs while the next group's fragments are built.
//   * Repeats: counts is symmetric, so only the tiles on or above the
//     diagonal are computed, and each is added at (i, j) and, transposed,
//     at (j, i); a diagonal tile is itself symmetric and is added once.
//   * Limbs: the host sorts each chunk's patterns by the byte count of
//     their weight and passes the limb count of each 128-pattern k-block;
//     a k-block issues only its own limbs' products (L is the pass's
//     largest count and sizes the accumulators: 192 registers a consumer
//     thread at L = 3, under a 232-register `setmaxnreg`).
//   * Operand bytes: a k-block of A (128 x 128 bytes) and of B is 32 KB for
//     2 * 128^3 * limbs operations. A producer thread keeps a 6-stage ring
//     in shared memory full with TMA copies (128-byte swizzle, the layout
//     wgmma reads) and a bulk copy of the k-block's limb bytes, completed on
//     mbarriers, so loads overlap the products. The host orders the tiles
//     in bands of 8 tile rows, so the tiles in flight at once share their
//     operands in the 50 MB L2 even when a pass's occupancy is larger.
//   * Counts bytes: each pass adds into the whole n x n counts (1 GiB at
//     16,384 genomes), so the host merges chunks into passes of up to 1.5
//     GiB of occupancy (at 16,384 genomes and 65,536 patterns, one pass
//     where one launch a chunk made 17 of these adds). The epilogue stages
//     the tile and its transpose in the idle ring and adds them with TMA
//     reductions (cp.reduce.async.bulk.add, s32), which run in L2,
//     coalesced and atomic per element, with no read of counts by the SM. Rows must be 16-byte aligned for that
//     (n % 4 == 0); otherwise the epilogue adds element by element.
//   * Small n: when the upper tiles are fewer than the SMs, the host splits
//     each tile's k-blocks into ranges of about equal limb products, one
//     CTA each, whose sums meet in int32 atomic adds (exact and order-free,
//     so the result stays deterministic); the host splits only where the
//     CTAs' fixed cost is repaid. When each CTA walks at most two k-blocks
//     (one tile split many ways), the producer warpgroup writes each
//     k-block's occupancy straight from the COO into the ring, so a pass
//     is one launch with no occupancy in device memory.
//
// An output window serves the row panels of the JAX package's
// `_panel_matmul_accum` (its ops/prefilter.py:528-545), which hold a
// (panel x n) block and never n x n: counts is then the rows x n block of
// genome rows [row0, row0 + rows), row0 a multiple of 128, and with mirror
// = 0 each work item (ti, tj), ti > tj allowed, adds its tile once, at row
// ti*128 - row0 (the host lists every tile of the row band). The operands
// stay in genome coordinates, so the occupancy and its COO build are the
// same; only the epilogue's place changes. A shard of a mesh runs a part
// of a square pass's work list on a square counts of its own (mirror = 1,
// row0 = 0, rows = n); the shards' sums add up to the whole.

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int TILE = 128;           // output tile edge (genomes)
constexpr int KB = 128;             // patterns per k-block: one 128-byte row
constexpr int KSTEP = 32;           // patterns per wgmma (k32)
constexpr int MAX_LIMBS = 3;
constexpr int WB = MAX_LIMBS * KB;  // limb bytes of one k-block
constexpr int CONSUMERS = 2;        // consumer warpgroups, 64 tile rows each
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int STAGES = 6;
constexpr int TILE_BYTES = TILE * KB;
constexpr int SMEM_BYTES =
    STAGES * (2 * TILE_BYTES + WB) + 2 * STAGES * 8 + 1024;  // + alignment

__global__ void scatter_kernel(const int32_t* __restrict__ gids,
                               const int32_t* __restrict__ offs, int ng,
                               uint8_t* __restrict__ occT, int64_t ld) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= ng) return;
  const int lo = offs[r], hi = offs[r + 1];
  for (int e = lo + lane; e < hi; e += 32)
    occT[(int64_t)gids[e] * ld + r] = 1;
}

// ---- shared-memory barriers and asynchronous copies -----------------------

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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory descriptor of a K-major tile of 128-byte rows written by TMA
// with the 128-byte swizzle: 8-row groups 1,024 bytes apart (SBO), layout 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

#define D8(i)                                                           \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 128, s32, the warpgroup's fragment) += a (64 x 32 u8, registers)
// * b (128 x 32 u8, K-major in shared memory)^T.
__device__ __forceinline__ void wgmma_u8(int (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// counts (via its tensor map) += the s32 tile in shared memory at `src`,
// whose top-left element goes to column c0, row c1.
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map,
                                               uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// Barrier 2 among the two consumer warpgroups' 256 threads.
__device__ __forceinline__ void named_sync_consumers() {
  asm volatile("bar.sync 2, 256;\n" ::: "memory");
}

// Barrier 1 among the producer warpgroup's 128 threads.
__device__ __forceinline__ void named_sync_producers() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ void add_count(int32_t* p, uint32_t v, bool atomic) {
  if (atomic)
    atomicAdd(reinterpret_cast<unsigned int*>(p), v);
  else
    *p = (int32_t)((uint32_t)*p + v);
}

// One k-block's products for limbs 0..LK-1 into acc (L limbs), in groups:
// a group builds its A fragments (the occupancy row bytes masked by the
// limb bytes of its patterns) in one of two register sets, issues its
// products, and waits for the group before it, so one group's products run
// while the next group's fragments are built, across k-blocks too. After
// the first group the previous k-block's products are done, and its stage
// is released (prev_empty, when not 0).
template <int L, int LK>
__device__ __forceinline__ void kblock_products(int (&acc)[L][64],
                                                uint32_t a_tile, int a_row,
                                                int a_half,
                                                const uint32_t* wsm, int t,
                                                uint64_t b_desc,
                                                uint32_t prev_empty) {
  // Products a group: all LK of a k-step, or one at a time at L = 3, where
  // 192 accumulators leave no room for two sets of LK fragments (ptxas
  // would serialize the products).
  constexpr int P = L < 3 ? LK : 1;
  uint32_t a[2][P][4];
#pragma unroll
  for (int s = 0; s < KB / KSTEP; ++s) {
    uint32_t occ[4];
    ldmatrix_x4(occ, a_tile + a_row * KB +
                         ((((2 * s + a_half) ^ (a_row & 7))) << 4));
#pragma unroll
    for (int l0 = 0; l0 < LK; l0 += P) {
      const int i = ((s * LK + l0) / P) & 1;  // an even count a k-block
#pragma unroll
      for (int p = 0; p < P; ++p) {
        // Limb bytes of patterns 4t..4t+3 and 16+4t..16+4t+3 of step s;
        // occupancy bytes are 0 or 1, so occ * 0xFF is a byte mask.
        const int l = l0 + p;
        const uint32_t w0 = wsm[(l * KB + s * KSTEP) / 4 + t];
        const uint32_t w1 = wsm[(l * KB + s * KSTEP) / 4 + 4 + t];
        a[i][p][0] = (occ[0] * 0xFFu) & w0;
        a[i][p][1] = (occ[1] * 0xFFu) & w0;
        a[i][p][2] = (occ[2] * 0xFFu) & w1;
        a[i][p][3] = (occ[3] * 0xFFu) & w1;
      }
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < P; ++p)  // the descriptor advances 32 bytes a step
        wgmma_u8(acc[l0 + p], a[i][p], b_desc + 2 * s);
      wgmma_commit();
      wgmma_wait<1>();
      if (s == 0 && l0 == 0 && prev_empty) mbar_arrive(prev_empty);
    }
  }
}

// One work item (ti, tj, kb_lo, kb_hi) a CTA: the 128 x 128 tile of genomes
// [ti*128, +128) x [tj*128, +128), over k-blocks [kb_lo, kb_hi); ti <= tj
// when mirror != 0. Counts row r holds genome row0 + r. Warpgroups 0-1
// consume (64 tile rows each), warpgroup 2 produces.
template <int L>
__global__ void __launch_bounds__(THREADS, 1)
count_kernel(const __grid_constant__ CUtensorMap occ_map,
             const __grid_constant__ CUtensorMap counts_map,
             const int32_t* __restrict__ gids,
             const int32_t* __restrict__ offs, int ng,
             const uint8_t* __restrict__ wbytes,
             const int32_t* __restrict__ kb_limbs,
             const int4* __restrict__ work, int32_t* __restrict__ counts,
             int n, int row0, int rows, int mirror, int atomic, int from_coo,
             int tma_out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzle atoms
  const uint32_t sA = base, sB = sA + STAGES * TILE_BYTES;
  const uint32_t sW = sB + STAGES * TILE_BYTES;
  const uint32_t full = sW + STAGES * WB, empty = full + STAGES * 8;
  uint8_t* smem = smem_raw + (base - raw);  // generic view of `base`

  const int4 item = work[blockIdx.x];
  const int i0 = item.x * TILE, j0 = item.y * TILE;
  const bool diag = item.x == item.y;  // B is A: load one tile
  const bool twice = mirror && !diag;  // also add the transpose at (j, i)
  const int kb_lo = item.z, kb_hi = item.w;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (from_coo) {
      // The producer warpgroup writes each k-block's occupancy rows of the
      // tile (A, and B off the diagonal) into the stage from the COO
      // itself, in the layout TMA gives (thread p takes pattern p of the
      // k-block): no occupancy in device memory, one launch a pass.
      const int p = threadIdx.x - CONSUMERS * 128;
      uint8_t* a_gen = smem + (sA - base);
      uint8_t* b_gen = smem + (sB - base);
      uint32_t* w_gen = reinterpret_cast<uint32_t*>(smem + (sW - base));
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = kb_lo; kb < kb_hi; ++kb) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        uint8_t* a = a_gen + stage * TILE_BYTES;
        uint8_t* b = b_gen + stage * TILE_BYTES;
        constexpr int Z = TILE_BYTES / 16 / 128;  // 16-byte zeros a thread
#pragma unroll
        for (int q = 0; q < Z; ++q) {
          reinterpret_cast<uint4*>(a)[p * Z + q] = make_uint4(0, 0, 0, 0);
          if (!diag)
            reinterpret_cast<uint4*>(b)[p * Z + q] = make_uint4(0, 0, 0, 0);
        }
        if (p < WB / 4)
          w_gen[stage * (WB / 4) + p] =
              reinterpret_cast<const uint32_t*>(wbytes + (int64_t)kb * WB)[p];
        named_sync_producers();
        const int r = kb * KB + p;
        if (r < ng) {
          const int hi = offs[r + 1];
          for (int e = offs[r]; e < hi; ++e) {
            const int g = gids[e];
            // Byte p of row g - i0 (tiles start at multiples of 128, so
            // the swizzle's row bits are g's).
            const int col = (((p >> 4) ^ (g & 7)) << 4) + (p & 15);
            if ((unsigned)(g - i0) < TILE)
              a[(g - i0) * KB + col] = 1;
            else if (!diag && (unsigned)(g - j0) < TILE)
              b[(g - j0) * KB + col] = 1;
          }
        }
        // wgmma reads B through the async proxy.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync_producers();
        if (p == 0) mbar_arrive(full + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (threadIdx.x == CONSUMERS * 128) {
      // TMA: one thread keeps the ring full.
      const uint32_t bytes = (diag ? 1 : 2) * TILE_BYTES + WB;
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = kb_lo; kb < kb_hi; ++kb) {
        const uint32_t f = full + 8 * stage;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(f, bytes);
        tma_load(sA + stage * TILE_BYTES, &occ_map, f, kb * KB, i0);
        if (!diag) tma_load(sB + stage * TILE_BYTES, &occ_map, f, kb * KB, j0);
        bulk_load(sW + stage * WB, wbytes + (int64_t)kb * WB, WB, f);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // Consumers: 64 rows of the tile each, one s32 accumulator a limb.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane & 3;
    int acc[L][64];
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int c = 0; c < 64; ++c) acc[l][c] = 0;

    // ldmatrix.x4 row addresses: lanes 0-7 / 8-15 give rows 0-7 / 8-15 of
    // the warp's 16 rows at the k-step's first 16 bytes, lanes 16-31 the
    // same rows at its second 16 bytes: the four registers are then the
    // m64k32 8-bit A fragment. With the 128-byte swizzle, 16-byte chunk c of
    // row r lies at chunk c ^ (r & 7).
    const int a_row = wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int a_half = lane >> 4;

    int stage = 0;
    uint32_t phase = 0, prev_empty = 0;  // the stage in use until released
    for (int kb = kb_lo; kb < kb_hi; ++kb) {
      const int lk = kb_limbs[kb];
      mbar_wait(full + 8 * stage, phase);
      const uint32_t a_tile = sA + stage * TILE_BYTES;
      const uint64_t b_desc = smem_desc(diag ? a_tile : sB + stage * TILE_BYTES);
      const uint32_t* wsm = reinterpret_cast<const uint32_t*>(
          smem + (sW - base) + stage * WB);
      const uint32_t rel = tid == 0 ? prev_empty : 0;  // one arrival a WG
      // Only the k-block's own limbs, in straight-line code for each count.
      if (lk == 1) {
        kblock_products<L, 1>(acc, a_tile, a_row, a_half, wsm, t, b_desc,
                              rel);
      } else if constexpr (L == 2) {
        kblock_products<L, 2>(acc, a_tile, a_row, a_half, wsm, t, b_desc,
                              rel);
      } else if constexpr (L == 3) {
        if (lk == 2)
          kblock_products<L, 2>(acc, a_tile, a_row, a_half, wsm, t, b_desc,
                                rel);
        else
          kblock_products<L, 3>(acc, a_tile, a_row, a_half, wsm, t, b_desc,
                                rel);
      }
      prev_empty = empty + 8 * stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();  // the last stage needs no release: no loads follow
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int c = 0; c < 64; ++c) fence_operand(acc[l][c]);

    // Accumulator fragment: acc[.][4*c8 + 2*h + e] is row 16*warp + g + 8*h
    // of the warpgroup's 64, column 8*c8 + 2*t + e of the tile.
    const int row = wg * 64 + warp * 16 + (lane >> 2);
    auto value = [&](int c8, int h, int e) {
      uint32_t v = 0;
#pragma unroll
      for (int l = 0; l < L; ++l)
        v += (uint32_t)acc[l][4 * c8 + 2 * h + e] << (8 * l);
      return v;
    };
    if (tma_out) {
      // Stage the tile, and its transpose off the diagonal when mirrored,
      // in the ring (idle now) and let TMA add them into counts in L2:
      // coalesced, atomic per element (so split-K needs nothing more),
      // clipped at n and at the window's rows, and no read of counts by the
      // SM. A diagonal tile is symmetric and is added whole.
      named_sync_consumers();  // both warpgroups are done with the ring
      int32_t* d = reinterpret_cast<int32_t*>(smem);
      int32_t* m = d + TILE * TILE;
#pragma unroll
      for (int c8 = 0; c8 < TILE / 8; ++c8)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h, c = 8 * c8 + 2 * t;
          const uint32_t v0 = value(c8, h, 0), v1 = value(c8, h, 1);
          *reinterpret_cast<int2*>(d + r * TILE + c) = make_int2(v0, v1);
          if (twice) {
            m[c * TILE + r] = v0;
            m[(c + 1) * TILE + r] = v1;
          }
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync_consumers();
      if (threadIdx.x == 0) {
        tma_reduce_add(&counts_map, base, j0, i0 - row0);
        if (twice) tma_reduce_add(&counts_map, base + TILE * TILE * 4, i0, j0);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    } else {
      // Row stride not a multiple of 16 bytes (n % 4 != 0): add element by
      // element; mirrored, i < j at (i, j) and (j, i) and i == j once, else
      // each (i, j) of the window once.
      const bool at = atomic != 0;
#pragma unroll
      for (int c8 = 0; c8 < TILE / 8; ++c8)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + row + 8 * h;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + 8 * c8 + 2 * t + e;
            const uint32_t v = value(c8, h, e);
            if (v == 0 || j >= n) continue;
            if (!mirror) {
              if ((unsigned)(i - row0) < (unsigned)rows)
                add_count(counts + (int64_t)(i - row0) * n + j, v, at);
              continue;
            }
            if (i > j) continue;
            add_count(counts + (int64_t)i * n + j, v, at);
            if (i < j) add_count(counts + (int64_t)j * n + i, v, at);
          }
        }
    }
  }
}

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

// A 2-D tensor map of rows x cols elements, rows `row_bytes` apart, read or
// written in boxes of box_rows x box_cols. Returns 0 or an error code.
int encode_map(CUtensorMap* map, CUtensorMapDataType type, void* ptr,
               uint64_t cols, uint64_t rows, uint64_t row_bytes,
               uint32_t box_cols, uint32_t box_rows,
               CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult cr = encode(map, type, 2, ptr, dims, strides, box, elem,
                       CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return cr == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)cr;
}

struct CountArgs {
  CUtensorMap occ_map, counts_map;
  const int32_t *gids, *offs;
  int ng;
  const uint8_t* wbytes;
  const int32_t* kb_limbs;
  const int32_t* work;
  int n_items;
  int32_t* counts;
  int n, row0, rows, mirror, atomic, from_coo, tma_out;
};

// Devices whose count_kernel<L> takes SMEM_BYTES (an attribute is set per
// device, and a process may launch on several).
constexpr int MAX_DEVICES = 64;

template <int L>
int launch_count(const CountArgs& a, cudaStream_t s) {
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(count_kernel<L>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  count_kernel<L><<<a.n_items, THREADS, SMEM_BYTES, s>>>(
      a.occ_map, a.counts_map, a.gids, a.offs, a.ng, a.wbytes, a.kb_limbs,
      reinterpret_cast<const int4*>(a.work), a.counts, a.n, a.row0, a.rows,
      a.mirror, a.atomic, a.from_coo, a.tma_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One pass: counts += occ^T diag(w) occ for the pass's ng patterns, whose
// genome ids are gids[offs[r] .. offs[r+1]) (ids in [0, n)). counts (int32)
// is the rows x n window of genome rows [row0, row0 + rows), row0 a multiple
// of 128; with mirror != 0 it is the whole n x n (row0 = 0, rows = n). wbytes
// holds, for each of the nkb k-blocks, the 3 x 128 limb bytes of its
// patterns' weights (limb-major); kb_limbs the limb count of each k-block
// (1..n_limbs); work the n_items (ti, tj, kb_lo, kb_hi) int32 quadruples, no
// (tile, k-block) twice: mirrored, tiles with ti <= tj (each added at (i, j)
// and (j, i)), else tiles of the window's row band (each added once);
// atomic != 0 when a tile has more than one item. With from_coo != 0 the
// kernel builds its tiles' occupancy from the COO and occT is not used (may
// be null); otherwise occT is scratch of n x (nkb * 128) bytes, zeroed and
// filled here. Returns 0 or an error code.
int k1_count_chunk(const int32_t* gids, const int32_t* offs, int ng,
                   const uint8_t* wbytes, const int32_t* kb_limbs, int nkb,
                   const int32_t* work, int n_items, int atomic, int n_limbs,
                   int from_coo, uint8_t* occT, int n, int row0, int rows,
                   int mirror, int32_t* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t ld = (int64_t)nkb * KB;
  if (ng < 1 || ng > ld || n < 1 || n_items < 1 || n_limbs < 1 ||
      n_limbs > MAX_LIMBS || row0 < 0 || row0 % TILE || rows < 1 ||
      rows > n - row0 || (mirror && (row0 || rows != n)))
    return (int)cudaErrorInvalidValue;
  CountArgs a = {};
  a.gids = gids;
  a.offs = offs;
  a.ng = ng;
  a.wbytes = wbytes;
  a.kb_limbs = kb_limbs;
  a.work = work;
  a.n_items = n_items;
  a.counts = counts;
  a.n = n;
  a.row0 = row0;
  a.rows = rows;
  a.mirror = mirror;
  a.atomic = atomic;
  a.from_coo = from_coo;
  // TMA needs rows a multiple of 16 bytes apart.
  a.tma_out = n % 4 == 0;
  int rc;
  if (a.tma_out &&
      (rc = encode_map(&a.counts_map, CU_TENSOR_MAP_DATA_TYPE_INT32, counts, n,
                       rows, (uint64_t)n * 4, TILE, TILE,
                       CU_TENSOR_MAP_SWIZZLE_NONE)))
    return rc;
  if (!a.from_coo) {
    if ((rc = encode_map(&a.occ_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, occT, ld,
                         n, ld, KB, TILE, CU_TENSOR_MAP_SWIZZLE_128B)))
      return rc;
    cudaError_t err = cudaMemsetAsync(occT, 0, (size_t)n * ld, s);
    if (err != cudaSuccess) return (int)err;
    scatter_kernel<<<(ng + 3) / 4, 128, 0, s>>>(gids, offs, ng, occT, ld);
  }
  switch (n_limbs) {
    case 1:
      return launch_count<1>(a, s);
    case 2:
      return launch_count<2>(a, s);
    default:
      return launch_count<3>(a, s);
  }
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
