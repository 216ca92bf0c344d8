// K8, K6 and K7: the v2 front end of the align row core (the seed votes,
// the two-scale vote election, the neighbour propagation and its flags).
//
// Replace the XLA device programs of the JAX package's `_row_core` (its
// ops/align_tpu.py:595-701): the sort join of the seed votes
// (`_strand_votes`, :296-352, called at :611-623), the election of the
// densest diagonal cluster per fine and per coarse block (`_elect`,
// :355-409, called at :628-650) and the propagation over re-evaluated
// windows with the final flags (stage 2b, :653-697, with `_eval_on`,
// :432-447, and `_window_rows`, :412-429). All three are bit-exact with the
// plain torch versions beside their wrappers in ops/align_gpu.py
// (`votes_v2_plain`, `elect_v2_plain`, `propagate_v2_plain`). A v2 dispatch
// is then four launches: K8, K6, K7 and K4 (csrc/back_half.cu).
//
// K8 (k8_votes). For every query seed (value v >= 0) and strand, the two
// candidate diagonals. The plain version sorts the reference's seed keys
// (sv << 6, even) with the queries' (v << 6 | offset << 1 | 1, odd), so no
// query key equals a reference key, and its running max of the packs at a
// query slot is the max over the reference entries with sv <= v. A pack is
// sv << 16 | position + 1 (or sv << 40 | ...), so that max has v in its top
// bits exactly when v occurs in the row, and is then the largest pack of
// the run of entries equal to v; where no entry of the run has a nonzero
// second pack, the max comes from a smaller value and the check gives BIG.
// So a seed needs one upper-bound search of v in the row's sorted sv and
// the max of the packs over the equal run: no sort, no permutation, and
// the order within equal keys (the sort's stability) does not enter.
// What bounds it, and what the design does about it:
//   * Bytes: the votes written, 16 bytes a query slot (189 MB at the
//     B = 45 dispatch at 65,536); the arena rows read once are a tenth.
//   * Latency of the searches: a search through L2 is 15 dependent loads.
//     A CTA takes one (reference row, strand) and a run of query slots; it
//     stages the row's sv in shared memory (every stride-th entry, stride
//     1 up to 32,768 entries = 128 KB, bucket 65,536 at C = 16), so the
//     search runs on shared memory, a branch-free power-of-two descent;
//     past the sample it refines through L2 (2 loads at 262,144). The
//     packs are read only at the equal run (one or two entries as a rule).
//
// K6 (k6_elect). Per fine block (4C votes) the fine election, per coarse
// block of 4 fine blocks (16C votes, sampled at stride 4 after sorting)
// the coarse one; each sorts its votes, counts for every vote the votes
// within GAP_DIAG among the next min(SMAX, w - 1), elects the largest count
// (ties: the smallest start, a packed max in 22 bits, or 32 where the vote
// codes need them, clamped in the pack's type), takes the mode inside the
// cluster (ties: the smallest) and its exact votes. The fine election
// stands where it beats the fine block's support for the coarse mode.
// What bounds it, and what the design does about it:
//   * Bytes: the votes read once (189 MB at B = 45). The work a vote is a
//     few dozen operations, so the sort must stay on chip.
//   * Design: a warp a coarse block, so the coarse mode meets the fine
//     elections without a trip through device memory. The warp loads the
//     16C votes into shared memory, each fine block padded with BIG to a
//     power of two P, sorts the four runs with a bitonic network whose
//     first step of each merge compares mirrored elements (every run comes
//     out ascending), elects each fine block, merges the runs into one
//     sorted coarse list (BIG padding sorts last) and elects on its every
//     fourth vote. Lanes take votes lane + 32 t; the window counts read
//     shared memory; the packed maxes and the counts reduce by shuffles.
//
// K7 (k7_propagate). EXT_ITERS rounds of neighbour adoption (from the block
// before, then from the block after): a block takes its neighbour's
// (strand, diagonal) when the neighbour is assigned and the block's 32
// query bases match at least EXT_MIN, and more than EXT_MARGIN above its
// own count, of the 32 reference bases on that diagonal; then the flags m1
// at each block's final state and m0 at the previous block's where the
// block is switchable. The plain version carries the flags along with
// every step; they are the flags at the final state, formed once here.
// What bounds it, and what the design does about it:
//   * Bytes: m1 and m0 written (2 bytes a query position, 47 MB at B = 45),
//     the query bases and the reference window rows read once.
//   * Design: K5's (csrc/align_v3.cu): a warp a tile of 128 blocks of one
//     pair, with EXT_ITERS + 1 blocks of halo on the left and EXT_ITERS on
//     the right, so tiles never wait on each other; blocks lane + 32 j.
//     Up front the warp evaluates, for each block, the match mask (32
//     bits) at the initial state of every initially assigned block of
//     g in [i - EXT_ITERS - 1, i + EXT_ITERS] (runs of one state once):
//     the block's own final state and the previous block's lie there. A
//     mask is 8 compares of 4 bytes (__vcmpeq4) of the tile's query bases,
//     staged in shared memory, against a window row's words funnel-shifted
//     to the diagonal's phase. The steps exchange states by shuffles and
//     read counts as population counts of the masks; the flags are the
//     masks of the final sources, written 16 bytes a lane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// Devices a process may launch on (launch state is kept per device).
constexpr int MAX_DEVICES = 64;
constexpr int FINE = 32;
constexpr int BIG = 1 << 30;
constexpr int GAP_DIAG = 16;
constexpr int SMAX = 15;

// Sets the kernel's dynamic shared-memory limit once per device.
template <typename Kernel>
int allow_smem(Kernel k, int bytes, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  return 0;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// ---- K8 ------------------------------------------------------------------
constexpr int K8_THREADS = 1024;
constexpr int K8_SAMPLES = 32768;    // sv entries a CTA stages (128 KB)
constexpr int K8_MIN_SLOTS = 8192;   // least query slots a CTA

struct VoteArgs {
  const int32_t *qsv, *qoff;        // (Gq, NQ)
  const int32_t* sv[2];             // (Gr, NR), forward and reverse
  const int64_t *pk1[2], *pk2[2];   // (Gr, NR)
  const int32_t *r_rows, *q_rows;   // (R,), (R, K)
  int K, NQ, NR, C, Lq, dspan, pack64, stride, samples, chunks, chunk;
  int32_t* votes;                   // (R, K, NQ, 4)
};

__global__ void __launch_bounds__(K8_THREADS) votes_kernel(VoteArgs a) {
  extern __shared__ int32_t k8_sample[];
  const int s = blockIdx.y;
  const int r = blockIdx.x / a.chunks, ch = blockIdx.x % a.chunks;
  const int g = __ldg(a.r_rows + r);
  const int32_t* sv = a.sv[s] + (size_t)g * a.NR;
  const int64_t* pk1 = a.pk1[s] + (size_t)g * a.NR;
  const int64_t* pk2 = a.pk2[s] + (size_t)g * a.NR;
  const int ns = a.samples, stride = a.stride;
  for (int i = threadIdx.x; i < ns; i += blockDim.x)
    k8_sample[i] = __ldg(sv + (size_t)i * stride);
  __syncthreads();
  int top = 1;
  while (top * 2 <= ns) top *= 2;
  const int offset = s ? a.dspan : 0;
  const int total = a.K * a.NQ;
  const int lo = ch * a.chunk, hi = min(lo + a.chunk, total);
  for (int slot = lo + (int)threadIdx.x; slot < hi; slot += blockDim.x) {
    const int k = slot / a.NQ, j = slot - k * a.NQ;
    const size_t qo = (size_t)__ldg(a.q_rows + (size_t)r * a.K + k) * a.NQ + j;
    const int v = __ldg(a.qsv + qo);
    int d1 = BIG, d2 = BIG;
    if (v >= 0) {
      // u: the sampled entries <= v (sv ascending, BIG last).
      int u = 0;
      for (int step = top; step; step >>= 1)
        if (u + step <= ns && k8_sample[u + step - 1] <= v) u += step;
      if (u) {
        // ub: the entries <= v; between samples u - 1 and u through L2.
        int ub = (u - 1) * stride + 1;
        const int end = min(u * stride, a.NR);
        for (int step = stride >> 1; step; step >>= 1)
          if (ub + step - 1 < end && __ldg(sv + ub + step - 1) <= v)
            ub += step;
        // The run of entries equal to v ends at ub - 1.
        long long m1 = 0, m2 = 0;
        for (int i = ub - 1; i >= 0; --i) {
          const int x = stride == 1 ? k8_sample[i] : __ldg(sv + i);
          if (x != v) break;
          m1 = max(m1, (long long)__ldg(pk1 + i));
          if (!a.pack64) m2 = max(m2, (long long)__ldg(pk2 + i));
        }
        const int qpos = (j / a.C) * FINE + (__ldg(a.qoff + qo) & 31);
        const int base = a.Lq + offset - qpos;   // diagonal = position + base
        if (!a.pack64) {
          if ((m1 >> 16) == v && m1 > 0) d1 = (int)(m1 & 0xFFFF) - 1 + base;
          if ((m2 >> 16) == v && m2 > 0) d2 = (int)(m2 & 0xFFFF) - 1 + base;
        } else if ((m1 >> 40) == v && m1 > 0) {
          d1 = (int)((m1 >> 20) & 0xFFFFF) - 1 + base;
          const int cq = (int)(m1 & 0xFFFFF);
          if (cq > 0) d2 = cq - 1 + base;
        }
      }
    }
    reinterpret_cast<int2*>(a.votes)[((size_t)r * a.K * a.NQ + slot) * 2 + s] =
        make_int2(d1, d2);
  }
}

// ---- K6 ------------------------------------------------------------------
constexpr int K6_WARPS = 8;
constexpr int K6_MAX_C = 32;                        // VCLUST_ALIGN_C's range
constexpr int K6_SORT = 16 * K6_MAX_C;             // 4 padded fine blocks
constexpr int K6_WARP_INTS = K6_SORT + 4 * K6_MAX_C;   // + the coarse sample

__device__ __forceinline__ long long warp_max64(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Sorts ascending every run of `seg` elements (a power of two) of x[0, n),
// runs of `from` being sorted already: a bitonic network whose first step
// of each merge compares mirrored elements, so every run it forms ascends.
__device__ void sort_runs(int* x, int n, int from, int seg, int lane) {
  for (int k = 2 * from; k <= seg; k <<= 1) {
    for (int j = k >> 1; j; j >>= 1) {
      for (int p = lane; p < n / 2; p += 32) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int o = j == k >> 1 ? i ^ (k - 1) : i + j;
        const int u = x[i], w = x[o];
        x[i] = min(u, w);
        x[o] = max(u, w);
      }
      __syncwarp();
    }
  }
}

// The election on the sorted votes x[0, w) (w <= 128): every vote's count
// of the votes within GAP_DIAG among the next smax (0 for BIG), the largest
// count with ties to the smallest start, the cluster's mode (ties to the
// smallest), and the mode's exact votes in the row y[0, ny). Returns the
// mode (BIG where nothing was elected) and its votes.
__device__ void elect(const int* x, int w, const int* y, int ny, int vbits,
                      int lane, int& medv, int& votes) {
  const long long vmask = (1LL << vbits) - 1;
  const int smax = min(SMAX, w - 1);
  int cnt[4], eq[4], xv[4];
  long long best = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int i = lane + 32 * t;
    cnt[t] = eq[t] = 0;
    xv[t] = BIG;
    if (i >= w) continue;
    const int xi = x[i];
    xv[t] = xi;
    if (xi < BIG) {
      int c = 1, e = 1;
      for (int s = 1; s <= smax; ++s) {
        const int nb = i + s < w ? x[i + s] : BIG;
        c += nb - xi <= GAP_DIAG;
        e += nb == xi;
      }
      cnt[t] = c;
      eq[t] = e;
    }
    best = max(best, ((long long)cnt[t] << vbits) |
                         (vmask - min((long long)xi, vmask)));
  }
  best = warp_max64(best);
  const int vb = (int)(best >> vbits);
  const int start = (int)(vmask - (best & vmask));
  long long bm = -1;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (lane + 32 * t < w && xv[t] >= start && xv[t] <= start + GAP_DIAG)
      bm = max(bm, ((long long)eq[t] << vbits) |
                       (vmask - min((long long)xv[t], vmask)));
  bm = warp_max64(bm);
  medv = vb > 0 ? (int)(vmask - (bm & vmask)) : BIG;
  int n = 0;
  if (medv < BIG)
    for (int e = lane; e < ny; e += 32) n += abs(y[e] - medv) <= GAP_DIAG;
  votes = __reduce_add_sync(FULL, n);
}

struct ElectArgs {
  const int32_t* votes;   // (N, NQ, 4), NQ = NBF * C
  int N, NBC, C, P, lgP, Lq, dspan, vbits, min_f, min_c;
  uint8_t *A, *S;
  int32_t *D, *vb;        // (N, NBF)
};

__global__ void __launch_bounds__(K6_WARPS * 32) elect_kernel(ElectArgs a) {
  __shared__ int k6_smem[K6_WARPS * K6_WARP_INTS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * K6_WARPS + warp;
  if (gw >= (long long)a.N * a.NBC) return;   // the whole warp leaves
  const int n = (int)(gw / a.NBC), cb = (int)(gw % a.NBC);
  const int C4 = 4 * a.C, P = a.P, n4 = 4 * P;
  const int* v = a.votes + ((size_t)n * a.NBC * 4 * a.C + (size_t)cb * C4) * 4;
  int* x = k6_smem + warp * K6_WARP_INTS;
  int* xs = x + K6_SORT;
  // Fine block q's votes at x[q P, q P + 4C), BIG past them.
  for (int e2 = lane; e2 < n4; e2 += 32) {
    const int q = e2 >> a.lgP, e = e2 & (P - 1);
    x[e2] = e < C4 ? __ldg(v + q * C4 + e) : BIG;
  }
  __syncwarp();
  sort_runs(x, n4, 1, P, lane);
  int medv_f[4], vb_f[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    elect(x + q * P, C4, x + q * P, C4, a.vbits, lane, medv_f[q], vb_f[q]);
  sort_runs(x, n4, P, n4, lane);
  // The coarse block's votes sorted in x[0, 16C); its sample, every fourth.
  for (int e = lane; e < C4; e += 32) xs[e] = x[4 * e];
  __syncwarp();
  int medv_c, vb_c;
  elect(xs, C4, x, 4 * C4, a.vbits, lane, medv_c, vb_c);
  const bool A_c = vb_c >= a.min_c, S_c = medv_c >= a.dspan;
  const int D_c = (S_c ? medv_c - a.dspan : medv_c) - a.Lq;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // The fine block's support for the coarse mode (its BIG votes count
    // where the mode is BIG, as the plain version's; nothing is coarse-
    // assigned then).
    int sup = 0;
    for (int e = lane; e < C4; e += 32)
      sup += abs(__ldg(v + q * C4 + e) - medv_c) <= GAP_DIAG;
    sup = __reduce_add_sync(FULL, sup);
    if (lane != q) continue;
    const bool A_f = vb_f[q] >= a.min_f, S_f = medv_f[q] >= a.dspan;
    const int D_f = (S_f ? medv_f[q] - a.dspan : medv_f[q]) - a.Lq;
    const bool use_f = A_f && (!A_c || vb_f[q] > sup);
    const size_t o = (size_t)n * 4 * a.NBC + 4 * cb + q;
    a.A[o] = (uint8_t)(use_f || A_c);
    a.S[o] = (uint8_t)(use_f ? S_f : S_c);
    a.D[o] = use_f ? D_f : D_c;
    a.vb[o] = use_f ? vb_f[q] : vb_c;
  }
}

// ---- K7 ------------------------------------------------------------------
constexpr int K7_WARPS = 4;               // warps a CTA, a tile each
constexpr int K7_BPT = 4;                 // blocks a lane: lane + 32 j
constexpr int K7_TILE = 32 * K7_BPT;      // blocks a tile holds, halo included
constexpr int K7_MAX_ITERS = 16;          // VCLUST_ALIGN_EXTI's range
constexpr int K7_GATHER = 4;              // masks a lane evaluates at once

struct V2PropArgs {
  const int8_t* q;                  // (Gq, Lq) query codes
  const int32_t *q_rows, *qlens;    // (N,)
  const int8_t* r2dov;              // (Gr, 2 * NRT, 64) window rows
  const int32_t *r_rows, *rlens;    // (R,)
  const uint8_t *A0, *S0;
  const int32_t* D0;                // (N, NBF)
  int N, K, NBF, Lr, NRT, iters, ext_min, ext_margin, out, tiles;
  uint8_t *m1, *m0, *sw, *A, *S;
  int32_t* D;
  uint8_t *Ap, *Sp;
  int32_t* Dp;
};

// Shared memory of a warp, by tile index: the query bases (32 bytes a
// block), the initial diagonals, the flag masks (m1's, then m0's), the
// initial strands (bit 0; bit 1 marks a block outside the pair, bit 2 an
// assigned one) and the mask table, 2 EXT_ITERS + 2 words a block.
constexpr int K7_AT_D0 = 32 * K7_TILE, K7_AT_M = 36 * K7_TILE,
              K7_AT_S0 = 44 * K7_TILE, K7_AT_TAB = 45 * K7_TILE;
__host__ __device__ constexpr int k7_warp_bytes(int iters) {
  return (K7_AT_TAB + 4 * K7_TILE * (2 * iters + 2) + 15) / 16 * 16;
}

// A block's state in a register: its source block in the tile (bits 0-7),
// strand (bit 8), assigned (bit 9); the diagonal beside it.
constexpr uint32_t K7_SRC = 255u, K7_STRAND = 256u, K7_ASG = 512u;

// Bits t of the mask: query base t of block f (q: its 32 bases as words)
// is a base equal to the reference base on strand s at diagonal d, inside
// the reference and the query; 0 where the window start was clipped.
__device__ __forceinline__ uint32_t block_mask(const V2PropArgs& a,
                                               const int8_t* rrow,
                                               const uint32_t* q, int f,
                                               int d, int s, int rlen,
                                               int qlen) {
  const int start = f * FINE + d;
  const int sc = min(max(start, -FINE), a.Lr - 1);
  if (start != sc) return 0u;
  const int row = (sc + FINE) >> 5, phase = sc + FINE - (row << 5);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(
                          rrow + (size_t)(row + (s ? a.NRT : 0)) * 64) +
                      (phase >> 2);
  const int sh = 8 * (phase & 3);
  uint32_t lo = __ldg(w), m = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t hi = __ldg(w + k + 1);   // word 15 of the row at most
    const uint32_t e = __vcmpeq4(__funnelshift_r(lo, hi, sh), q[k]) &
                       __vcmpltu4(q[k], 0x04040404u) & 0x01010101u;
    m |= ((e | e >> 7 | e >> 14 | e >> 21) & 0xFu) << (4 * k);
    lo = hi;
  }
  const int t_lo = max(0, -start);
  const int t_hi = min(FINE, min(rlen - start, qlen - f * FINE));
  if (t_hi <= t_lo) return 0u;
  return m & (t_hi == FINE ? FULL : (1u << t_hi) - 1u) & (FULL << t_lo);
}

// 4 bits as 4 bytes of 0 or 1.
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t x) {
  return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

__device__ __forceinline__ uint4 bits_bytes(uint32_t b) {
  return make_uint4(nibble_bytes(b & 15u), nibble_bytes((b >> 4) & 15u),
                    nibble_bytes((b >> 8) & 15u),
                    nibble_bytes((b >> 12) & 15u));
}

__global__ void __launch_bounds__(K7_WARPS * 32)
propagate_v2_kernel(V2PropArgs a) {
  extern __shared__ __align__(16) uint8_t k7_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long unit = (long long)blockIdx.x * K7_WARPS + warp;
  if (unit >= (long long)a.N * a.tiles) return;   // the whole warp leaves
  const int E = a.iters, Cn = 2 * E + 2;
  uint8_t* mine = k7_smem + warp * k7_warp_bytes(E);
  int32_t* d0s = reinterpret_cast<int32_t*>(mine + K7_AT_D0);
  uint32_t* m1s = reinterpret_cast<uint32_t*>(mine + K7_AT_M);
  uint32_t* m0s = m1s + K7_TILE;
  uint8_t* s0s = mine + K7_AT_S0;
  uint32_t* tab = reinterpret_cast<uint32_t*>(mine + K7_AT_TAB);
  const int n = (int)(unit / a.tiles), t = (int)(unit % a.tiles);
  // Tile t writes blocks o_t .. and holds blocks f_lo .. f_lo + K7_TILE - 1,
  // as K5's tiles (csrc/align_v3.cu).
  const int o_t = t ? K7_TILE - E + (t - 1) * a.out : 0;
  const int f_lo = t ? o_t - (E + 1) : 0;   // the block at tile index 0
  const int f_end = f_lo + K7_TILE >= a.NBF ? a.NBF : f_lo + K7_TILE - E;
  const size_t row = (size_t)n * a.NBF;
  const int r = n / a.K;
  const int qlen = __ldg(a.qlens + n), rlen = __ldg(a.rlens + r);
  const int8_t* rrow = a.r2dov + (size_t)__ldg(a.r_rows + r) * 2 * a.NRT * 64;
  const int8_t* qrow =
      a.q + ((size_t)__ldg(a.q_rows + n) * a.NBF + f_lo) * FINE;
  const int r_lo = max(0, -f_lo), r_hi = min(K7_TILE, a.NBF - f_lo);

  // 1. The tile's blocks, lane + 32 j in lane j: the initial state (blocks
  //    outside the pair unassigned at (forward, 0)), and its query bases.
  int d[K7_BPT], cc[K7_BPT];
  uint32_t mt[K7_BPT];
  unsigned real = 0;
#pragma unroll
  for (int j = 0; j < K7_BPT; ++j) {
    const int i = lane + 32 * j, f = f_lo + i;
    const bool in = f >= 0 && f < a.NBF;
    const size_t o = row + (in ? f : 0);
    real |= (unsigned)in << j;
    d[j] = in ? __ldg(a.D0 + o) : 0;
    const bool s0 = in && __ldg(a.S0 + o), a0 = in && __ldg(a.A0 + o);
    mt[j] = (uint32_t)i | (s0 ? K7_STRAND : 0u) | (a0 ? K7_ASG : 0u);
    d0s[i] = d[j];
    s0s[i] = (uint8_t)((s0 ? 1u : 0u) | (in ? 0u : 2u) | (a0 ? 4u : 0u));
  }
  for (int u = 2 * r_lo + lane; u < 2 * r_hi; u += 32)
    reinterpret_cast<uint4*>(mine)[u] =
        __ldg(reinterpret_cast<const uint4*>(qrow) + u);
  __syncwarp();

  // 2. The mask table: tab[i * Cn + c] is block i's mask at the initial
  //    state of block g = i - E - 1 + c where g was assigned from the
  //    start (no other state reaches a neighbour as an assigned one, the
  //    final state of block i lies at c >= 1 and that of block i - 1 at
  //    c <= 2E). A candidate whose state equals the one before it takes
  //    the first of its run's mask, in a second pass. cp lanes a block.
  int cp = 1;
  while (cp < Cn) cp <<= 1;
  const int lg = __ffs(cp) - 1;
  auto head_of = [&](int i, int c) {   // -1: no mask; else the run's first
    const int g = i - E - 1 + c;
    if (g < 0 || g >= K7_TILE || !(s0s[g] & 4)) return -1;
    const int s = s0s[g] & 1, dg = d0s[g];
    int h = c;
    while (h > 0 && g - (c - h) - 1 >= 0 &&
           (s0s[g - (c - h) - 1] & 5) == (4 | s) &&
           d0s[g - (c - h) - 1] == dg)
      --h;
    return h;
  };
  for (int t0 = r_lo * cp; t0 < r_hi * cp; t0 += 32 * K7_GATHER) {
#pragma unroll
    for (int u = 0; u < K7_GATHER; ++u) {
      const int task = t0 + 32 * u + lane;
      const int i = task >> lg, c = task & (cp - 1);
      if (task >= r_hi * cp || c >= Cn) continue;
      const int h = head_of(i, c);
      if (h != c) {
        if (h < 0) tab[i * Cn + c] = 0u;
        continue;
      }
      const int g = i - E - 1 + c;
      tab[i * Cn + c] = block_mask(
          a, rrow, reinterpret_cast<const uint32_t*>(mine + i * FINE),
          f_lo + i, d0s[g], s0s[g] & 1, rlen, qlen);
    }
  }
  __syncwarp();
  for (int task = r_lo * cp + lane; task < r_hi * cp; task += 32) {
    const int i = task >> lg, c = task & (cp - 1);
    if (c >= Cn) continue;
    const int h = head_of(i, c);
    if (h >= 0 && h < c) tab[i * Cn + c] = tab[i * Cn + h];
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < K7_BPT; ++j)
    cc[j] = mt[j] & K7_ASG ? __popc(tab[(lane + 32 * j) * Cn + E + 1]) : -1;

  // 3. The steps, from the block before, then from the block after. A
  //    neighbour's state is read from before the step; past the tile's
  //    ends the neighbour counts as unassigned (only the halo is wrong).
  for (int step = 0; step < 2 * E; ++step) {
    int nd[K7_BPT];
    uint32_t nm[K7_BPT];
    if (step & 1) {            // block i + 1: lane + 1, or lane 0 of j + 1
#pragma unroll
      for (int j = 0; j < K7_BPT; ++j) {
        nd[j] = __shfl_down_sync(FULL, d[j], 1);
        nm[j] = __shfl_down_sync(FULL, mt[j], 1);
        const int wd = __shfl_sync(FULL, d[(j + 1) % K7_BPT], 0);
        const uint32_t wm = __shfl_sync(FULL, mt[(j + 1) % K7_BPT], 0);
        if (lane == 31) {
          nd[j] = wd;
          nm[j] = j + 1 < K7_BPT ? wm : 0u;
        }
      }
    } else {                   // block i - 1: lane - 1, or lane 31 of j - 1
#pragma unroll
      for (int j = 0; j < K7_BPT; ++j) {
        nd[j] = __shfl_up_sync(FULL, d[j], 1);
        nm[j] = __shfl_up_sync(FULL, mt[j], 1);
        const int wd = __shfl_sync(FULL, d[(j + K7_BPT - 1) % K7_BPT], 31);
        const uint32_t wm =
            __shfl_sync(FULL, mt[(j + K7_BPT - 1) % K7_BPT], 31);
        if (lane == 0) {
          nd[j] = wd;
          nm[j] = j ? wm : 0u;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < K7_BPT; ++j) {
      const int i = lane + 32 * j;
      if (!((real >> j) & 1u) || !(nm[j] & K7_ASG)) continue;
      const int cn = __popc(tab[i * Cn + (int)(nm[j] & K7_SRC) - i + E + 1]);
      if (cn >= a.ext_min && cn > cc[j] + a.ext_margin) {
        d[j] = nd[j];
        mt[j] = (nm[j] & (K7_SRC | K7_STRAND)) | K7_ASG;
        cc[j] = cn;
      }
    }
  }

  // 4. The tile's own blocks, o_t .. f_end - 1: the state and the previous
  //    block's (none before block 0), coalesced; their flag masks.
  const int i_lo = o_t - f_lo, i_hi = f_end - f_lo;
#pragma unroll
  for (int j = 0; j < K7_BPT; ++j) {
    int dp = __shfl_up_sync(FULL, d[j], 1);
    uint32_t mp = __shfl_up_sync(FULL, mt[j], 1);
    const int wd = __shfl_sync(FULL, d[(j + K7_BPT - 1) % K7_BPT], 31);
    const uint32_t wm = __shfl_sync(FULL, mt[(j + K7_BPT - 1) % K7_BPT], 31);
    if (lane == 0) {
      dp = j ? wd : 0;
      mp = j ? wm : 0u;
    }
    const int i = lane + 32 * j;
    if (i < i_lo || i >= i_hi) continue;
    const int s = (mt[j] & K7_STRAND) != 0, sp = (mp & K7_STRAND) != 0;
    const bool asg = (mt[j] & K7_ASG) != 0, ap = (mp & K7_ASG) != 0;
    const bool sw = asg && ap && (d[j] != dp || s != sp);
    const size_t o = row + f_lo + i;
    a.D[o] = d[j];
    a.S[o] = (uint8_t)s;
    a.A[o] = (uint8_t)asg;
    a.Dp[o] = dp;
    a.Sp[o] = (uint8_t)sp;
    a.Ap[o] = (uint8_t)ap;
    a.sw[o] = (uint8_t)sw;
    m1s[i] = asg ? tab[i * Cn + (int)(mt[j] & K7_SRC) - i + E + 1] : 0u;
    m0s[i] = sw ? tab[i * Cn + (int)(mp & K7_SRC) - i + E + 1] : 0u;
  }
  __syncwarp();

  // 5. The flags, 16 positions a lane (2 lanes a block), as bytes.
  for (int i0 = i_lo; i0 < i_hi; i0 += 16) {
    const int i = i0 + (lane >> 1), h = lane & 1;
    if (i >= i_hi) continue;
    const size_t o = (row + f_lo + i) * FINE + 16 * h;
    *reinterpret_cast<uint4*>(a.m1 + o) = bits_bytes(m1s[i] >> (16 * h));
    *reinterpret_cast<uint4*>(a.m0 + o) = bits_bytes(m0s[i] >> (16 * h));
  }
}

}  // namespace

extern "C" {

// K8. qsv, qoff: (Gq, NQ) int32, the sampled query seeds (value, or -1)
// and their offsets in their fine block, NQ = Lq / 32 * C; sv_f, sv_r:
// (Gr, NR) int32, each row ascending (BIG where invalid, last); pk1_*,
// pk2_*: (Gr, NR) int64, the packs aligned to sv (pack_bits 32: value << 16
// | position + 1 and value << 16 | previous + 1, or 0; 64: value << 40 |
// position + 1 << 20 | previous + 1, pk2 unused); r_rows: (R,), q_rows:
// (R, K) int32 arena rows. Writes votes: (R, K, NQ, 4) int32, 8-byte
// aligned. K * NQ < 2^31. Returns cudaGetLastError().
int k8_votes(const int32_t* qsv, const int32_t* qoff, const int32_t* sv_f,
             const int64_t* pk1_f, const int64_t* pk2_f, const int32_t* sv_r,
             const int64_t* pk1_r, const int64_t* pk2_r,
             const int32_t* r_rows, const int32_t* q_rows, int R, int K,
             int NQ, int NR, int C, int Lq, int Lr, int pack_bits,
             int32_t* votes, void* stream) {
  if (R < 1 || K < 1 || NQ < 1 || NR < 1 || C < 1 || C > K6_MAX_C ||
      NQ % C || (long long)K * NQ > 0x7fffffffLL ||
      (pack_bits != 32 && pack_bits != 64))
    return (int)cudaErrorInvalidValue;
  static bool smem_set[MAX_DEVICES] = {};
  int rc = allow_smem(votes_kernel, K8_SAMPLES * 4, smem_set);
  if (rc) return rc;
  int stride = 1;
  while ((NR + stride - 1) / stride > K8_SAMPLES) stride <<= 1;
  const int total = K * NQ;
  const int most = (total + K8_MIN_SLOTS - 1) / K8_MIN_SLOTS;
  int chunks = (4 * sm_count() + 2 * R - 1) / (2 * R);
  chunks = max(1, min(chunks, most));
  if ((long long)R * chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  VoteArgs a{qsv, qoff, {sv_f, sv_r}, {pk1_f, pk1_r}, {pk2_f, pk2_r},
             r_rows, q_rows, K, NQ, NR, C, Lq, Lq + Lr + 64,
             pack_bits == 64, stride, (NR + stride - 1) / stride, chunks,
             (total + chunks - 1) / chunks, votes};
  votes_kernel<<<dim3(R * chunks, 2), K8_THREADS, a.samples * 4,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// K6. votes: (N, NBF * C, 4) int32 (vote codes >= 0, BIG where none);
// writes A, S: (N, NBF) bool and D, vb: (N, NBF) int32. NBF % 4 == 0,
// 1 <= C <= 32, min_f, min_c >= 1. Returns cudaGetLastError().
int k6_elect(const int32_t* votes, int N, int NBF, int C, int Lq, int Lr,
             int min_f, int min_c, uint8_t* A, uint8_t* S, int32_t* D,
             int32_t* vb, void* stream) {
  if (N < 1 || NBF < 4 || NBF % 4 || C < 1 || C > K6_MAX_C || min_f < 1 ||
      min_c < 1)
    return (int)cudaErrorInvalidValue;
  int P = 1, lgP = 0;
  while (P < 4 * C) P <<= 1, ++lgP;
  const int dspan = Lq + Lr + 64;
  const long long warps = (long long)N * (NBF / 4);
  const long long ctas = (warps + K6_WARPS - 1) / K6_WARPS;
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  ElectArgs a{votes, N, NBF / 4, C, P, lgP, Lq, dspan,
              2LL * dspan + 64 < (1LL << 22) ? 22 : 32, min_f, min_c,
              A, S, D, vb};
  elect_kernel<<<(int)ctas, K6_WARPS * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// K7. q: (Gq, NBF * 32) int8 query codes, 16-byte aligned; q_rows, qlens:
// (N,) int32; r2dov: (Gr, 2 * NRT, 64) int8, 4-byte aligned (the window
// rows of both strands, each led by an all-pad row; NRT = Lr / 32 + 1);
// r_rows, rlens: (R,) int32, pair n on row n / K; A0, S0: (N, NBF) bool,
// D0: (N, NBF) int32, the election. Writes m1, m0: (N, NBF * 32) bool
// (16-byte aligned) and sw, A, S, Ap, Sp: (N, NBF) bool, D, Dp: (N, NBF)
// int32. 0 <= iters <= 16, ext_margin >= 0. Returns cudaGetLastError().
int k7_propagate(const int8_t* q, const int32_t* q_rows,
                 const int32_t* qlens, const int8_t* r2dov,
                 const int32_t* r_rows, const int32_t* rlens,
                 const uint8_t* A0, const uint8_t* S0, const int32_t* D0,
                 int N, int K, int NBF, int Lr, int NRT, int iters,
                 int ext_min, int ext_margin, uint8_t* m1, uint8_t* m0,
                 uint8_t* sw, uint8_t* A, uint8_t* S, int32_t* D,
                 uint8_t* Ap, uint8_t* Sp, int32_t* Dp, void* stream) {
  if (N < 1 || K < 1 || N % K || NBF < 1 || Lr < 1 || NRT < Lr / 32 + 1 ||
      iters < 0 || iters > K7_MAX_ITERS || ext_margin < 0)
    return (int)cudaErrorInvalidValue;
  static bool smem_set[MAX_DEVICES] = {};
  int rc = allow_smem(propagate_v2_kernel,
                      K7_WARPS * k7_warp_bytes(K7_MAX_ITERS), smem_set);
  if (rc) return rc;
  // Blocks a tile after the first writes; the first writes K7_TILE -
  // iters, or the whole pair if it holds it.
  const int out = K7_TILE - 2 * iters - 1;
  const int tiles = 1 + (max(NBF - K7_TILE, 0) + out - 1) / out;
  const long long ctas = ((long long)N * tiles + K7_WARPS - 1) / K7_WARPS;
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const V2PropArgs a{q, q_rows, qlens, r2dov, r_rows, rlens, A0, S0, D0,
                     N, K, NBF, Lr, NRT, iters, ext_min, ext_margin, out,
                     tiles, m1, m0, sw, A, S, D, Ap, Sp, Dp};
  propagate_v2_kernel<<<(int)ctas, K7_WARPS * 32,
                        K7_WARPS * k7_warp_bytes(iters),
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
