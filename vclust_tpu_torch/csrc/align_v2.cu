// K6 (K8 fused in) and K7: the v2 front end of the align row core (the
// seed votes and their two-scale election, the neighbour propagation and
// its flags).
//
// Replace the XLA device programs of the JAX package's `_row_core` (its
// ops/align_tpu.py:595-701): the sort join of the seed votes
// (`_strand_votes`, :296-352, called at :611-623), the election of the
// densest diagonal cluster per fine and per coarse block (`_elect`,
// :355-409, called at :628-650) and the propagation over re-evaluated
// windows with the final flags (stage 2b, :653-697, with `_eval_on`,
// :432-447, and `_window_rows`, :412-429). Both are bit-exact with the
// plain torch versions beside their wrappers in ops/align_gpu.py
// (`votes_elect_v2_plain`, i.e. `elect_v2_plain(votes_v2_plain(...))`, and
// `propagate_v2_plain`). A v2 dispatch is then three launches: K6, K7 and
// K4 (csrc/back_half.cu).
//
// K6 (k6_front): the seeds of a v2 dispatch in, the two-scale election out.
// The votes. For every query seed (value v >= 0) and strand, the two
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
// The election. Per fine block (4C votes) the fine election, per coarse
// block of 4 fine blocks (16C votes, sampled at stride 4 after sorting) the
// coarse one; each sorts its votes, counts for every vote the votes within
// GAP_DIAG among the next min(SMAX, w - 1), elects the largest count (ties:
// the smallest start, a packed max in 22 bits, or 32 where the vote codes
// need them, clamped in the pack's type), takes the mode inside the cluster
// (ties: the smallest) and its exact votes. The fine election stands where
// it beats the fine block's support for the coarse mode. A coarse block's
// votes come from its 4C seeds of one query against one reference row, and
// the election sorts them, so the two are one kernel: the votes never
// reach device memory (16 bytes a query slot, 189 MB written and read back
// at the B = 45 dispatch at 65,536 when they were two).
// What bounds it, and what the design does about it:
//   * Not bytes: the index rows and the seeds read once and 10 bytes a
//     fine block written. Operations: a search a seed and strand, then per
//     vote a sort of a few dozen compare-exchanges and two window counts.
//     What the card runs out of is the load unit, which the searches'
//     loads at random places (each lane's its own line: ~32 cycles a warp
//     instruction), the shared-memory descents and the sort's shuffles
//     share, and issue slots.
//   * The searches. A CTA (16 warps) takes a run of at least K6_MIN_ITEMS
//     (query, coarse block) items of one reference row, CTAs in row order,
//     a row cut into as many runs as keep the rows that the resident CTAs
//     read within K6_L2_BYTES, so the random reads hit L2. A CTA stages a
//     directory of each strand: every s-th sorted value (s the least power
//     of two with at most DIR_SAMPLES samples), in 16 bits (32 KB a
//     strand, two CTAs an SM), as a complete search tree in breadth-first
//     order, so a level's nodes lie side by side (a sorted array's
//     power-of-two strides put a descent's deep levels on one bank). A
//     search is a branch-free descent (13 levels at 65,536, 14 at
//     262,144), then the s >= 4 entries between two samples by 16-byte
//     loads: one at 65,536 (s = 4), one or two at 262,144 (s = 8; a load
//     only while the entries before it were <= v); the packs are read only
//     at the run's last entry and
//     the one before it (pk1's neighbour, one 16-byte load where aligned:
//     pk2 is never read). The directory holds BIG as TOP (the largest
//     value), so a search of TOP takes the row's valid entries, found at
//     staging. A lane runs its seeds x 2 strands searches interleaved.
//   * The election. A warp takes an item; lanes 8q .. 8q + 7 hold fine
//     block q's votes, V = 4, 8 or 16 a lane (4 a seed, BIG padding). A
//     lane sorts its own by a network; shuffle merges over lanes 1, 2, 4
//     sort each fine block, over 8, 16 the coarse block; the window counts
//     read the next lanes by shuffles and, the window being sorted, count
//     by a binary search of four selects (not 15 compares); the coarse
//     sample is registers 0, 4, ... of every lane; the packed maxes and
//     counts reduce by shuffles; the support for the coarse mode counts
//     the lane's votes, kept in registers. Nothing crosses CTAs.

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
//     the states and the election, the query bases and the reference
//     window rows read once. Beside them, the masks the steps compare: a
//     block's 32 bases against a window of the reference, at its own state
//     and at the neighbours' states that reach it. The rest is latency: a
//     list of masks waits on its window loads.
//   * Tiles as K5's (csrc/align_v3.cu), of 64 blocks of one pair (2 a
//     lane, lane + 32 j), with EXT_ITERS + 1 blocks of halo on the left
//     and EXT_ITERS on the right, so tiles never wait on each other; one
//     wave of CTAs of 4 warps, each warp taking tiles in turn, the next
//     tile's states loaded while it works on this one. Tiles of 128 held
//     more registers than 80 and spilled (tools/k6_probe.py).
//   * Only the masks that are read, every lane busy. Each assigned block's
//     mask at its own state (its m1 unless it adopts) comes first, its
//     loads issued at once with the tile's query bases, which are staged
//     in shared memory. A state reaches block i only from the initially
//     assigned blocks of [i - EXT_ITERS - 1, i + EXT_ITERS]; a run of one
//     state gives one mask, kept at the slot of the run's first block (or
//     of the window's first, where the run starts before it). Before every
//     step from the block before, the masks at both neighbours' current
//     states that the table lacks are listed over the warp by ballots and
//     evaluated 32 at a time: they cover that step and the next, since a
//     neighbour that moves in between takes the block's own state. Two
//     steps without an adoption end the steps.
//   * A mask: the window's 2 or 3 aligned 16-byte pieces of the 64-byte
//     row, the words selected and funnel-shifted to the phase, a byte
//     equality as a carry-free add (codes 0-4, a query N made 0x44), the
//     bits kept transposed (bit 8 j + k is position 4 k + j), so that a
//     flag word of 4 bytes is a shift and a mask.
//   * The table: c-major in shared memory, a slot a lane's own block, so
//     the steps' reads hit 32 banks.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// Devices a process may launch on (launch state is kept per device).
constexpr int MAX_DEVICES = 64;
constexpr int FINE = 32;
constexpr int BIG = 1 << 30;
constexpr int GAP_DIAG = 16;
constexpr int SMAX = 15;

// Sets the kernel's dynamic shared-memory limit once per device (and its
// preferred shared-memory carveout, in percent, where one is given).
template <typename Kernel>
int allow_smem(Kernel k, int bytes, bool (&done)[MAX_DEVICES],
               int carveout = -1) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && carveout >= 0)
      err = cudaFuncSetAttribute(
          k, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
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

// ---- K6 (K8 fused in) ------------------------------------------------------
constexpr int K6_WARPS = 16;
constexpr int K6_MAX_C = 32;          // VCLUST_ALIGN_C's range
constexpr int DIR_SAMPLES = 16384;    // directory entries a strand (32 KB)
constexpr int K6_MIN_ITEMS = 256;     // least items a CTA (pays its staging)
// A seed value's largest code (SEED_K 8): the directory holds values in 16
// bits, BIG as TOP too, so a search of TOP takes the row's valid entries.
constexpr int TOP = 0xFFFF;
// The reference rows (sv and pk1 of both strands) that the CTAs resident at
// once may read from: a sixth of the L2 (the searches' reads at random
// places of a row hit L2 the more often, the fewer rows are read at once;
// 24 MB ran slower at both v2 dispatches of PERF.md, tools/k6_probe.py).
constexpr long long K6_L2_BYTES = 8LL << 20;

struct FrontArgs {
  const int32_t *qsv, *qoff;        // (Gq, NQ)
  const int32_t* sv[2];             // (Gr, NR), forward and reverse
  const int64_t* pk1[2];            // (Gr, NR)
  const int32_t *r_rows, *q_rows;   // (R,), (R, K)
  int K, NBC, NQ, NR, C, Lq, dspan, pack64, s, ns, H, min_f, min_c;
  int chunks, per_cta;              // a row's runs of (query, block) items
  uint8_t *A, *S;
  int32_t *D, *vb;                  // (R * K, 4 * NBC)
  int32_t* votes;                   // (R, K, NQ, 4), or null
};

template <int V>
__device__ __forceinline__ void cmp_swap(int (&x)[V], int i, int j) {
  const int a = x[i], b = x[j];
  x[i] = min(a, b);
  x[j] = max(a, b);
}

// The half cleaners inside a lane: distances V/2 .. 1.
template <int V>
__device__ __forceinline__ void clean_lane(int (&x)[V]) {
#pragma unroll
  for (int j = V >> 1; j; j >>= 1)
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (i < (i ^ j)) cmp_swap(x, i, i ^ j);
}

// A lane's V registers ascending: a bitonic network whose first step of
// each merge compares mirrored registers (every run it forms ascends).
template <int V>
__device__ __forceinline__ void sort_lane(int (&x)[V]) {
#pragma unroll
  for (int k = 2; k <= V; k <<= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (i < (i ^ (k - 1))) cmp_swap(x, i, i ^ (k - 1));
#pragma unroll
    for (int j = k >> 2; j; j >>= 1)
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (i < (i ^ j)) cmp_swap(x, i, i ^ j);
  }
}

// Runs of M lanes (ascending, lane-major: element lane * V + i) become
// runs of 2M: the mirrored step against register V - 1 - i of lane ^ (2M -
// 1), half cleaners over lanes M/2 .. 1, then inside the lane.
template <int V, int M>
__device__ __forceinline__ void merge_lanes(int (&x)[V], int lane) {
  int y[V];
#pragma unroll
  for (int i = 0; i < V; ++i)
    y[i] = __shfl_xor_sync(FULL, x[V - 1 - i], 2 * M - 1);
  bool low = !(lane & M);
#pragma unroll
  for (int i = 0; i < V; ++i) x[i] = low ? min(x[i], y[i]) : max(x[i], y[i]);
#pragma unroll
  for (int m = M >> 1; m; m >>= 1) {
    low = !(lane & m);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int o = __shfl_xor_sync(FULL, x[i], m);
      x[i] = low ? min(x[i], o) : max(x[i], o);
    }
  }
  clean_lane(x);
}

// The count of nx[i + 1 .. i + SMAX] that are <= lim, where they ascend (a
// sorted list, BIG past its end): a binary search of four steps on
// registers, each step's candidate picked by selects.
template <int N>
__device__ __forceinline__ int count_le(const int (&nx)[N], int i, int lim) {
  static_assert(SMAX == 15, "four steps");
  const bool b8 = nx[i + 8] <= lim;
  const bool b4 = (b8 ? nx[i + 12] : nx[i + 4]) <= lim;
  const bool b2 = (b8 ? (b4 ? nx[i + 14] : nx[i + 10])
                      : (b4 ? nx[i + 6] : nx[i + 2])) <= lim;
  const bool b1 = (b8 ? (b4 ? (b2 ? nx[i + 15] : nx[i + 13])
                            : (b2 ? nx[i + 11] : nx[i + 9]))
                      : (b4 ? (b2 ? nx[i + 7] : nx[i + 5])
                            : (b2 ? nx[i + 3] : nx[i + 1]))) <= lim;
  return 8 * b8 + 4 * b4 + 2 * b2 + b1;
}

template <int SPAN, typename T>
__device__ __forceinline__ T span_max(T v) {
#pragma unroll
  for (int o = SPAN >> 1; o; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <int SPAN>
__device__ __forceinline__ int span_sum(int v) {
#pragma unroll
  for (int o = SPAN >> 1; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The election on the sorted list w (N values a lane, lane-major over
// groups of SPAN lanes, BIG past its w votes), its exact votes counted over
// y (NY values a lane): every vote's count of the votes within GAP_DIAG
// among the next SMAX (the lane's own registers, then lanes + 1, + 2, ...
// by shuffles; BIG past the group; count_le, as they ascend) and of those
// equal (those <= the vote, as they ascend), the largest count
// with ties to the smallest start (a packed max of P: 22 bits of vote code
// in int, or 32 in long long, clamped in P), the cluster's mode (ties to
// the smallest) and its exact votes. BIG where nothing was elected.
template <typename P, int VB, int SPAN, int N, int NY>
__device__ __forceinline__ void elect(const int (&w)[N], const int (&y)[NY],
                                      int lane, int& medv, int& votes) {
  constexpr P VM = (P(1) << VB) - 1;
  int nx[N + SMAX];
#pragma unroll
  for (int i = 0; i < N; ++i) nx[i] = w[i];
  const int at = lane & (SPAN - 1);
#pragma unroll
  for (int j = 0; j < SMAX; ++j) {
    const int d = 1 + j / N;
    const int o = __shfl_down_sync(FULL, w[j % N], d);
    nx[N + j] = at + d < SPAN ? o : BIG;
  }
  int eq[N];
  P best = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int xi = w[i];
    const int c = xi < BIG ? 1 + count_le(nx, i, xi + GAP_DIAG) : 0;
    eq[i] = xi < BIG ? 1 + count_le(nx, i, xi) : 0;
    best = max(best, (P(c) << VB) | (VM - min(P(xi), VM)));
  }
  best = span_max<SPAN>(best);
  const int vb = (int)(best >> VB);
  const P start = VM - (best & VM);
  P bm = -1;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (P(w[i]) >= start && P(w[i]) <= start + GAP_DIAG)
      bm = max(bm, (P(eq[i]) << VB) | (VM - min(P(w[i]), VM)));
  bm = span_max<SPAN>(bm);
  medv = vb > 0 ? (int)(VM - (bm & VM)) : BIG;
  int n = 0;
  if (medv < BIG)
#pragma unroll
    for (int i = 0; i < NY; ++i) n += abs(y[i] - medv) <= GAP_DIAG;
  votes = span_sum<SPAN>(n);
}

// One item, (query k, coarse block cb) of row r, by the whole warp. dir:
// the directory of both strands; tail: per strand, the row's valid entries
// (< BIG) and whether the last of them holds TOP.
template <int SPL, bool WIDE>
__device__ __forceinline__ void front_item(const FrontArgs& a,
                                           const uint16_t* dir,
                                           const int* tail, int nodes,
                                           int r, int g, int item, int lane) {
  constexpr int V = SPL == 1 ? 4 : SPL == 2 ? 8 : 16;   // votes a lane
  constexpr int NS = 2 * SPL;        // searches a lane: seeds x strands
  using P = typename std::conditional<WIDE, long long, int>::type;
  constexpr int VB = WIDE ? 32 : 22;
  const int k = item / a.NBC, cb = item - k * a.NBC;
  const int lq = lane & 7;
  const long long n = (long long)r * a.K + k;            // the pair
  const int f = 4 * cb + (lane >> 3);                    // the lane's block
  const size_t qo = (size_t)__ldg(a.q_rows + n) * a.NQ + (size_t)f * a.C;

  // 1. The lane's seeds: l, l + 8, ... of its fine block (-1: none).
  int v[SPL], qpos[SPL];
#pragma unroll
  for (int t = 0; t < SPL; ++t) {
    const int c = lq + 8 * t;
    v[t] = -1;
    qpos[t] = 0;
    if (c < a.C) {
      v[t] = __ldg(a.qsv + qo + c);
      qpos[t] = f * FINE + (__ldg(a.qoff + qo + c) & 31);
    }
  }

  // 2. The descents, every search of the lane at once: node k goes right
  //    where its sample is <= v; after H levels k - 2^H samples are.
  int kk[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) kk[j] = 1;
  for (int lvl = 0; lvl < a.H; ++lvl)
#pragma unroll
    for (int j = 0; j < NS; ++j)
      kk[j] = 2 * kk[j] + (dir[(j & 1) * nodes + kk[j]] <= v[j >> 1]);

  // 3. The segment [g s, g s + s) after sample g: its entries <= v and
  //    == v, 16 bytes a load (s >= 4, NR % 4 == 0), none past NR; a load
  //    only while every entry before it was <= v (the segment ascends). A
  //    search of TOP counts every valid entry (tail).
  const int32_t* svr[2] = {a.sv[0] + (size_t)g * a.NR,
                           a.sv[1] + (size_t)g * a.NR};
  int seg0[NS], cnt[NS], eqc[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    seg0[j] = (kk[j] - nodes) * a.s;
    cnt[j] = eqc[j] = 0;
  }
  for (int o = 0; o < a.s; o += 4)
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int vv = v[j >> 1];
      if (vv < 0 || vv == TOP || seg0[j] + o >= a.NR || cnt[j] < o) continue;
      const int4 e = __ldg(reinterpret_cast<const int4*>(svr[j & 1] +
                                                         seg0[j] + o));
      cnt[j] += (e.x <= vv) + (e.y <= vv) + (e.z <= vv) + (e.w <= vv);
      eqc[j] += (e.x == vv) + (e.y == vv) + (e.z == vv) + (e.w == vv);
    }
#pragma unroll
  for (int j = 0; j < NS; ++j)
    if (v[j >> 1] == TOP) {
      seg0[j] = 0;
      cnt[j] = tail[2 * (j & 1)];
      eqc[j] = tail[2 * (j & 1) + 1];
    }

  // 4. The packs of the run of entries equal to v, which ends at ub - 1
  //    (eqc > 0). `_index_block` keeps a run's positions ascending, and
  //    pk2 of an entry is pk1's position of the entry before it where the
  //    two hold one value: so the plain version's maxes over the run are
  //    pk1 at ub - 1 and, for 32-bit packs, pk1 at ub - 2 where that entry
  //    holds v (its neighbour in memory, one 16-byte load where the pair
  //    is aligned: pk2 is never read).
  long long m1[NS], m0[NS];
  const size_t prow = (size_t)g * a.NR;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    m1[j] = m0[j] = 0;
    if (!eqc[j]) continue;
    const int last = seg0[j] + cnt[j] - 1;
    const int64_t* pk = a.pk1[j & 1] + prow;
    if (a.pack64) {
      m1[j] = __ldg(pk + last);
    } else if (last & 1) {
      const longlong2 p =
          __ldg(reinterpret_cast<const longlong2*>(pk + last - 1));
      m0[j] = p.x;
      m1[j] = p.y;
    } else {
      m1[j] = __ldg(pk + last);
      if (last > 0) m0[j] = __ldg(pk + last - 1);
    }
  }

  // 5. The votes: seed t's two candidates forward, then the two reverse,
  //    at registers 4t .. 4t + 3; BIG where none and past 4 SPL.
  int x[V], y[V];
#pragma unroll
  for (int i = 0; i < V; ++i) x[i] = BIG;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int t = j >> 1, st = j & 1;
    if (!eqc[j]) continue;
    const long long vv = v[t];
    const int base = a.Lq + (st ? a.dspan : 0) - qpos[t];
    if (!a.pack64) {
      if ((m1[j] >> 16) == vv && m1[j] > 0)
        x[2 * j] = (int)(m1[j] & 0xFFFF) - 1 + base;
      if ((m0[j] >> 16) == vv && m0[j] > 0)
        x[2 * j + 1] = (int)(m0[j] & 0xFFFF) - 1 + base;
    } else if ((m1[j] >> 40) == vv && m1[j] > 0) {
      x[2 * j] = (int)((m1[j] >> 20) & 0xFFFFF) - 1 + base;
      const int cq = (int)(m1[j] & 0xFFFFF);
      if (cq > 0) x[2 * j + 1] = cq - 1 + base;
    }
  }
  if (a.votes) {
#pragma unroll
    for (int t = 0; t < SPL; ++t)
      if (lq + 8 * t < a.C)
        reinterpret_cast<int4*>(a.votes)[n * a.NQ + (size_t)f * a.C + lq +
                                         8 * t] =
            make_int4(x[4 * t], x[4 * t + 1], x[4 * t + 2], x[4 * t + 3]);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) y[i] = x[i];

  // 6. Fine block q's votes sorted over lanes 8q .. 8q + 7, its election;
  //    the coarse block's sorted over the warp, the election on its every
  //    fourth vote (registers 0, 4, ...: V >= 4), its exact votes over all.
  sort_lane(x);
  merge_lanes<V, 1>(x, lane);
  merge_lanes<V, 2>(x, lane);
  merge_lanes<V, 4>(x, lane);
  int medv_f, vb_f;
  elect<P, VB, 8>(x, x, lane, medv_f, vb_f);
  merge_lanes<V, 8>(x, lane);
  merge_lanes<V, 16>(x, lane);
  int xs[V / 4];
#pragma unroll
  for (int i = 0; i < V / 4; ++i) xs[i] = x[4 * i];
  int medv_c, vb_c;
  elect<P, VB, 32>(xs, x, lane, medv_c, vb_c);

  // 7. The fine block's support for the coarse mode, from its votes kept
  //    in y (BIG ones count where the mode is BIG, as the plain version's;
  //    nothing is coarse-assigned then); lane 8q writes block q.
  int sup = 0;
#pragma unroll
  for (int i = 0; i < V; ++i) sup += abs(y[i] - medv_c) <= GAP_DIAG;
  sup = span_sum<8>(sup);
  if (lq) return;
  const bool A_c = vb_c >= a.min_c, S_c = medv_c >= a.dspan;
  const int D_c = (S_c ? medv_c - a.dspan : medv_c) - a.Lq;
  const bool A_f = vb_f >= a.min_f, S_f = medv_f >= a.dspan;
  const int D_f = (S_f ? medv_f - a.dspan : medv_f) - a.Lq;
  const bool use_f = A_f && (!A_c || vb_f > sup);
  const size_t o = (size_t)n * 4 * a.NBC + f;
  a.A[o] = (uint8_t)(use_f || A_c);
  a.S[o] = (uint8_t)(use_f ? S_f : S_c);
  a.D[o] = use_f ? D_f : D_c;
  a.vb[o] = use_f ? vb_f : vb_c;
}

// Two CTAs of 16 warps an SM (64 registers a thread) where a lane holds 8
// votes or fewer, one where it holds 16 (three CTAs of 8 warps ran slower,
// tools/k6_probe.py). CTA blockIdx.x takes run blockIdx.x % chunks of row
// blockIdx.x / chunks.
template <int SPL, bool WIDE>
__global__ void __launch_bounds__(K6_WARPS * 32, SPL <= 2 ? 2 : 1)
    front_kernel(FrontArgs a) {
  extern __shared__ uint16_t k6_dir[];  // 2 strands x 2^H (node 0 unused)
  __shared__ int k6_last[2];            // a strand's last valid sample
  __shared__ int k6_tail[4];            // see front_item
  // The warp index from lane 0: the compiler sees it uniform in the warp,
  // so the item loop's shuffles need no divergent path.
  const int warp = __shfl_sync(FULL, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int nodes = 1 << a.H;
  const int r = blockIdx.x / a.chunks;
  const int lo = (blockIdx.x - r * a.chunks) * a.per_cta;
  const int hi = min(lo + a.per_cta, a.K * a.NBC);
  const int g = __ldg(a.r_rows + r);
  const int32_t* svr[2] = {a.sv[0] + (size_t)g * a.NR,
                           a.sv[1] + (size_t)g * a.NR};
  if (threadIdx.x < 2) k6_last[threadIdx.x] = -1;
  __syncthreads();
  // In-order node m = i - 1 (i = (2p + 1) 2^(H - 1 - d)) is node 2^d + p
  // of the breadth-first order, d = H - 1 - ctz(i); it holds sample i (in
  // 16 bits, BIG as TOP). The valid samples lead: a warp's last valid one
  // by a ballot.
  for (int i0 = 0; i0 < nodes; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int x = i < a.ns ? __ldg(svr[st] + (size_t)i * a.s) : BIG;
      if (i && i < nodes) {
        const int d = a.H - __ffs(i);
        k6_dir[st * nodes + (1 << d) + (i >> (a.H - d))] =
            (uint16_t)min(x, TOP);
      }
      const unsigned ok = __ballot_sync(FULL, x < BIG);
      if (ok && lane == 0) atomicMax(&k6_last[st], i - lane + 31 - __clz(ok));
    }
  }
  __syncthreads();
  // Warp st: the valid entries of strand st end in the segment of its last
  // valid sample.
  if (warp < 2) {
    const int last = k6_last[warp];
    int nv = 0;
    if (last >= 0) {
      nv = last * a.s;
      for (int o = 0; o < a.s; o += 32) {
        const int e = last * a.s + o + lane;
        const bool ok =
            o + lane < a.s && e < a.NR && __ldg(svr[warp] + e) < BIG;
        nv += __popc(__ballot_sync(FULL, ok));
      }
    }
    if (lane == 0) {
      k6_tail[2 * warp] = nv;
      k6_tail[2 * warp + 1] = nv > 0 && __ldg(svr[warp] + nv - 1) == TOP;
    }
  }
  __syncthreads();
  for (int it = lo + warp; it < hi; it += K6_WARPS)
    front_item<SPL, WIDE>(a, k6_dir, k6_tail, nodes, r, g, it, lane);
}

// ---- K7 ------------------------------------------------------------------
constexpr int K7_WARPS = 4;               // warps a CTA, each a tile at a time
constexpr int K7_MIN_CTAS = 6;            // CTAs an SM the registers allow
constexpr int K7_BPT = 2;                 // blocks a lane: lane + 32 j
constexpr int K7_TILE = 32 * K7_BPT;      // blocks a tile holds, halo included
constexpr int K7_MAX_ITERS = 16;          // VCLUST_ALIGN_EXTI's range

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

// Shared memory of a warp: the mask table, c-major (slot c of tile block i
// at tab[c * K7_TILE + i], so that lanes reading a slot each of their own
// blocks hit 32 banks), 2 EXT_ITERS + 2 slots; the tile's query bases (the
// first 16 of every block, then the last 16); its initial diagonals and
// strands; the task list, 2 entries a block of 16 bits.
__host__ __device__ constexpr int k7_tab_bytes(int iters) {
  return 4 * K7_TILE * (2 * iters + 2);
}
__host__ __device__ constexpr int k7_warp_bytes(int iters) {
  return k7_tab_bytes(iters) + 32 * K7_TILE + 5 * K7_TILE + 2 * 2 * K7_TILE;
}

// A block's state in a register: the first block of the run of its state's
// source (bits 0-7, a tile index), strand (bit 8), assigned (bit 9); the
// diagonal beside it.
constexpr uint32_t K7_SRC = 255u, K7_STRAND = 256u, K7_ASG = 512u;

// A mask's bit 8 j + k is position 4 k + j of the block: the flag word k
// (positions 4 k .. 4 k + 3, a byte each) is then (m >> k) & 0x01010101.
// The bits of positions [lo, hi), 0 <= lo < hi <= 32.
__device__ __forceinline__ uint32_t k7_range(int lo, int hi) {
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k0 = (lo - j + 3) >> 2, k1 = (hi - j + 3) >> 2;
    m |= (((1u << k1) - 1u) & ~((1u << k0) - 1u) & 0xFFu) << (8 * j);
  }
  return m;
}

// The query bases of a block (32 codes, 0-4, as two 16-byte pieces) as 8
// words with N (4) made 0x44: a byte of the XOR with a reference word is 0
// exactly where the query base is 0-3 and equals the reference's, and at
// most 0x47.
__device__ __forceinline__ void k7_query(const uint4 (&q)[2],
                                         uint32_t (&qx)[8]) {
  const uint32_t w[8] = {q[0].x, q[0].y, q[0].z, q[0].w,
                         q[1].x, q[1].y, q[1].z, q[1].w};
#pragma unroll
  for (int k = 0; k < 8; ++k) qx[k] = w[k] | (w[k] & 0x04040404u) << 4;
}

__device__ __forceinline__ void k7_load_query(const int8_t* qblock,
                                              uint4 (&q)[2]) {
  const uint4* p = reinterpret_cast<const uint4*>(qblock);
  q[0] = __ldg(p);
  q[1] = __ldg(p + 1);
}

// Block f's window at diagonal d on the strand whose window rows start at
// rrow: position t counts where the reference base at f * 32 + t + d lies
// inside the reference (rlen) and the query (qhi, its bases left in the
// block), none where the window start was clipped to [-32, Lr - 1]. Its 32
// bases lie in a 64-byte row at a phase of 0-31, read as the 2 or 3 aligned
// 16-byte pieces that hold them (x, zeros where nothing counts).
struct K7Win {
  uint4 x[3];
  int phase, t_lo, t_hi;
};

__device__ __forceinline__ K7Win k7_window(const int8_t* rrow, int f, int d,
                                           int Lr, int rlen, int qhi,
                                           bool want) {
  K7Win w;
  const int start = f * FINE + d;
  const int sc = min(max(start, -FINE), Lr - 1);
  w.t_lo = max(0, -start);
  w.t_hi = min(FINE, min(rlen - start, qhi));
  const bool keep = want && start == sc && w.t_hi > w.t_lo;
  const int row = (sc + FINE) >> 5;
  w.phase = sc + FINE - (row << 5);
  const uint4* p =
      reinterpret_cast<const uint4*>(rrow + (size_t)row * 64) +
      (w.phase >> 4);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  w.x[0] = keep ? __ldg(p) : z;
  w.x[1] = keep ? __ldg(p + 1) : z;
  w.x[2] = keep && (w.phase & 15) ? __ldg(p + 2) : z;
  if (!keep) w.t_hi = w.t_lo = 0;
  return w;
}

// The block's match mask in its window (0 where nothing counts): the words
// selected and funnel-shifted to the phase, a byte equality as a carry-free
// add, the positions outside [t_lo, t_hi) cleared.
__device__ __forceinline__ uint32_t k7_match(const K7Win& w,
                                             const uint32_t (&qx)[8]) {
  if (w.t_hi <= w.t_lo) return 0u;
  const uint32_t x[12] = {w.x[0].x, w.x[0].y, w.x[0].z, w.x[0].w,
                          w.x[1].x, w.x[1].y, w.x[1].z, w.x[1].w,
                          w.x[2].x, w.x[2].y, w.x[2].z, w.x[2].w};
  const int wo = (w.phase >> 2) & 3, sh = 8 * (w.phase & 3);
  uint32_t v[10], u[9];
#pragma unroll
  for (int k = 0; k < 10; ++k) v[k] = wo & 2 ? x[k + 2] : x[k];
#pragma unroll
  for (int k = 0; k < 9; ++k) u[k] = wo & 1 ? v[k + 1] : v[k];
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t y = (__funnelshift_r(u[k], u[k + 1], sh) ^ qx[k]) +
                       0x7F7F7F7Fu;
    m |= (~y >> (7 - k)) & (0x01010101u << k);
  }
  return w.t_lo > 0 || w.t_hi < FINE ? m & k7_range(w.t_lo, w.t_hi) : m;
}

// A block's mask at another state than its own initial one lies in the
// table, c-major, at the slot of that state's source run: the run's first
// block, or block i - E - 1 where the run starts before it (a state reaches
// block i or i + 1 only from [i - E - 1, i + E]); at its own initial state
// it is the block's own mask.
struct K7Tile {
  uint32_t* tab;
  uint16_t* list;                   // tasks: block i << 7 | source g
  int E;
  __device__ __forceinline__ int slot(int i, int g) const {
    return max(g, i - E - 1) - (i - E - 1);
  }
  __device__ __forceinline__ bool own_state(bool own_asg, int d0, bool s0,
                                            int d, uint32_t x) const {
    return own_asg && d == d0 && ((x & K7_STRAND) != 0) == s0;
  }
  __device__ __forceinline__ uint32_t mask(int i, bool own_asg, int d0,
                                           bool s0, uint32_t own, int d,
                                           uint32_t x) const {
    return own_state(own_asg, d0, s0, d, x)
               ? own
               : tab[slot(i, (int)(x & K7_SRC)) * K7_TILE + i];
  }
  // Whether a block (at state (d, mt), count cc) needs its mask at an
  // assigned neighbour's state (nd, nm): not at its own current state,
  // where the count could not beat its own.
  __device__ __forceinline__ static bool needs(bool real, int cc, int d,
                                               uint32_t mt, int nd,
                                               uint32_t nm) {
    return real && (nm & K7_ASG) &&
           !(cc >= 0 && nd == d && ((nm ^ mt) & K7_STRAND) == 0);
  }
  // Whether block i needs that mask and the table lacks it (then its task
  // entry, and the slot marked in done).
  __device__ __forceinline__ void wanted(int i, bool real, bool own_asg,
                                         int d0, bool s0, int cc, int d,
                                         uint32_t mt, int nd, uint32_t nm,
                                         uint64_t& done, bool& want,
                                         uint16_t& entry) const {
    const int c = slot(i, (int)(nm & K7_SRC));
    want = needs(real, cc, d, mt, nd, nm) &&
           !own_state(own_asg, d0, s0, nd, nm) && !((done >> c) & 1ull);
    if (want) done |= 1ull << c;
    entry = (uint16_t)(i << 7 | (nm & K7_SRC));
  }
};

// Appends each lane's wanted entries to the warp's task list, in order of
// m, then lane; returns the list's length.
template <int M>
__device__ __forceinline__ int k7_list(uint16_t* list, const bool (&want)[M],
                                       const uint16_t (&entry)[M],
                                       int lane) {
  int n = 0;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const uint32_t bal = __ballot_sync(FULL, want[m]);
    if (want[m]) list[n + __popc(bal & ((1u << lane) - 1u))] = entry[m];
    n += __popc(bal);
  }
  return n;
}

__device__ __forceinline__ uint4 k7_flags(uint32_t m, int h) {
  m >>= 4 * h;
  return make_uint4(m & 0x01010101u, (m >> 1) & 0x01010101u,
                    (m >> 2) & 0x01010101u, (m >> 3) & 0x01010101u);
}

// The neighbours' states of a lane's blocks: of block i - 1 (lane - 1, or
// lane 31 of j - 1) or of block i + 1 (lane + 1, or lane 0 of j + 1);
// outside the tile unassigned (only the halo is then wrong).
__device__ __forceinline__ void k7_neighbours(const int (&d)[K7_BPT],
                                              const uint32_t (&mt)[K7_BPT],
                                              bool after, int lane,
                                              int (&nd)[K7_BPT],
                                              uint32_t (&nm)[K7_BPT]) {
  if (after) {
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
  } else {
#pragma unroll
    for (int j = 0; j < K7_BPT; ++j) {
      nd[j] = __shfl_up_sync(FULL, d[j], 1);
      nm[j] = __shfl_up_sync(FULL, mt[j], 1);
      const int wd = __shfl_sync(FULL, d[(j + K7_BPT - 1) % K7_BPT], 31);
      const uint32_t wm = __shfl_sync(FULL, mt[(j + K7_BPT - 1) % K7_BPT], 31);
      if (lane == 0) {
        nd[j] = j ? wd : 0;
        nm[j] = j ? wm : 0u;
      }
    }
  }
}

__global__ void __launch_bounds__(K7_WARPS * 32, K7_MIN_CTAS)
propagate_v2_kernel(V2PropArgs a) {
  extern __shared__ __align__(16) uint8_t k7_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int E = a.iters;
  uint8_t* mine = k7_smem + warp * k7_warp_bytes(E);
  uint4* qs = reinterpret_cast<uint4*>(mine + k7_tab_bytes(E));
  int32_t* d0s = reinterpret_cast<int32_t*>(qs + 2 * K7_TILE);
  uint8_t* s0s = reinterpret_cast<uint8_t*>(d0s + K7_TILE);
  const K7Tile tile{reinterpret_cast<uint32_t*>(mine),
                    reinterpret_cast<uint16_t*>(s0s + K7_TILE), E};
  const long long units = (long long)a.N * a.tiles;
  const long long stride = (long long)gridDim.x * K7_WARPS;
  // A unit's tile: tile t of pair n writes blocks o_t .. and holds blocks
  // f_lo .. f_lo + K7_TILE - 1, as K5's tiles (csrc/align_v3.cu); its
  // blocks' initial states, lane + 32 j in lane j (blocks outside the pair
  // unassigned at (forward, 0)), loaded a unit ahead.
  struct Raw {
    int n, o_t, f_lo, d0[K7_BPT];
    uint8_t s0[K7_BPT], a0[K7_BPT];
  };
  auto fetch = [&](long long unit, Raw& x) {
    x.n = (int)(unit / a.tiles);
    const int t = (int)(unit % a.tiles);
    x.o_t = t ? K7_TILE - E + (t - 1) * a.out : 0;
    x.f_lo = t ? x.o_t - (E + 1) : 0;
#pragma unroll
    for (int j = 0; j < K7_BPT; ++j) {
      const int f = x.f_lo + lane + 32 * j;
      const bool in = f < a.NBF;
      const size_t o = (size_t)x.n * a.NBF + (in ? f : 0);
      x.d0[j] = in ? __ldg(a.D0 + o) : 0;
      x.s0[j] = in ? __ldg(a.S0 + o) : 0;
      x.a0[j] = in ? __ldg(a.A0 + o) : 0;
    }
  };
  long long unit = (long long)blockIdx.x * K7_WARPS + warp;
  Raw next;
  if (unit < units) fetch(unit, next);
  for (; unit < units; unit += stride) {
    const Raw cur = next;
    if (unit + stride < units) fetch(unit + stride, next);
    const int n = cur.n, o_t = cur.o_t, f_lo = cur.f_lo;
    const int f_end = f_lo + K7_TILE >= a.NBF ? a.NBF : f_lo + K7_TILE - E;
    const size_t row = (size_t)n * a.NBF;
    const int r = n / a.K;
    const int qlen = __ldg(a.qlens + n), rlen = __ldg(a.rlens + r);
    const int8_t* rrow =
        a.r2dov + (size_t)__ldg(a.r_rows + r) * 2 * a.NRT * 64;
    const int8_t* qrow = a.q + (size_t)__ldg(a.q_rows + n) * a.NBF * FINE;
    // Tile block i's mask at the initial state of tile block g.
    auto mask_at = [&](int i, int g) {
      const int f = f_lo + i;
      const uint4 q[2] = {qs[i], qs[K7_TILE + i]};
      const K7Win w = k7_window(rrow + (s0s[g] ? (size_t)a.NRT * 64 : 0), f,
                                d0s[g], a.Lr, rlen, qlen - f * FINE, true);
      uint32_t qx[8];
      k7_query(q, qx);
      return k7_match(w, qx);
    };
    // Evaluates the T listed tasks 32 at a time (every lane busy).
    auto run = [&](int T) {
      __syncwarp();
      for (int k = lane; k < T; k += 32) {
        const int e = tile.list[k], i = e >> 7, g = e & 127;
        tile.tab[tile.slot(i, g) * K7_TILE + i] = mask_at(i, g);
      }
      __syncwarp();
    };
    __syncwarp();   // the last unit's table, list and states read

    // 1. The initial states and the query bases, staged; each assigned
    //    block's mask at its own state (its m1 unless it adopts), every
    //    load of them at once.
    int d[K7_BPT], d0[K7_BPT], cc[K7_BPT];
    uint32_t mt[K7_BPT], own[K7_BPT];
    uint64_t done[K7_BPT];   // the table slots a block has
    unsigned real = 0, asg0 = 0, str0 = 0;
    uint4 q[K7_BPT][2];
    K7Win w[K7_BPT];
#pragma unroll
    for (int j = 0; j < K7_BPT; ++j) {
      const int i = lane + 32 * j, f = f_lo + i;
      const bool in = f < a.NBF;
      d0[j] = cur.d0[j];
      real |= (unsigned)in << j;
      asg0 |= (unsigned)(cur.a0[j] != 0) << j;
      str0 |= (unsigned)(cur.s0[j] != 0) << j;
      d0s[i] = d0[j];
      s0s[i] = (uint8_t)(cur.s0[j] != 0);
      done[j] = 0;
      q[j][0] = q[j][1] = make_uint4(0u, 0u, 0u, 0u);
      if (in) k7_load_query(qrow + (size_t)f * FINE, q[j]);
      w[j] = k7_window(rrow + (cur.s0[j] ? (size_t)a.NRT * 64 : 0), f, d0[j],
                       a.Lr, rlen, qlen - f * FINE, cur.a0[j] != 0);
    }
#pragma unroll
    for (int j = 0; j < K7_BPT; ++j) {
      qs[lane + 32 * j] = q[j][0];
      qs[K7_TILE + lane + 32 * j] = q[j][1];
      uint32_t qx[8];
      k7_query(q[j], qx);
      own[j] = (asg0 >> j) & 1u ? k7_match(w[j], qx) : 0u;
    }
    __syncwarp();

    // 2. Runs of one state: an assigned block whose previous block is not
    //    assigned at its state starts one (tile index 0 too); a state word
    //    carries its run's first block as its source.
    const unsigned pa = __shfl_up_sync(FULL, asg0, 1);
    const unsigned wa = __shfl_sync(FULL, asg0, 31);
    int last = 0;   // the last run start before word j
#pragma unroll
    for (int j = 0; j < K7_BPT; ++j) {
      const int i = lane + 32 * j;
      const bool a0 = (asg0 >> j) & 1u, s0 = (str0 >> j) & 1u;
      const bool prev_a = lane ? (pa >> j) & 1u : j && ((wa >> (j - 1)) & 1u);
      const bool cont = prev_a && d0s[i - 1] == d0[j] && s0s[i - 1] == s0;
      const uint32_t as = __ballot_sync(FULL, a0 && !cont);
      const uint32_t upto = as & (FULL >> (31 - lane));
      const int h = upto ? 32 * j + 31 - __clz(upto) : last;
      if (as) last = 32 * j + 31 - __clz(as);
      d[j] = d0[j];
      mt[j] = (uint32_t)h | (s0 ? K7_STRAND : 0u) | (a0 ? K7_ASG : 0u);
      cc[j] = a0 ? __popc(own[j]) : -1;
    }

    // 3. The steps, from the block before, then from the block after, each
    //    reading the neighbours' states from before it. A block needs a
    //    mask at an assigned neighbour's state unless that is its own
    //    current state (the count could not beat its own). Before every step
    //    from the block before, the masks at both neighbours' current states
    //    that the table lacks are listed over the warp and evaluated: they
    //    cover that step and the next (a neighbour that moves in between
    //    takes the block's own state, whose mask it has). Two steps in a row
    //    without an adoption leave the states as they are.
    int nd[K7_BPT];
    uint32_t nm[K7_BPT];
    for (int step = 0, quiet = 0; step < 2 * E && quiet < 2; ++step) {
      if (!(step & 1)) {     // the block after's states, then the one before's
        bool want[2 * K7_BPT];
        uint16_t entry[2 * K7_BPT];
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          k7_neighbours(d, mt, !side, lane, nd, nm);
#pragma unroll
          for (int j = 0; j < K7_BPT; ++j)
            tile.wanted(lane + 32 * j, (real >> j) & 1u, (asg0 >> j) & 1u,
                        d0[j], (str0 >> j) & 1u, cc[j], d[j], mt[j], nd[j],
                        nm[j], done[j], want[side * K7_BPT + j],
                        entry[side * K7_BPT + j]);
        }
        const int T = k7_list(tile.list, want, entry, lane);
        if (T) run(T);
      } else {
        k7_neighbours(d, mt, true, lane, nd, nm);
      }
      bool moved = false;
#pragma unroll
      for (int j = 0; j < K7_BPT; ++j) {
        if (!K7Tile::needs((real >> j) & 1u, cc[j], d[j], mt[j], nd[j],
                           nm[j]))
          continue;
        const int cn = __popc(tile.mask(lane + 32 * j, (asg0 >> j) & 1u,
                                        d0[j], (str0 >> j) & 1u, own[j],
                                        nd[j], nm[j]));
        if (cn >= a.ext_min && cn > cc[j] + a.ext_margin) {
          d[j] = nd[j];
          mt[j] = (nm[j] & (K7_SRC | K7_STRAND)) | K7_ASG;
          cc[j] = cn;
          moved = true;
        }
      }
      quiet = __any_sync(FULL, moved) ? 0 : quiet + 1;
    }

    // 4. The previous block's state (none before block 0); where a block
    //    is switchable, its mask there, listed and evaluated if new.
    k7_neighbours(d, mt, false, lane, nd, nm);
    {
      bool want[K7_BPT];
      uint16_t entry[K7_BPT];
#pragma unroll
      for (int j = 0; j < K7_BPT; ++j) {
        const int i = lane + 32 * j;
        const bool sw = (mt[j] & K7_ASG) && (nm[j] & K7_ASG) &&
                        (d[j] != nd[j] || ((mt[j] ^ nm[j]) & K7_STRAND));
        const int c = tile.slot(i, (int)(nm[j] & K7_SRC));
        want[j] = sw && !tile.own_state((asg0 >> j) & 1u, d0[j],
                                        (str0 >> j) & 1u, nd[j], nm[j]) &&
                  !((done[j] >> c) & 1ull);
        entry[j] = (uint16_t)(i << 7 | (nm[j] & K7_SRC));
      }
      const int T = k7_list(tile.list, want, entry, lane);
      if (T) run(T);
    }

    // 5. The tile's own blocks, o_t .. f_end - 1: the states, coalesced;
    //    the flag masks, then the flags, 16 positions a lane (2 lanes a
    //    block, 512 bytes a store).
    const int i_lo = o_t - f_lo, i_hi = f_end - f_lo;
#pragma unroll
    for (int j = 0; j < K7_BPT; ++j) {
      const int i = lane + 32 * j, dp = nd[j];
      const uint32_t mp = nm[j];
      const bool s = (mt[j] & K7_STRAND) != 0, sp = (mp & K7_STRAND) != 0;
      const bool asg = (mt[j] & K7_ASG) != 0, ap = (mp & K7_ASG) != 0;
      const bool sw = asg && ap && (d[j] != dp || s != sp);
      const bool oa = (asg0 >> j) & 1u, os = (str0 >> j) & 1u;
      const uint32_t m1 =
          asg ? tile.mask(i, oa, d0[j], os, own[j], d[j], mt[j]) : 0u;
      const uint32_t m0 =
          sw ? tile.mask(i, oa, d0[j], os, own[j], dp, mp) : 0u;
      if (i >= i_lo && i < i_hi) {
        const size_t o = row + f_lo + i;
        a.D[o] = d[j];
        a.S[o] = (uint8_t)s;
        a.A[o] = (uint8_t)asg;
        a.Dp[o] = dp;
        a.Sp[o] = (uint8_t)sp;
        a.Ap[o] = (uint8_t)ap;
        a.sw[o] = (uint8_t)sw;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int src = 16 * u + (lane >> 1), h = lane & 1;
        const uint32_t w1 = __shfl_sync(FULL, m1, src);
        const uint32_t w0 = __shfl_sync(FULL, m0, src);
        const int ib = 32 * j + src;
        if (ib < i_lo || ib >= i_hi) continue;
        const size_t o = (row + f_lo + ib) * FINE + 16 * h;
        *reinterpret_cast<uint4*>(a.m1 + o) = k7_flags(w1, h);
        *reinterpret_cast<uint4*>(a.m0 + o) = k7_flags(w0, h);
      }
    }
  }
}

}  // namespace

extern "C" {

// K6 (K8 fused in). qsv, qoff: (Gq, NQ) int32, the sampled query seeds
// (value, or -1) and their offsets in their fine block, NQ = NBF * C; sv_f,
// sv_r: (Gr, NR) int32, each row ascending (BIG where invalid, last),
// 16-byte aligned, NR % 4 == 0; pk1_f, pk1_r: (Gr, NR) int64, 16-byte
// aligned, the packs
// aligned to sv as `_index_block` builds them (pack_bits 32: value << 16 |
// position + 1, or 0; 64: value << 40 | position + 1 << 20 | previous + 1;
// positions ascending inside a run of one value; pk2 is not read, see
// front_item); r_rows: (R,), q_rows: (R, K) int32 arena rows. Writes A, S:
// (R * K, NBF) bool, D, vb: (R * K, NBF) int32 and, unless null, votes:
// (R, K, NQ, 4) int32 (16-byte aligned). NBF % 4 == 0, 1 <= C <= 32,
// K * NQ < 2^31, min_f, min_c >= 1. Returns cudaGetLastError().
int k6_front(const int32_t* qsv, const int32_t* qoff, const int32_t* sv_f,
             const int64_t* pk1_f, const int32_t* sv_r, const int64_t* pk1_r,
             const int32_t* r_rows, const int32_t* q_rows, int R, int K,
             int NBF, int NR, int C, int Lq, int Lr, int pack_bits,
             int min_f, int min_c, uint8_t* A, uint8_t* S, int32_t* D,
             int32_t* vb, int32_t* votes, void* stream) {
  if (R < 1 || K < 1 || NBF < 4 || NBF % 4 || NR < 4 || NR % 4 || C < 1 ||
      C > K6_MAX_C || (long long)K * NBF * C > 0x7fffffffLL ||
      (pack_bits != 32 && pack_bits != 64) || min_f < 1 || min_c < 1)
    return (int)cudaErrorInvalidValue;
  // s >= 4: one 16-byte load reads a segment of 4 entries as cheaply as
  // one of 1 or 2, which would cost the descent levels.
  int s = 4;
  while ((NR + s - 1) / s > DIR_SAMPLES) s <<= 1;
  const int ns = (NR + s - 1) / s;
  int H = 1;
  while ((1 << H) < ns) ++H;
  const int dspan = Lq + Lr + 64;
  const int wide = 2LL * dspan + 64 < (1LL << 22) ? 0 : 1;
  const int spl = (C + 7) / 8;          // seeds a lane
  using Kernel = void (*)(FrontArgs);
  static const Kernel kernels[4][2] = {
      {front_kernel<1, false>, front_kernel<1, true>},
      {front_kernel<2, false>, front_kernel<2, true>},
      {front_kernel<3, false>, front_kernel<3, true>},
      {front_kernel<4, false>, front_kernel<4, true>}};
  const Kernel kern = kernels[spl - 1][wide];
  static bool smem_set[4][2][MAX_DEVICES] = {};
  int rc = allow_smem(kern, 2 * DIR_SAMPLES * 2, smem_set[spl - 1][wide],
                      100);
  if (rc) return rc;
  const int smem = 2 * (1 << H) * 2;
  int per_sm = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, K6_WARPS * 32, smem);
  if (rc) return rc;
  // CTAs in row order, each row's items cut into runs of at least
  // K6_MIN_ITEMS: as many as keep the rows that the resident CTAs read
  // (sv and pk1 of both strands, 24 bytes an entry) within K6_L2_BYTES, so
  // that the searches' random reads hit L2.
  const int per_row = K * (NBF / 4);
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) *
                             sm_count();
  const long long live = std::max(1LL, K6_L2_BYTES / (24LL * NR));
  long long chunks = std::min((resident + live - 1) / live,
                              (long long)(per_row + K6_MIN_ITEMS - 1) /
                                  K6_MIN_ITEMS);
  chunks = std::max(chunks, 1LL);
  const int per_cta = (int)((per_row + chunks - 1) / chunks);
  chunks = (per_row + per_cta - 1) / per_cta;
  if ((long long)R * chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const FrontArgs a{qsv, qoff, {sv_f, sv_r}, {pk1_f, pk1_r}, r_rows,
                    q_rows, K, NBF / 4, NBF * C, NR, C, Lq, dspan,
                    pack_bits == 64, s, ns, H, min_f, min_c, (int)chunks,
                    per_cta, A, S, D, vb, votes};
  kern<<<(int)(R * chunks), K6_WARPS * 32, smem,
         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// K7. q: (Gq, NBF * 32) int8 query codes 0-4, 16-byte aligned; q_rows,
// qlens: (N,) int32; r2dov: (Gr, 2 * NRT, 64) int8 codes 0-4, 16-byte
// aligned (the window rows of both strands, each led by an all-pad row;
// NRT = Lr / 32 + 1); r_rows, rlens: (R,) int32, pair n on row n / K; A0,
// S0: (N, NBF) bool, D0: (N, NBF) int32, the election. Writes m1, m0: (N,
// NBF * 32) bool (16-byte aligned) and sw, A, S, Ap, Sp: (N, NBF) bool, D,
// Dp: (N, NBF) int32. 0 <= iters <= 16, ext_margin >= 0. Returns
// cudaGetLastError().
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
  const int smem = K7_WARPS * k7_warp_bytes(iters);
  int per_sm = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, propagate_v2_kernel, K7_WARPS * 32, smem);
  if (rc) return rc;
  // As many CTAs as are resident at once, each warp taking tiles in turn
  // (no last wave part full), or fewer where there are fewer tiles.
  const long long need = ((long long)N * tiles + K7_WARPS - 1) / K7_WARPS;
  const long long ctas =
      std::min(need, (long long)std::max(per_sm, 1) * sm_count());
  const V2PropArgs a{q, q_rows, qlens, r2dov, r_rows, rlens, A0, S0, D0,
                     N, K, NBF, Lr, NRT, iters, ext_min, ext_margin, out,
                     tiles, m1, m0, sw, A, S, D, Ap, Sp, Dp};
  propagate_v2_kernel<<<(int)ctas, K7_WARPS * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
