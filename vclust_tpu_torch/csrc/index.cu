// K9 and K10: the two index builds of the device align engine (the v3
// arena and the v2 arena of one bucket, for a chunk of genomes).
//
// Replace the XLA device programs of the JAX package's index builds:
// `_index_block_v3` (its ops/align_tpu.py:1039-1068, with `kmer_vals`,
// :164-176, and `_canon_hash`, :1024-1037) and `_index_block` (:747-826).
// Both are bit-exact with the plain torch versions beside their wrappers in
// ops/align_gpu.py (`index_block_v3_plain`, `index_block_plain`). No torch
// op computes any part of either arena on the card: the wrapper allocates
// with torch.empty and calls the entry points below, nothing else.
//
// K9 (k9_index_v3). Per genome of the chunk and coarse query block of WQ
// bases: the hash bucket of the canonical k-mer at every position (H - 1
// where the k-mer holds a code >= 4 or runs past the bucket: the JAX
// scatter wraps the -1 NumPy-style, ROADMAP R8), the {0,1} occupancy rows
// of its FPB = WQ / 32 reference blocks of 32 (rocc) and of its two query
// half-blocks of WQ / 2 (qocc), and its FPB wide window rows of both
// strands (roww_f, roww_r: row r is P[32 r : 32 r + ROWW] of P = [4] *
// (WQ + 32) ++ codes ++ [4] * ROWW).
// What bounds it, and what the design does about it:
//   * Bytes written: at the defaults (H 2,048, WQ 128, ROWW 384) a genome
//     of bucket 65,536 has 2 MiB of qocc, 4 MiB of rocc and 1.5 MiB of
//     rows, against 128 KiB of codes read. The plain version zero-fills the
//     occupancies, then scatters G * Lp single bytes into them after ~16
//     elementwise passes of int32 and int64 over (G, Lp).
//   * A warp takes a coarse block. Lane l computes the hashes of positions
//     32 f + l (f < FPB) from one coalesced byte load a block of 32 and
//     the next, the k-mer's later codes by shuffles. The warp owns an
//     H-byte row of shared memory, zero between rows: each lane sets the
//     bytes of its hashes, the warp copies the row out (lane l the 16-byte
//     chunks l, l + 32, ...), and each lane clears its bytes again. So
//     every output byte is written once, 16 bytes a store, and the row
//     costs H / 512 shared loads and stores a lane, not an H-byte fill.
//     The FPB hashes a lane holds give the FPB rocc rows and the two qocc
//     rows (FPB + 2 rows from 32 FPB hashes; at WQ 128, 6 from 128).
//   * The wide rows are 16-byte copies of the codes (or of pads: a chunk
//     of a row lies wholly inside the codes or wholly outside, since WQ +
//     32 and the bucket are multiples of 16), ROWW / 32 reads of each code
//     from L2.
//
// K10 (k10_index_v2). The chunk's 2 G (genome, strand) rows go a group at a
// time (as many as 128 MiB of items hold: 1,024 rows at 65,536 and C = 16,
// 128 at 262,144), each group three launches at k <= 4 and four at k = 8.
//   * Selection with counts (index_v2_select). A CTA takes a chunk of 64
//     fine blocks of one row, a warp 8 of them, lane l offset l: its k-mer
//     value v (-1 where invalid; by doubling, `kmer_doubling`) and hash h
//     = (uint32(v) * 2654435761) >> 16 (2^16, above every valid hash,
//     where invalid). A
//     bitonic network over the warp sorts the keys h << 5 | l; lane r < C
//     takes the r-th: the block's C smallest (hash, offset), as the plain
//     version's stable sort keeps them. From the forward strand qsv (v, or
//     -1) and qoff (the offset, kept for invalid slots too); for the sort,
//     an item per valid slot and NONE per invalid one, in slot order; the
//     window rows (r2dov) as 16-byte copies. The CTA counts both passes'
//     digits of its valid slots in shared memory and adds them to the
//     row's totals once a digit: a digit's total does not depend on the
//     items' order, so both passes' digit bases are known before the first.
//   * The sort. The plain version's stable sort of a strand's slots by
//     value keeps slot order among equal values, and slot order is (block,
//     hash rank): equal values in one block share their hash and are
//     ranked by offset, so it is position order. So the valid entries end
//     ordered by (value, position), and a stable LSD radix sort of the
//     slots by value gives the same: ceil(2k / 8) passes of 8-bit digits
//     (two at k = 8), one launch each (index_v2_pass). A CTA takes a (row,
//     tile of 4,096 items) by an atomic ticket, ranks its items by digit
//     (a round of 32 by ballots, per-warp counts), publishes each
//     digit's count in the tile, finds the tiles before by a decoupled
//     look-back and publishes its inclusive prefix. It stages its items in
//     shared memory in digit order (stably) and stores them in runs:
//     consecutive threads, consecutive places of one digit. Only valid
//     items take part; invalid entries are BIG / 0 whatever their order,
//     since no output holds their positions. The passes ping-pong between
//     pk1's row and the scratch, in the order that leaves the sorted items
//     in the scratch. Items are 4 bytes up to bucket 65,536, 8 above.
//   * The packs (index_v2_pack): sv, pk1 and pk2 from the sorted items,
//     the previous position where the entry before holds the same value.
//   * The state is the wrapper's, one a (device, stream), zeroed once
//     (ROADMAP P6), and nothing clears it between launches: the tickets
//     wrap; every word past the header is tagged with an epoch (which
//     each pass launch's last CTA moves on), so a word left by an earlier
//     group or call reads as stale (the totals and counts as 0, a
//     look-back word as not yet published); a look-back that waits
//     seconds traps.
//   * Bound: bytes (codes read once, the arena written once). What the
//     design avoids: an 8-byte store a place of its own an item, a global
//     atomic an item a pass for the next pass's tile counts, a scan launch
//     a pass (a CTA a row: few CTAs) and a memset a group.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// Devices a process may launch on (launch state is kept per device).
constexpr int MAX_DEVICES = 64;
constexpr int BIG = 1 << 30;
constexpr unsigned HASH_MUL = 2654435761u;
constexpr unsigned PAD4 = 0x04040404u;

typedef unsigned long long u64;

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// The code at position p of a row of Lp codes; 4 (pad) past its end.
__device__ __forceinline__ int code_at(const int8_t* c, long long p, int Lp) {
  return p < Lp ? (int)c[p] : 4;
}

// The k-mer value at the lane's position from the codes of its block of 32
// (cur) and of the next (nxt): the later codes by shuffles; -1 where any
// code is >= 4 (as kmer_vals: a pad past the end is 4). All lanes call it.
__device__ __forceinline__ int kmer_value(int cur, int nxt, int lane,
                                          int k) {
  int v = 0;
  bool bad = false;
  for (int j = 0; j < k; ++j) {
    const int src = lane + j;
    const int a = __shfl_sync(FULL, cur, src & 31);
    const int b = __shfl_sync(FULL, nxt, src & 31);
    const int c = src < 32 ? a : b;
    bad |= c >= 4;
    v = (v << 2) | (c & 3);
  }
  return bad ? -1 : v;
}

__device__ __forceinline__ uint4 pad16() {
  return make_uint4(PAD4, PAD4, PAD4, PAD4);
}

// ---- K9 --------------------------------------------------------------------
constexpr int K9_WARPS = 8;
constexpr int K9_MAX_FPB = 13;        // V3_WQ 416
constexpr int K9_MAX_H = 16384;       // VCLUST_ALIGN_V3_H's range

struct V3Args {
  const int8_t* fwd;
  const int8_t* rc;
  int G, Lp, k, ck, H, shift, WQ, FPB, NQB, NRB, ROWW;
  int8_t* qocc;
  int8_t* rocc;
  int8_t* roww_f;
  int8_t* roww_r;
};

// `_canon_hash`: min(v, revcomp over ck digits), the uint32 multiply-shift
// hash; H - 1 for an invalid position (v < 0).
__device__ __forceinline__ int canon_bucket(int v, int ck, int H,
                                            int shift) {
  if (v < 0) return H - 1;
  int rc = 0, t = v;
  for (int j = 0; j < ck; ++j) {
    rc = (rc << 2) | ((t & 3) ^ 3);
    t >>= 2;
  }
  return (int)(((unsigned)min(v, rc) * HASH_MUL) >> shift);
}

// The warp's row (H bytes, zero) copied out to dst, 16 bytes a lane-owned
// chunk.
__device__ __forceinline__ void copy_row(uint4* dst, const uint4* row,
                                         int H16, int lane) {
  __syncwarp();
  for (int c = lane; c < H16; c += 32) dst[c] = row[c];
  __syncwarp();
}

__global__ void __launch_bounds__(K9_WARPS * 32)
index_v3_kernel(V3Args a) {
  extern __shared__ __align__(16) uint8_t k9_rows[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint8_t* row = k9_rows + (size_t)warp * a.H;
  uint4* row4 = reinterpret_cast<uint4*>(row);
  const int H16 = a.H >> 4;
  for (int c = lane; c < H16; c += 32) row4[c] = make_uint4(0, 0, 0, 0);
  __syncwarp();
  const int half_w = a.WQ >> 1;
  const int RC = a.ROWW >> 4;           // 16-byte chunks a wide row
  const long long tasks = (long long)a.G * a.NQB;
  for (long long t = (long long)blockIdx.x * K9_WARPS + warp; t < tasks;
       t += (long long)gridDim.x * K9_WARPS) {
    const int g = (int)(t / a.NQB), q = (int)(t % a.NQB);
    const int8_t* codes = a.fwd + (size_t)g * a.Lp;
    const long long p0 = (long long)q * a.WQ;
    int hs[K9_MAX_FPB];
    int cur = code_at(codes, p0 + lane, a.Lp);
#pragma unroll
    for (int f = 0; f < K9_MAX_FPB; ++f) {
      if (f < a.FPB) {
        const int nxt = code_at(codes, p0 + 32 * (f + 1) + lane, a.Lp);
        hs[f] = canon_bucket(kmer_value(cur, nxt, lane, a.k), a.ck, a.H,
                             a.shift);
        cur = nxt;
      }
    }
    // The FPB reference-block rows, then the two query half-block rows.
    uint4* rocc = reinterpret_cast<uint4*>(
        a.rocc + ((size_t)g * a.NRB + (size_t)q * a.FPB) * a.H);
#pragma unroll
    for (int f = 0; f < K9_MAX_FPB; ++f) {
      if (f < a.FPB) {
        row[hs[f]] = 1;
        copy_row(rocc + (size_t)f * H16, row4, H16, lane);
        row[hs[f]] = 0;
        __syncwarp();
      }
    }
    uint4* qocc = reinterpret_cast<uint4*>(
        a.qocc + ((size_t)g * 2 * a.NQB + 2 * (size_t)q) * a.H);
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int f = 0; f < K9_MAX_FPB; ++f)
        if (f < a.FPB && (32 * f + lane >= half_w) == (half == 1))
          row[hs[f]] = 1;
      copy_row(qocc + (size_t)half * H16, row4, H16, lane);
#pragma unroll
      for (int f = 0; f < K9_MAX_FPB; ++f)
        if (f < a.FPB && (32 * f + lane >= half_w) == (half == 1))
          row[hs[f]] = 0;
      __syncwarp();
    }
    // The FPB wide rows of both strands: row r, chunk m is codes[32 r + 16
    // m - WQ - 32 ...] or pads.
    for (int s = 0; s < 2; ++s) {
      const int8_t* src = (s ? a.rc : a.fwd) + (size_t)g * a.Lp;
      int8_t* dst = (s ? a.roww_r : a.roww_f) +
                    ((size_t)g * a.NRB + (size_t)q * a.FPB) * a.ROWW;
      for (int c = lane; c < a.FPB * RC; c += 32) {
        const int f = c / RC, m = c - f * RC;
        const long long idx =
            32LL * (q * a.FPB + f) + 16 * m - (a.WQ + 32);
        uint4 v = pad16();
        if (idx >= 0 && idx < a.Lp)
          v = *reinterpret_cast<const uint4*>(src + idx);
        *reinterpret_cast<uint4*>(dst + (size_t)f * a.ROWW + 16 * m) = v;
      }
    }
  }
}

// ---- K10 -------------------------------------------------------------------
constexpr int K10_THREADS = 256;
constexpr int K10_WARPS = K10_THREADS / 32;
constexpr int K10_IPT = 16;           // items a lane a tile
constexpr int K10_TILE = K10_THREADS * K10_IPT;
constexpr int DIGITS = 256;
constexpr int K10_MAX_PASSES = 2;     // values of k <= 8: 16 bits
constexpr int SEL_BPW = 8;           // fine blocks a warp of a selection CTA
constexpr int SEL_BLOCKS = K10_WARPS * SEL_BPW;
constexpr int LOOK = 8;               // look-back words read at once
constexpr unsigned SPIN_NS = 64;      // the look-back's wait between reads
// Items a group of rows may hold (NQ of them a row).
constexpr long long K10_ITEM_BYTES = 128LL << 20;
// A look-back word: the launch's epoch << 32 | FLAG_* | count.
constexpr unsigned FLAG_AGG = 1u << 30, FLAG_INCL = 1u << 31;
constexpr unsigned FLAGS = FLAG_AGG | FLAG_INCL, COUNT = FLAG_AGG - 1;

// The items: 4 bytes (value << 16 | position) where positions fit 16
// bits (buckets up to 65,536; a valid item is never ~0: value 65,535
// needs k = 8, and then its position is at most Lp - 8), else 8 bytes
// (value << 40 | position + 1 << 20).
template <typename Item> struct Items;
template <> struct Items<unsigned> {
  static constexpr int VS = 16;
  static constexpr unsigned NONE = ~0u;
  __device__ static unsigned make(int v, int pos) {
    return (unsigned)v << 16 | (unsigned)pos;
  }
  __device__ static long long pos1(unsigned it) { return (it & 0xFFFF) + 1; }
};
template <> struct Items<u64> {
  static constexpr int VS = 40;
  static constexpr u64 NONE = ~0ULL;
  __device__ static u64 make(int v, int pos) {
    return (u64)v << 40 | (u64)(pos + 1) << 20;
  }
  __device__ static long long pos1(u64 it) {
    return (long long)((it >> 20) & 0xFFFFF);
  }
};

// One group of (genome, strand) rows [r0, r0 + nr), row r = 2 g + s.
struct V2Args {
  const int8_t* fwd;
  const int8_t* rc;
  int Lp, NBF, C, k, passes, tiles, sel_chunks, r0, nr;
  long long NQ;
  int32_t* qsv;
  int32_t* qoff;
  int32_t* sv[2];
  int64_t* pk1[2];
  int64_t* pk2[2];
  int pack64;
  int8_t* r2dov;
  // The state (k10_layout): the header (the pass launches' ticket, CTAs
  // done, epoch); totals[p][row][digit], each row's count of digit d of
  // pass p (order-free: known before either pass), tagged with the epoch
  // of the group's first pass; count[row], its valid slots, tagged with
  // the epoch of the last pass; the look-back words
  // status[row][tile][digit]. And the items: nr rows of NQ (the sorted
  // ones).
  unsigned* header;
  u64* totals;
  u64* count;
  u64* status;
  void* items;
};

// pk1's row of row r0 + rl (one of the two item buffers) and the group's
// scratch row; the passes alternate from S0 so that the last writes the
// scratch.
template <typename Item>
__device__ __forceinline__ Item* items_of(const V2Args& a, int rl, int pass) {
  const bool s0_is_pk1 = a.passes & 1;
  if ((pass & 1) ? !s0_is_pk1 : s0_is_pk1) {
    const int r = a.r0 + rl;
    return reinterpret_cast<Item*>(a.pk1[r & 1] + (size_t)(r >> 1) * a.NQ);
  }
  return static_cast<Item*>(a.items) + (size_t)rl * a.NQ;
}

template <typename Item>
__device__ __forceinline__ int digit_of(Item it, int pass) {
  return (int)(it >> (Items<Item>::VS + 8 * pass)) & 255;
}

// The exclusive prefix of x over the CTA's K10_THREADS threads in order;
// `total` their sum. Every thread calls it.
__device__ __forceinline__ int block_excl_scan(int x, int* wsum,
                                               int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < K10_WARPS; ++w) {
    const int s = wsum[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();
  total = all;
  return before + inc - x;
}

// K10's k-mer value at the lane's position (as kmer_value, by doubling):
// the values of windows of 1, 2 and 4 codes at the lane's position (lo)
// and 32 on (hi), a window twice as long joined from one and the window w
// positions on; then k's binary digits joined from the longest. A code
// >= 4 sets KBAD. 5 shuffles at k = 8 (kmer_value: 16). Only the hi
// values the later reads take (lanes below 32 - 2 w) are exact.
constexpr unsigned KBAD = 1u << 31;

__device__ __forceinline__ unsigned join_codes(unsigned a, unsigned b,
                                               int w) {
  return ((a | b) & KBAD) | (a & ~KBAD) << (2 * w) | (b & ~KBAD);
}

// Lane l's window at position l + off: lane (l + off) & 31's lo, or, past
// the block, its hi.
__device__ __forceinline__ unsigned window_at(unsigned lo, unsigned hi,
                                              int off, int lane) {
  return __shfl_sync(FULL, lane < off ? hi : lo, (lane + off) & 31);
}

template <int K>
__device__ __forceinline__ int kmer_doubling(int cur, int nxt, int lane) {
  constexpr int TOP = K >= 8 ? 3 : K >= 4 ? 2 : K >= 2 ? 1 : 0;
  unsigned lo[4], hi[4];
  lo[0] = cur >= 4 ? KBAD : (unsigned)cur;
  hi[0] = nxt >= 4 ? KBAD : (unsigned)nxt;
#pragma unroll
  for (int i = 1; i <= TOP; ++i) {
    const int w = 1 << (i - 1);
    lo[i] = join_codes(lo[i - 1], window_at(lo[i - 1], hi[i - 1], w, lane),
                       w);
    if (i < TOP)
      hi[i] = join_codes(hi[i - 1],
                         __shfl_sync(FULL, hi[i - 1], (lane + w) & 31), w);
  }
  unsigned v = lo[TOP];
  int off = 1 << TOP;
#pragma unroll
  for (int i = TOP - 1; i >= 0; --i)
    if (K >> i & 1) {
      v = join_codes(v, window_at(lo[i], hi[i], off, lane), 1 << i);
      off += 1 << i;
    }
  return v & KBAD ? -1 : (int)v;
}

// Adds c to a tagged total (tag << 32 | count): a word of another tag is
// a stale one (an earlier group's, or no total at all), and is replaced.
__device__ __forceinline__ void add_tagged(u64* t, unsigned tag,
                                           unsigned c) {
  u64 old = *reinterpret_cast<volatile u64*>(t);
  while ((unsigned)(old >> 32) != tag) {
    const u64 prev = atomicCAS(t, old, (u64)tag << 32 | c);
    if (prev == old) return;
    old = prev;
  }
  atomicAdd(t, (u64)c);
}

// Selection with counts: a CTA a chunk of SEL_BLOCKS fine blocks of one
// row, a warp SEL_BPW consecutive blocks; each block's 32 (hash, offset)
// keys sorted over the warp by a bitonic network, lane r < C takes the
// r-th. Writes qsv and qoff (forward rows) and the items in slot order
// (S0); counts both passes' digits of its valid slots in shared memory
// and adds them to the row's totals once a CTA and digit (tagged with the
// epoch the group's first pass will take); writes its blocks' window
// rows. Templated on k: every block's chain of shuffles is straight-line
// code, which the compiler interleaves over the warp's blocks (the
// kernel is bound by its instructions and their latency).
template <typename Item, int K>
__global__ void __launch_bounds__(K10_THREADS)
index_v2_select(V2Args a) {
  constexpr int PASSES = (2 * K + 7) / 8;
  __shared__ int hist[PASSES * DIGITS];
  for (int x = threadIdx.x; x < PASSES * DIGITS; x += K10_THREADS)
    hist[x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Bit s: whether the lane keeps the min at the bitonic network's step s.
  unsigned keep_min = 0;
  for (int size = 2, st = 0; size <= 32; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1, ++st)
      keep_min |= (unsigned)(((lane & size) == 0) == ((lane & stride) == 0))
                  << st;
  const int rl = blockIdx.x / a.sel_chunks;
  const int b0 = (blockIdx.x % a.sel_chunks) * SEL_BLOCKS;
  const int r = a.r0 + rl, g = r >> 1, s = r & 1;
  const int8_t* codes = (s ? a.rc : a.fwd) + (size_t)g * a.Lp;
  // The warp takes blocks bw + j, j < SEL_BPW: the lane's codes of them
  // and of the block after, loaded at once; then each block's value and
  // offset, then the stores.
  const int bw = b0 + warp * SEL_BPW;
  int cd[SEL_BPW + 1];
#pragma unroll
  for (int j = 0; j <= SEL_BPW; ++j)
    cd[j] = bw + j < a.NBF ? codes[32 * (bw + j) + lane] : 4;
  int vv[SEL_BPW], off[SEL_BPW];
#pragma unroll
  for (int j = 0; j < SEL_BPW; ++j) {
    const int v = kmer_doubling<K>(cd[j], cd[j + 1], lane);
    // Valid hashes are < 2^16; 2^16 stands for BIG.
    const int h = v >= 0 ? (int)(((unsigned)v * HASH_MUL) >> 16) : 65536;
    int key = h << 5 | lane;
#pragma unroll
    for (int size = 2, st = 0; size <= 32; size <<= 1)
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1, ++st) {
        const int other = __shfl_xor_sync(FULL, key, stride);
        key = keep_min >> st & 1 ? min(key, other) : max(key, other);
      }
    off[j] = key & 31;
    vv[j] = __shfl_sync(FULL, v, off[j]);
  }
  const size_t slot0 = (size_t)g * a.NQ + (size_t)bw * a.C + lane;
  Item* items = items_of<Item>(a, rl, 0) + (size_t)bw * a.C + lane;
#pragma unroll
  for (int j = 0; j < SEL_BPW; ++j)
    if (bw + j < a.NBF && lane < a.C) {
      if (s == 0) {
        a.qsv[slot0 + j * a.C] = vv[j];
        a.qoff[slot0 + j * a.C] = off[j];
      }
      items[j * a.C] = vv[j] >= 0
                           ? Items<Item>::make(vv[j], 32 * (bw + j) + off[j])
                           : Items<Item>::NONE;
      if (vv[j] >= 0) {
#pragma unroll
        for (int q = 0; q < PASSES; ++q)
          atomicAdd(&hist[q * DIGITS + ((vv[j] >> 8 * q) & 255)], 1);
      }
    }
  // The window rows of the chunk's blocks: row j + 1 of the strand is
  // codes[32 j, 32 j + 64) (pads past the end); the first chunk also
  // writes row 0, all pads.
  const int nb = min(SEL_BLOCKS, a.NBF - b0);
  int8_t* rows = a.r2dov + ((size_t)g * 2 + s) * (size_t)(a.NBF + 1) * 64;
  for (int c = threadIdx.x; c < 4 * (nb + 1); c += K10_THREADS) {
    const int w = b0 + c / 4, m = c & 3;     // window row w
    if (w == b0 && b0 > 0) continue;          // the chunk before's
    const long long idx = 32LL * (w - 1) + 16 * m;
    uint4 x = pad16();
    if (w > 0 && idx < a.Lp) x = *reinterpret_cast<const uint4*>(codes + idx);
    *reinterpret_cast<uint4*>(rows + 64 * (size_t)w + 16 * m) = x;
  }
  __syncthreads();
  const unsigned tag = *reinterpret_cast<volatile unsigned*>(&a.header[2]);
  for (int x = threadIdx.x; x < PASSES * DIGITS; x += K10_THREADS)
    if (hist[x])
      add_tagged(&a.totals[((size_t)(x / DIGITS) * a.nr + rl) * DIGITS +
                           x % DIGITS], tag, hist[x]);
}

// The lanes whose d (0-256) equals the lane's: nine ballots (on this card
// faster than __match_any_sync).
__device__ __forceinline__ unsigned digit_peers(int d) {
  unsigned peers = FULL;
#pragma unroll
  for (int bit = 0; bit < 9; ++bit) {
    const unsigned m = __ballot_sync(FULL, d >> bit & 1);
    peers &= d >> bit & 1 ? m : ~m;
  }
  return peers;
}

// Thread d: the exclusive prefix of digit d over the row's tiles before
// `tile` (st: the digit's word of the row's tile 0, a tile DIGITS words
// on). Reads LOOK words back at once and folds them from the nearest,
// waiting on each until it holds this launch's epoch, up to one that
// holds an inclusive prefix (tile 0's always does).
__device__ int look_back(const u64* st, int tile, unsigned epoch) {
  int excl = 0;
  for (int t = tile - 1; t >= 0; t -= LOOK) {
    u64 w[LOOK];
#pragma unroll
    for (int i = 0; i < LOOK; ++i)
      if (t - i >= 0)
        w[i] = *reinterpret_cast<const volatile u64*>(
            st + (size_t)(t - i) * DIGITS);
#pragma unroll
    for (int i = 0; i < LOOK; ++i) {
      if (t - i < 0) break;
      long long spins = 0;
      while ((unsigned)(w[i] >> 32) != epoch || !((unsigned)w[i] & FLAGS)) {
        // A tile publishes its aggregate without waiting on any other, so
        // within microseconds; seconds of waiting mean a broken protocol:
        // stop with an error rather than hang the card.
        if (++spins > (1ll << 24)) __trap();
        __nanosleep(SPIN_NS);
        w[i] = *reinterpret_cast<const volatile u64*>(
            st + (size_t)(t - i) * DIGITS);
      }
      excl += (int)((unsigned)w[i] & COUNT);
      if ((unsigned)w[i] & FLAG_INCL) return excl;
    }
  }
  return excl;
}

// Pass p, a CTA a (row, tile) of K10_TILE items, the tile taken by ticket
// (tiles of a row in order, so a tile's look-back waits only on CTAs
// already running). A warp takes K10_IPT rounds of 32 consecutive items;
// an item's rank among its round's lanes of its digit (digit_peers) and
// after the warp's earlier rounds (a per-warp digit count in shared
// memory). Thread d publishes digit d's count in the tile, looks back for
// the tiles before and publishes its inclusive prefix; the items are
// staged in shared memory in digit order (stably), then stored in runs:
// thread i stores staged item i at its digit's place in the row.
template <typename Item>
__global__ void __launch_bounds__(K10_THREADS)
index_v2_pass(V2Args a, int pass) {
  __shared__ int whist[K10_WARPS][DIGITS];
  __shared__ int lst[DIGITS], gofs[DIGITS], wsum[K10_WARPS];
  __shared__ Item stage[K10_TILE];
  __shared__ unsigned info[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned units = (unsigned)a.nr * (unsigned)a.tiles;
  if (tid == 0) {
    info[0] = atomicInc(&a.header[0], units - 1u);
    info[1] = *reinterpret_cast<volatile unsigned*>(&a.header[2]);
  }
  for (int d = lane; d < DIGITS; d += 32) whist[warp][d] = 0;
  __syncthreads();
  const int rl = (int)(info[0] / a.tiles), tile = (int)(info[0] % a.tiles);
  const unsigned epoch = info[1];
  // The tile's items, loaded while the totals are read (the second pass
  // takes only the row's first n = its valid count).
  const Item* src = items_of<Item>(a, rl, pass);
  const long long t0 = (long long)tile * K10_TILE;
  Item it[K10_IPT];
#pragma unroll
  for (int j = 0; j < K10_IPT; ++j) {
    const long long i = t0 + (long long)(warp * K10_IPT + j) * 32 + lane;
    it[j] = i < a.NQ ? src[i] : Items<Item>::NONE;
  }
  // The digits' first places in the row: the exclusive scan of the row's
  // totals (0 where no slot of the group counted the digit: a stale tag),
  // whose sum is its valid count.
  const u64 tw = a.totals[((size_t)pass * a.nr + rl) * DIGITS + tid];
  int total;
  const int dbase = block_excl_scan(
      (unsigned)(tw >> 32) == epoch - pass ? (int)(unsigned)tw : 0, wsum,
      total);
  const long long n = pass ? total : a.NQ;
  if (t0 < n) {
    Item* dst = items_of<Item>(a, rl, pass + 1);
    const unsigned lt = (1u << lane) - 1;
    int rk[K10_IPT];
#pragma unroll
    for (int j = 0; j < K10_IPT; ++j)
      if (t0 + (long long)(warp * K10_IPT + j) * 32 + lane >= n)
        it[j] = Items<Item>::NONE;
#pragma unroll
    for (int j = 0; j < K10_IPT; ++j) {
      const bool ok = it[j] != Items<Item>::NONE;
      const int d = ok ? digit_of(it[j], pass) : DIGITS;
      const unsigned peers = digit_peers(d);
      rk[j] = ok ? whist[warp][d] + __popc(peers & lt) : 0;
      __syncwarp();
      if (ok && lane == __ffs(peers) - 1) whist[warp][d] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // Thread d: the tile's count of digit d (its aggregate), published at
    // once (tile 0's is its inclusive prefix), and the warps' offsets in
    // the digit.
    const int d = tid;
    int agg = 0;
    for (int w = 0; w < K10_WARPS; ++w) {
      const int c = whist[w][d];
      whist[w][d] = agg;
      agg += c;
    }
    u64* st = a.status + (size_t)rl * a.tiles * DIGITS + d;
    const u64 ep = (u64)epoch << 32;
    *reinterpret_cast<volatile u64*>(st + (size_t)tile * DIGITS) =
        ep | (tile ? FLAG_AGG : FLAG_INCL) | (unsigned)agg;
    int valid;
    lst[d] = block_excl_scan(agg, wsum, valid);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < K10_IPT; ++j)
      if (it[j] != Items<Item>::NONE) {
        const int dj = digit_of(it[j], pass);
        stage[lst[dj] + whist[warp][dj] + rk[j]] = it[j];
      }
    int excl = 0;
    if (tile > 0) {
      excl = look_back(st, tile, epoch);
      *reinterpret_cast<volatile u64*>(st + (size_t)tile * DIGITS) =
          ep | FLAG_INCL | (unsigned)(excl + agg);
    }
    gofs[d] = dbase + excl - lst[d];
    __syncthreads();
    for (int i = tid; i < valid; i += K10_THREADS) {
      const Item x = stage[i];
      dst[gofs[digit_of(x, pass)] + i] = x;
    }
  }
  if (pass + 1 == a.passes && tile == 0 && tid == 0)
    a.count[rl] = (u64)epoch << 32 | (unsigned)total;
  // The launch's last CTA to finish moves the epoch on (every CTA has read
  // it by then) for the next launch on this scratch.
  if (tid == 0) {
    __threadfence();
    const unsigned done = atomicInc(&a.header[1], units - 1u);
    if (done == units - 1u)
      *reinterpret_cast<volatile unsigned*>(&a.header[2]) = epoch + 1u;
  }
}

// sv, pk1 and pk2 of the group's rows from the sorted items (the scratch):
// the previous position where the entry before holds the same value.
template <typename Item>
__global__ void __launch_bounds__(K10_THREADS) index_v2_pack(V2Args a) {
  const long long total = (long long)a.nr * a.NQ;
  const long long step = (long long)gridDim.x * K10_THREADS;
  for (long long x = (long long)blockIdx.x * K10_THREADS + threadIdx.x;
       x < total; x += step) {
    const int rl = (int)(x / a.NQ);
    const long long i = x % a.NQ;
    const int r = a.r0 + rl, g = r >> 1, s = r & 1;
    const size_t o = (size_t)g * a.NQ + i;
    const Item* X = static_cast<const Item*>(a.items) + (size_t)rl * a.NQ;
    int64_t* pk2 = a.pk2[s];
    const bool alias = pk2 == a.pk1[s];
    if (i < (long long)(unsigned)a.count[rl]) {
      const Item it = X[i];
      const long long v = (long long)(it >> Items<Item>::VS);
      const long long pos1 = Items<Item>::pos1(it);
      long long prev = 0;             // previous position + 1, or 0
      if (i > 0 && (X[i - 1] >> Items<Item>::VS) == (it >> Items<Item>::VS))
        prev = Items<Item>::pos1(X[i - 1]);
      a.sv[s][o] = (int32_t)v;
      if (a.pack64) {
        const long long p = v << 40 | pos1 << 20 | prev;
        a.pk1[s][o] = p;
        if (!alias) pk2[o] = p;
      } else {
        a.pk1[s][o] = v << 16 | pos1;
        pk2[o] = prev ? (v << 16 | prev) : 0;
      }
    } else {
      a.sv[s][o] = BIG;
      a.pk1[s][o] = 0;
      if (!alias) pk2[o] = 0;
    }
  }
}

// Where the parts of K10's state lie, in bytes from its start, for groups
// of `rows` rows of NQ slots; `bytes` its size. The header stays at the
// start whatever the shapes. Every 8 bytes past it are one word tagged
// with the epoch of the launch that wrote it (or of the pass it was
// counted for), older than any later launch's, and only look-back words
// have flag bits set (totals and counts stay below 2^30). So a call of
// other shapes on the same state, whose totals, counts or look-back words
// lie over an earlier call's words of another kind, never takes a stale
// word for a fresh one.
struct K10Layout {
  long long totals, count, status, bytes;
};

K10Layout k10_layout(long long rows, long long NQ) {
  const long long tiles = (NQ + K10_TILE - 1) / K10_TILE;
  K10Layout l;
  l.totals = 64;
  l.count = l.totals + 8LL * K10_MAX_PASSES * rows * DIGITS;
  l.status = l.count + 8 * rows;
  l.bytes = l.status + 8 * rows * tiles * DIGITS;
  return l;
}

long long k10_item_bytes(int Lp) { return Lp <= 65536 ? 4 : 8; }

template <typename Item, int K>
void launch_select(const V2Args& a, cudaStream_t st) {
  index_v2_select<Item, K><<<a.nr * a.sel_chunks, K10_THREADS, 0, st>>>(a);
}

template <typename Item>
int k10_run(V2Args a, int G, int rows, cudaStream_t st) {
  using Launch = void (*)(const V2Args&, cudaStream_t);
  static const Launch select[8] = {
      launch_select<Item, 1>, launch_select<Item, 2>, launch_select<Item, 3>,
      launch_select<Item, 4>, launch_select<Item, 5>, launch_select<Item, 6>,
      launch_select<Item, 7>, launch_select<Item, 8>};
  const long long pack_wave = 8LL * sm_count();
  for (int r0 = 0; r0 < 2 * G; r0 += rows) {
    a.r0 = r0;
    a.nr = 2 * G - r0 < rows ? 2 * G - r0 : rows;
    select[a.k - 1](a, st);
    for (int p = 0; p < a.passes; ++p)
      index_v2_pass<Item><<<a.nr * a.tiles, K10_THREADS, 0, st>>>(a, p);
    const long long pk = (a.nr * a.NQ + K10_THREADS - 1) / K10_THREADS;
    index_v2_pack<Item><<<(int)(pk < pack_wave ? pk : pack_wave),
                          K10_THREADS, 0, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// K9. fwd, rc: (G, Lp) int8 codes 0-4 (4 = pad or N), 16-byte aligned.
// Writes qocc: (G, 2 * NQB, H), rocc: (G, NRB, H), roww_f, roww_r: (G, NRB,
// ROWW) int8, all 16-byte aligned; NQB = Lp / WQ, NRB = Lp / 32. k: the
// k-mer length (1-8); ck: the digits of the canonical reverse complement
// (SEED_K, 1-8); shift = 32 - floor(log2 H). 16 <= H <= 16,384 and H % 16
// == 0; WQ a multiple of 32 of 1-13 blocks that divides Lp; ROWW % 16 ==
// 0. Returns cudaGetLastError().
int k9_index_v3(const int8_t* fwd, const int8_t* rc, int G, int Lp, int k,
                int ck, int H, int shift, int WQ, int ROWW, int8_t* qocc,
                int8_t* rocc, int8_t* roww_f, int8_t* roww_r, void* stream) {
  const int FPB = WQ / 32;
  if (G < 1 || Lp < 32 || k < 1 || k > 8 || ck < 1 || ck > 8 || H < 16 ||
      H > K9_MAX_H || H % 16 || shift < 0 || shift > 31 || WQ % 32 ||
      FPB < 1 || FPB > K9_MAX_FPB || Lp % WQ || ROWW < 16 || ROWW % 16)
    return (int)cudaErrorInvalidValue;
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        index_v3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        K9_WARPS * K9_MAX_H);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  const int smem = K9_WARPS * H;
  int per_sm = 0;
  int rc_ = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, index_v3_kernel, K9_WARPS * 32, smem);
  if (rc_) return rc_;
  const V3Args a{fwd, rc, G, Lp, k, ck, H, shift, WQ, FPB, Lp / WQ,
                 Lp / 32, ROWW, qocc, rocc, roww_f, roww_r};
  // One wave of CTAs, each warp taking coarse blocks in turn.
  const long long need =
      ((long long)G * (Lp / WQ) + K9_WARPS - 1) / K9_WARPS;
  const long long ctas =
      need < (long long)(per_sm > 0 ? per_sm : 1) * sm_count()
          ? need
          : (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  index_v3_kernel<<<(int)ctas, K9_WARPS * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// K10's rows a group for a chunk of G genomes at bucket Lp, C seeds a
// block (as many as K10_ITEM_BYTES of items hold, NQ = Lp / 32 * C a row,
// 4 bytes an item up to bucket 65,536 and 8 above), and the bytes of its
// two scratch buffers: the state (`k10_layout`: a header, the digit
// totals, the counts and the look-back words) and the items of a group.
// Both stay under 2^31 bytes (the items by their cap).
int k10_group_rows(int G, int Lp, int C) {
  const long long NQ = (long long)(Lp / 32) * C;
  long long rows = K10_ITEM_BYTES / (k10_item_bytes(Lp) * (NQ > 0 ? NQ : 1));
  rows = rows < 1 ? 1 : rows;
  return (int)(2LL * G < rows ? 2LL * G : rows);
}

int k10_state_bytes(int G, int Lp, int C) {
  return (int)k10_layout(k10_group_rows(G, Lp, C),
                         (long long)(Lp / 32) * C).bytes;
}

int k10_items_bytes(int G, int Lp, int C) {
  return (int)((long long)k10_item_bytes(Lp) * k10_group_rows(G, Lp, C) *
               (Lp / 32) * C);
}

// K10. fwd, rc: (G, Lp) int8 codes 0-4, 16-byte aligned, Lp a multiple of
// 32 up to 2^20. Writes qsv, qoff: (G, NQ) int32, NQ = Lp / 32 * C; per
// strand sv: (G, NQ) int32, pk1, pk2: (G, NQ) int64 (pk2 may be pk1 with
// 64-bit packs: it is then written once); r2dov: (G, 2 * (Lp / 32 + 1),
// 64) int8, 16-byte aligned. state: `state_bytes`, at least
// k10_state_bytes(G, Lp, C), 16-byte aligned, zeroed before its first
// launch and then used by one stream only (each launch leaves it ready
// for the next); items: `items_bytes`, at least k10_items_bytes(G, Lp,
// C), 16-byte aligned, any contents. The chunk's 2 G (genome, strand)
// rows go a group of k10_group_rows(G, Lp, C) at a time: the selection
// with counts, each radix pass, the packs. 1 <= k <= 8, 1 <= C <= 32,
// pack_bits 32 or 64. Returns cudaGetLastError().
int k10_index_v2(const int8_t* fwd, const int8_t* rc, int G, int Lp, int k,
                 int C, int pack_bits, int32_t* qsv, int32_t* qoff,
                 int32_t* sv_f, int64_t* pk1_f, int64_t* pk2_f,
                 int32_t* sv_r, int64_t* pk1_r, int64_t* pk2_r,
                 int8_t* r2dov, void* state, long long state_bytes,
                 void* items, long long items_bytes, void* stream) {
  if (G < 1 || Lp < 32 || Lp % 32 || Lp > (1 << 20) || k < 1 || k > 8 ||
      C < 1 || C > 32 || (pack_bits != 32 && pack_bits != 64))
    return (int)cudaErrorInvalidValue;
  const int rows = k10_group_rows(G, Lp, C);
  const long long NQ = (long long)(Lp / 32) * C;
  const K10Layout l = k10_layout(rows, NQ);
  if (state_bytes < l.bytes || items_bytes < k10_items_bytes(G, Lp, C) ||
      reinterpret_cast<uintptr_t>(state) % 16 ||
      reinterpret_cast<uintptr_t>(items) % 16)
    return (int)cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(state);
  const int NBF = Lp / 32;
  const V2Args a{fwd, rc, Lp, NBF, C, k, (2 * k + 7) / 8,
                 (int)((NQ + K10_TILE - 1) / K10_TILE),
                 (NBF + SEL_BLOCKS - 1) / SEL_BLOCKS, 0, 0, NQ, qsv, qoff,
                 {sv_f, sv_r}, {pk1_f, pk1_r}, {pk2_f, pk2_r},
                 pack_bits == 64, r2dov, reinterpret_cast<unsigned*>(base),
                 reinterpret_cast<u64*>(base + l.totals),
                 reinterpret_cast<u64*>(base + l.count),
                 reinterpret_cast<u64*>(base + l.status), items};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = Lp <= 65536 ? k10_run<unsigned>(a, G, rows, st)
                              : k10_run<u64>(a, G, rows, st);
  return err ? err : (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
