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
// time (as many as a 128 MiB scratch of one u64 a slot holds: 512 rows at
// 65,536 and C = 16, 128 at 262,144), each group four to six launches.
//   * Selection (index_v2_select). A warp takes a fine block of 32
//     positions, lane l offset l: its k-mer value v (-1 where invalid) and
//     hash h = (uint32(v) * 2654435761) >> 16 (2^16, above every valid
//     hash, where invalid). A bitonic network over the warp sorts the keys
//     h << 5 | l; lane r < C takes the r-th: the block's C smallest (hash,
//     offset), as the plain version's stable sort keeps them. From the
//     forward strand qsv (v, or -1) and qoff (the offset, kept for invalid
//     slots too); for the sort, an item (v << 40 | pos + 1 << 20) per valid
//     slot and NONE per invalid one, in slot order, and the first pass's
//     digit counts a tile of 4,096 slots (global atomics, one a warp's
//     equal (tile, digit)). Then the window rows (r2dov) as 16-byte copies.
//   * The sort. The plain version's stable sort of a strand's slots by
//     value keeps slot order among equal values, and slot order is (block,
//     hash rank): equal values in one block share their hash and are
//     ranked by offset, so it is position order. So the valid entries end
//     ordered by (value, position), and a stable LSD radix sort of the
//     slots by value gives the same: ceil(2k / 8) passes of 8-bit digits
//     (two at k = 8). A pass is a scan (index_v2_scan: a CTA a row turns
//     each tile's digit counts into its offset inside the digit, and the
//     digits' totals into their first places) and a scatter
//     (index_v2_scatter: a CTA a (row, tile); a warp takes 16 rounds of 32
//     consecutive items; __match_any_sync ranks an item among its round's
//     lanes of its digit, a per-warp digit count in shared memory after
//     the warp's earlier rounds; the warps' counts are scanned per digit
//     from the tile's offset; the item is stored at its place and counted
//     for the next pass at its new tile). Only valid items take part (the
//     first scan counts them); invalid entries are BIG / 0 whatever their
//     order, since no output holds their positions. The passes ping-pong
//     between pk1's row and the group's scratch row, in the order that
//     leaves the sorted items in the scratch.
//   * The packs (index_v2_pack): sv, pk1 and pk2 from the sorted items,
//     the previous position where the entry before holds the same value.
//   * Bound: bytes (codes read once, the arena written once). The first
//     version took a row a CTA (48 and 16 CTAs at the smoke's v2 arenas);
//     a row now spreads over NBF / 8 selection CTAs and NQ / 4,096 tiles.

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
constexpr u64 NONE = ~0ULL;           // an invalid slot's item
// Scratch a group of rows may hold (one u64 a slot of each of its rows).
constexpr long long K10_SCRATCH_BYTES = 128LL << 20;

// One group of (genome, strand) rows [r0, r0 + nr), row r = 2 g + s.
struct V2Args {
  const int8_t* fwd;
  const int8_t* rc;
  int Lp, NBF, C, k, passes, tiles, r0, nr;
  long long NQ;
  int32_t* qsv;
  int32_t* qoff;
  int32_t* sv[2];
  int64_t* pk1[2];
  int64_t* pk2[2];
  int pack64;
  int8_t* r2dov;
  u64* scratch;   // nr rows of NQ items
  // hist[p][row][tile][digit]: counts, then (scan) offsets in the digit;
  // dbase[p][row][digit]: the digit's first place; count[row]: valid.
  int32_t* hist;
  int32_t* dbase;
  int32_t* count;
};

__device__ __forceinline__ int32_t* hist_at(const V2Args& a, int p, int rl,
                                            int tile) {
  return a.hist + (((size_t)p * a.nr + rl) * a.tiles + tile) * DIGITS;
}

// pk1's row of row r0 + rl (one of the two item buffers) and the group's
// scratch row; the passes alternate from S0 so that the last writes the
// scratch.
__device__ __forceinline__ u64* pk1_row(const V2Args& a, int rl) {
  const int r = a.r0 + rl;
  return reinterpret_cast<u64*>(a.pk1[r & 1] + (size_t)(r >> 1) * a.NQ);
}
__device__ __forceinline__ u64* items_of(const V2Args& a, int rl, int pass) {
  // Pass p reads buffer p % 2 (0: S0) and writes the other.
  const bool s0_is_pk1 = a.passes & 1;
  const bool pk1 = (pass & 1) ? !s0_is_pk1 : s0_is_pk1;
  return pk1 ? pk1_row(a, rl) : a.scratch + (size_t)rl * a.NQ;
}

__device__ __forceinline__ int digit_of(u64 it, int pass) {
  return (int)(it >> (40 + 8 * pass)) & 255;
}

// Selection: a warp a fine block; the 32 (hash, offset) keys sorted over
// the warp by a bitonic network, lane r < C takes the r-th. Writes qsv and
// qoff (forward rows), the items in slot order (S0) and the first pass's
// digit counts a tile; then the group's window rows.
__global__ void __launch_bounds__(K10_THREADS)
index_v2_select(V2Args a) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * K10_WARPS;
  const long long tasks = (long long)a.nr * a.NBF;
  for (long long t = (long long)blockIdx.x * K10_WARPS + (threadIdx.x >> 5);
       t < tasks; t += warps) {
    const int rl = (int)(t / a.NBF), b = (int)(t % a.NBF);
    const int r = a.r0 + rl, g = r >> 1, s = r & 1;
    const int8_t* codes = (s ? a.rc : a.fwd) + (size_t)g * a.Lp;
    const long long p = 32LL * b + lane;
    const int v = kmer_value(code_at(codes, p, a.Lp),
                             code_at(codes, p + 32, a.Lp), lane, a.k);
    // Valid hashes are < 2^16; 2^16 stands for BIG.
    const int h = v >= 0 ? (int)(((unsigned)v * HASH_MUL) >> 16) : 65536;
    int key = h << 5 | lane;
    for (int size = 2; size <= 32; size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const int other = __shfl_xor_sync(FULL, key, stride);
        const bool up = (lane & size) == 0, low = (lane & stride) == 0;
        key = (low == up) ? min(key, other) : max(key, other);
      }
    const int off = key & 31;
    const int vv = __shfl_sync(FULL, v, off);
    const bool take = lane < a.C;
    const long long slot = (long long)b * a.C + lane;
    const size_t o = (size_t)g * a.NQ;
    if (take && s == 0) {
      a.qsv[o + slot] = vv;
      a.qoff[o + slot] = off;
    }
    const bool valid = take && vv >= 0;
    if (take) {
      const u64 it =
          valid ? ((u64)vv << 40 | (u64)(32LL * b + off + 1) << 20) : NONE;
      items_of(a, rl, 0)[slot] = it;
    }
    // The first pass's counts, a warp's equal (tile, digit) at once.
    const int hk = valid ? (int)(slot / K10_TILE) << 8 | (vv & 255) : -1;
    const unsigned peers = __match_any_sync(FULL, hk);
    if (valid && lane == __ffs(peers) - 1)
      atomicAdd(hist_at(a, 0, rl, hk >> 8) + (hk & 255), __popc(peers));
  }
  // The window rows of the group's rows: an all-pad row, then codes[32 j,
  // 32 j + 64) for every fine block j (pads past the end).
  const long long chunks = (long long)a.nr * 4 * (a.NBF + 1);
  for (long long c = (long long)blockIdx.x * K10_THREADS + threadIdx.x;
       c < chunks; c += (long long)gridDim.x * K10_THREADS) {
    const int rl = (int)(c / (4LL * (a.NBF + 1)));
    const long long w = c % (4LL * (a.NBF + 1));
    const int r = a.r0 + rl, g = r >> 1, s = r & 1;
    const int8_t* codes = (s ? a.rc : a.fwd) + (size_t)g * a.Lp;
    const long long j = w >> 2, idx = 32 * (j - 1) + 16 * (w & 3);
    uint4 v = pad16();
    if (j > 0 && idx < a.Lp) v = *reinterpret_cast<const uint4*>(codes + idx);
    *reinterpret_cast<uint4*>(
        a.r2dov + ((size_t)g * 2 + s) * (size_t)(a.NBF + 1) * 64 + 16 * w) =
        v;
  }
}

// Pass p's scan, a CTA a row, a thread a digit: each tile's count becomes
// the tile's offset inside the digit, the digits' totals their first
// places (dbase); the first pass also leaves the row's valid count.
__global__ void __launch_bounds__(DIGITS) index_v2_scan(V2Args a, int pass) {
  __shared__ int warp_sum[DIGITS / 32];
  const int rl = blockIdx.x, d = threadIdx.x, lane = d & 31;
  int32_t* h = hist_at(a, pass, rl, 0) + d;
  int run = 0;
  for (int t = 0; t < a.tiles; ++t) {
    const int c = h[(size_t)t * DIGITS];
    h[(size_t)t * DIGITS] = run;
    run += c;
  }
  int inc = run;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_sum[d >> 5] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < (d >> 5); ++w) before += warp_sum[w];
  a.dbase[((size_t)pass * a.nr + rl) * DIGITS + d] = before + inc - run;
  if (pass == 0 && d == DIGITS - 1) a.count[rl] = before + inc;
}

// Pass p's scatter, a CTA a (row, tile) of K10_TILE items: a warp takes
// K10_IPT rounds of 32 consecutive items; an item's rank among its round's
// lanes of its digit (__match_any_sync) and after the warp's earlier rounds
// (a per-warp count in shared memory); the warps' counts scanned per digit
// from the tile's offsets; the item stored at its place, and counted for
// the next pass at its new tile.
__global__ void __launch_bounds__(K10_THREADS)
index_v2_scatter(V2Args a, int pass) {
  __shared__ int whist[K10_WARPS][DIGITS];
  const int rl = blockIdx.x / a.tiles, tile = blockIdx.x % a.tiles;
  const long long n = pass ? a.count[rl] : a.NQ;
  const long long t0 = (long long)tile * K10_TILE;
  if (t0 >= n) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const u64* src = items_of(a, rl, pass);
  u64* dst = items_of(a, rl, pass + 1);
  for (int d = lane; d < DIGITS; d += 32) whist[warp][d] = 0;
  __syncwarp();
  const unsigned lt = (1u << lane) - 1;
  u64 it[K10_IPT];
  int dg[K10_IPT], rk[K10_IPT];
#pragma unroll
  for (int j = 0; j < K10_IPT; ++j) {
    const long long i = t0 + (long long)(warp * K10_IPT + j) * 32 + lane;
    it[j] = i < n ? src[i] : NONE;
    const bool ok = it[j] != NONE;
    dg[j] = ok ? digit_of(it[j], pass) : DIGITS;
    const unsigned peers = __match_any_sync(FULL, dg[j]);
    rk[j] = ok ? whist[warp][dg[j]] + __popc(peers & lt) : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) whist[warp][dg[j]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  {   // the warps' offsets of digit d, from the tile's place in the digit
    const int d = threadIdx.x;
    int run = a.dbase[((size_t)pass * a.nr + rl) * DIGITS + d] +
              hist_at(a, pass, rl, tile)[d];
    for (int w = 0; w < K10_WARPS; ++w) {
      const int c = whist[w][d];
      whist[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
  const bool next = pass + 1 < a.passes;
#pragma unroll
  for (int j = 0; j < K10_IPT; ++j) {
    const bool ok = it[j] != NONE;
    const int at = ok ? whist[warp][dg[j]] + rk[j] : 0;
    if (ok) dst[at] = it[j];
    if (next) {
      const int hk = ok ? (at / K10_TILE) << 8 | digit_of(it[j], pass + 1)
                        : -1;
      const unsigned peers = __match_any_sync(FULL, hk);
      if (ok && lane == __ffs(peers) - 1)
        atomicAdd(hist_at(a, pass + 1, rl, hk >> 8) + (hk & 255),
                  __popc(peers));
    }
  }
}

// sv, pk1 and pk2 of the group's rows from the sorted items (the scratch):
// the previous position where the entry before holds the same value.
__global__ void __launch_bounds__(K10_THREADS) index_v2_pack(V2Args a) {
  const long long total = (long long)a.nr * a.NQ;
  for (long long x = (long long)blockIdx.x * K10_THREADS + threadIdx.x;
       x < total; x += (long long)gridDim.x * K10_THREADS) {
    const int rl = (int)(x / a.NQ);
    const long long i = x % a.NQ;
    const int r = a.r0 + rl, g = r >> 1, s = r & 1;
    const size_t o = (size_t)g * a.NQ + i;
    const u64* X = a.scratch + (size_t)rl * a.NQ;
    int64_t* pk2 = a.pk2[s];
    const bool alias = pk2 == a.pk1[s];
    if (i < a.count[rl]) {
      const u64 it = X[i];
      const long long v = (long long)(it >> 40);
      long long prev = 0;             // previous position + 1, or 0
      if (i > 0 && (X[i - 1] >> 40) == (it >> 40))
        prev = (long long)((X[i - 1] >> 20) & 0xFFFFF);
      a.sv[s][o] = (int32_t)v;
      if (a.pack64) {
        a.pk1[s][o] = (long long)it | prev;
        if (!alias) pk2[o] = (long long)it | prev;
      } else {
        a.pk1[s][o] = v << 16 | (long long)((it >> 20) & 0xFFFFF);
        pk2[o] = prev ? (v << 16 | prev) : 0;
      }
    } else {
      a.sv[s][o] = BIG;
      a.pk1[s][o] = 0;
      if (!alias) pk2[o] = 0;
    }
  }
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

// K10's scratch for a chunk of G genomes at NQ slots a row: the rows of a
// group (`k10_scratch_rows`, each NQ u64; K10 sorts the chunk's 2 G rows a
// group at a time) and the int32 words of its counts (`k10_meta_ints`).
int k10_scratch_rows(int G, int NQ) {
  long long rows = K10_SCRATCH_BYTES / (8LL * (NQ > 0 ? NQ : 1));
  rows = rows < 1 ? 1 : rows;
  return (int)(2LL * G < rows ? 2LL * G : rows);
}

int k10_meta_ints(int rows, int NQ) {
  const long long tiles = ((long long)NQ + K10_TILE - 1) / K10_TILE;
  return (int)((long long)rows *
               (K10_MAX_PASSES * (tiles + 1) * DIGITS + 1));
}

// K10. fwd, rc: (G, Lp) int8 codes 0-4, 16-byte aligned, Lp a multiple of
// 32 up to 2^20. Writes qsv, qoff: (G, NQ) int32, NQ = Lp / 32 * C; per
// strand sv: (G, NQ) int32, pk1, pk2: (G, NQ) int64 (pk2 may be pk1 with
// 64-bit packs: it is then written once); r2dov: (G, 2 * (Lp / 32 + 1),
// 64) int8, 16-byte aligned. scratch: `rows` (k10_scratch_rows) rows of NQ
// u64; meta: k10_meta_ints(rows, NQ) int32. The chunk's 2 G (genome,
// strand) rows go a group of `rows` at a time: the selection, then each
// pass's scan and scatter, then the packs. 1 <= k <= 8, 1 <= C <= 32,
// pack_bits 32 or 64. Returns cudaGetLastError().
int k10_index_v2(const int8_t* fwd, const int8_t* rc, int G, int Lp, int k,
                 int C, int pack_bits, int rows, int32_t* qsv,
                 int32_t* qoff, int32_t* sv_f, int64_t* pk1_f,
                 int64_t* pk2_f, int32_t* sv_r, int64_t* pk1_r,
                 int64_t* pk2_r, int8_t* r2dov, void* scratch, int32_t* meta,
                 void* stream) {
  if (G < 1 || Lp < 32 || Lp % 32 || Lp > (1 << 20) || k < 1 || k > 8 ||
      C < 1 || C > 32 || (pack_bits != 32 && pack_bits != 64) || rows < 1 ||
      rows > 2 * G)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long NQ = (long long)(Lp / 32) * C;
  const int tiles = (int)((NQ + K10_TILE - 1) / K10_TILE);
  const int passes = (2 * k + 7) / 8;
  // The grid-stride kernels take one wave of resident CTAs.
  int sel_sm = 0, pack_sm = 0;
  int rc_ = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &sel_sm, index_v2_select, K10_THREADS, 0);
  if (!rc_)
    rc_ = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &pack_sm, index_v2_pack, K10_THREADS, 0);
  if (rc_) return rc_;
  const long long sel_wave = (long long)(sel_sm > 0 ? sel_sm : 1) *
                             sm_count();
  const long long pack_wave = (long long)(pack_sm > 0 ? pack_sm : 1) *
                              sm_count();
  for (int r0 = 0; r0 < 2 * G; r0 += rows) {
    const int nr = 2 * G - r0 < rows ? 2 * G - r0 : rows;
    int32_t* hist = meta;
    int32_t* dbase = hist + (size_t)K10_MAX_PASSES * nr * tiles * DIGITS;
    int32_t* count = dbase + (size_t)K10_MAX_PASSES * nr * DIGITS;
    const V2Args a{fwd, rc, Lp, Lp / 32, C, k, passes, tiles, r0, nr, NQ,
                   qsv, qoff, {sv_f, sv_r}, {pk1_f, pk1_r}, {pk2_f, pk2_r},
                   pack_bits == 64, r2dov, static_cast<u64*>(scratch),
                   hist, dbase, count};
    cudaError_t err = cudaMemsetAsync(
        hist, 0, sizeof(int32_t) * (size_t)passes * nr * tiles * DIGITS,
        st);
    if (err != cudaSuccess) return (int)err;
    const long long sel = ((long long)nr * (Lp / 32) + K10_WARPS - 1) /
                          K10_WARPS;
    index_v2_select<<<(int)(sel < sel_wave ? sel : sel_wave), K10_THREADS,
                      0, st>>>(a);
    for (int p = 0; p < passes; ++p) {
      index_v2_scan<<<nr, DIGITS, 0, st>>>(a, p);
      index_v2_scatter<<<nr * tiles, K10_THREADS, 0, st>>>(a, p);
    }
    const long long pk = (nr * NQ + K10_THREADS - 1) / K10_THREADS;
    index_v2_pack<<<(int)(pk < pack_wave ? pk : pack_wave), K10_THREADS, 0,
                    st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
