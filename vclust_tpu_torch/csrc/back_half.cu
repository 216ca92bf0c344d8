// K4: the shared back half of the align row core, one CTA a directed pair.
//
// Replaces the XLA device program of the JAX package's `_blocks_to_measures`
// (its ops/align_tpu.py:454-592), which both of its align pipes call once a
// dispatch; bit-exact with the plain torch version beside the wrapper in
// ops/align_gpu.py (`blocks_to_measures_plain`).
//
// What it computes, for each directed pair over its Lq query positions
// (NBF = Lq / 32 fine blocks): the single-switch refinement of the flags
// (per block the first position of the largest prefix gain of m0 over m1),
// the region breaks, runs of MSL = 7 and MAL = 11 matches, their +-AW = 39
// dilations, the AW_WIN = 15 density rule, the anchored matches `ma`, the
// segmentation, the three aggregates (n_alns, sum_match, sum_alnlen) and,
// with records, each accepted segment decoded through the switch-refined
// diagonal and strand, the first MAXSEG of them kept in order, and their
// number before the cap.
//
// The plain version forms eight cummax scans over Lq. They reduce to a walk
// over segments: the segment starts s_1 < s_2 < ... are the anchored
// matches whose previous one lies more than mqd + 1 positions back (or that
// follow a break), segment k ends at e_k, the last anchored match before
// s_{k+1} (the last one of all for the last segment), and the covered
// positions are exactly the union of [s_k, e_k] over the accepted segments,
// those with e_k - s_k + 1 >= reg and a MAL run in [s_k, s_{k+1}). So
// segment k is closed when s_{k+1} is seen: its length, its matches (the
// prefix count of m at e_k less that before s_k) and its record need only
// what a forward scan carries.
//
// What bounds it on an H100, and what the design does about it:
//   * Bytes: the two flag arrays read once (2 * Lq bytes a pair) and 13
//     bytes a block of per-block inputs; 33 MB at the B = 26 dispatch at
//     65,536, 10 us. The least int32 issue slots (162 a word of 32
//     positions, counted in chip_smoke.py) take less than half of that.
//     As written, the kernel spends more: it recomputes the runs of the
//     halo words and walks the anchored matches one by one, three times
//     (starts, segments, records), so it is bound by its serial chains.
//   * Design: positions are bits, 32 to a word (one word a fine block).
//     A CTA of 256 threads takes its pair in chunks of 1,024 words (32,768
//     positions), 4 consecutive words a thread, and reads the flags of 3
//     words on each side (the halo that the runs, the +-39 dilations and the
//     15-wide windows need). Per chunk, three block-wide scans carry what
//     crosses words and chunks: (1) the prefix count of m, the last anchored
//     match with the count there, the last break and the last MAL run;
//     (2) the last segment start with the count before it; (3) with records,
//     the accepted segments before each thread, which places its records.
//     Nothing leaves the chip but the results, so any bucket (up to
//     MAX_TPU_LEN = 2^20) runs in 8,568 bytes of shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int WPT = 4;              // words a thread, per chunk
constexpr int CW = THREADS * WPT;   // words a chunk
constexpr int HALO = 3;             // words of flags read on each side
constexpr int MSL = 7, MAL = 11, AW = 39, AW_WIN = 15, AM = 7;
static_assert(AW > 32 && AW < 64, "the dilations take two 32-wide steps");

struct Args {
  const uint8_t *m1, *m0, *sw, *A, *S;
  const int32_t* D;
  const uint8_t *Ap, *Sp;
  const int32_t *Dp, *rlen;
  int NBF, mqd, mrd, reg, maxseg;
  int32_t *agg, *recs, *nrec;
};

// Bits 0 .. t-1 (t <= 32) and bits 0 .. p (p <= 31).
__device__ __forceinline__ uint32_t below(int t) {
  return t >= 32 ? FULL : (1u << t) - 1u;
}
__device__ __forceinline__ uint32_t upto(int p) { return (2u << p) - 1u; }
__device__ __forceinline__ int last_bit(uint32_t x) { return 31 - __clz(x); }

// Bit i of the result is position i + d of the word pair (cur, next), and
// position i - d of (prev, cur); 0 <= d <= 32.
__device__ __forceinline__ uint32_t ahead(uint32_t cur, uint32_t next, int d) {
  return (uint32_t)((((uint64_t)next << 32) | cur) >> d);
}
__device__ __forceinline__ uint32_t behind(uint32_t prev, uint32_t cur,
                                           int d) {
  return (uint32_t)((((uint64_t)cur << 32) | prev) >> (32 - d));
}

// 32 bytes of 0 / 1 (16-byte aligned) as the bits of one word: the multiply
// moves the low bits of 4 bytes to bits 21-24 without carries.
__device__ __forceinline__ uint32_t pack4(uint32_t v) {
  return ((v * 0x00204081u) >> 21) & 0xfu;
}
__device__ __forceinline__ uint32_t load_bits(const uint8_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 a = __ldg(q), b = __ldg(q + 1);
  return pack4(a.x) | pack4(a.y) << 4 | pack4(a.z) << 8 | pack4(a.w) << 12 |
         pack4(b.x) << 16 | pack4(b.y) << 20 | pack4(b.z) << 24 |
         pack4(b.w) << 28;
}

// The switch point of a block: the first t in 0..32 where the prefix gain
// of m0 over m1 (positions < t) is largest.
__device__ __forceinline__ int switch_point(uint32_t w0, uint32_t w1) {
  int g = 0, best = 0, t = 0;
  uint32_t diff = w0 ^ w1;
  while (diff) {
    const int p = __ffs(diff) - 1;
    diff &= diff - 1;
    g += ((w0 >> p) & 1u) ? 1 : -1;
    if (g > best) {
      best = g;
      t = p + 1;
    }
  }
  return t;
}

__device__ __forceinline__ int tstar_of(const Args& a, size_t o) {
  return a.sw[o] ? switch_point(load_bits(a.m0 + o * 32),
                                load_bits(a.m1 + o * 32))
                 : 0;
}

// Block f of pair n: its refined flags m and its break bit (at the switch
// point, clamped to 31) where an assigned block follows an assigned block
// it does not link to.
__device__ __forceinline__ void block_word(const Args& a, int n, int f,
                                           bool want_break, uint32_t& m,
                                           uint32_t& brk) {
  const size_t o = (size_t)n * a.NBF + f;
  const uint32_t w1 = load_bits(a.m1 + o * 32), w0 = load_bits(a.m0 + o * 32);
  const int t = a.sw[o] ? switch_point(w0, w1) : 0;
  m = (w0 & below(t)) | (w1 & ~below(t));
  brk = 0;
  if (want_break && f > 0 && a.A[o] && a.Ap[o]) {
    const int dd = abs(a.D[o] - a.Dp[o]);
    if (!((a.S[o] != 0) == (a.Sp[o] != 0) && dd <= a.mrd))
      brk = 1u << min(t, 31);
  }
}

// Runs of at least L ones: their starts (word, next word), then every
// position of such a run (start words: previous, this).
template <int L>
__device__ __forceinline__ uint32_t run_starts(uint32_t cur, uint32_t next) {
  uint32_t s = cur;
#pragma unroll
  for (int d = 1; d < L; ++d) s &= ahead(cur, next, d);
  return s;
}
template <int L>
__device__ __forceinline__ uint32_t in_runs(uint32_t sprev, uint32_t scur) {
  uint32_t r = scur;
#pragma unroll
  for (int d = 1; d < L; ++d) r |= behind(sprev, scur, d);
  return r;
}

// Any one in [i - 31, i] (words prev, cur) / in [i, i + 31] (cur, next).
__device__ __forceinline__ uint32_t any_back32(uint32_t prev, uint32_t cur) {
  uint64_t y = ((uint64_t)cur << 32) | prev;
  y |= y << 1;
  y |= y << 2;
  y |= y << 4;
  y |= y << 8;
  y |= y << 16;
  return (uint32_t)(y >> 32);
}
__device__ __forceinline__ uint32_t any_fwd32(uint32_t cur, uint32_t next) {
  uint64_t y = ((uint64_t)next << 32) | cur;
  y |= y >> 1;
  y |= y >> 2;
  y |= y >> 4;
  y |= y >> 8;
  y |= y >> 16;
  return (uint32_t)y;
}

// Positions whose AW_WIN-window ending there holds at least AW_WIN - AM
// ones (words prev, cur).
__device__ __forceinline__ uint32_t dense_ends(uint32_t prev, uint32_t cur) {
  const uint64_t x = ((uint64_t)cur << 32) | prev;
  uint32_t out = 0;
#pragma unroll
  for (int p = 0; p < 32; ++p)
    out |= (uint32_t)(__popcll((x >> (33 - AW_WIN + p)) &
                               ((1ull << AW_WIN) - 1)) >= AW_WIN - AM)
           << p;
  return out;
}

// ---- block-wide exclusive scans -------------------------------------------

// Scan 1: over positions, the count of m, the last anchored match with the
// count of m up to and including it (relative to the start of the range),
// the last break and the last position of a MAL run.
struct Fwd {
  int cm, ma, cma, b, an;
};
struct FwdOp {
  __device__ Fwd operator()(const Fwd& l, const Fwd& r) const {
    Fwd o;
    o.cm = l.cm + r.cm;
    o.ma = r.ma >= 0 ? r.ma : l.ma;
    o.cma = r.ma >= 0 ? l.cm + r.cma : l.cma;
    o.b = max(l.b, r.b);
    o.an = max(l.an, r.an);
    return o;
  }
};
__device__ __forceinline__ Fwd shfl_up(const Fwd& v, int d) {
  return Fwd{__shfl_up_sync(FULL, v.cm, d), __shfl_up_sync(FULL, v.ma, d),
             __shfl_up_sync(FULL, v.cma, d), __shfl_up_sync(FULL, v.b, d),
             __shfl_up_sync(FULL, v.an, d)};
}

// Scan 2: the last segment start and the count of m before it.
struct Start {
  int s, cms;
};
struct StartOp {
  __device__ Start operator()(const Start& l, const Start& r) const {
    return r.s >= 0 ? r : l;
  }
};
__device__ __forceinline__ Start shfl_up(const Start& v, int d) {
  return Start{__shfl_up_sync(FULL, v.s, d), __shfl_up_sync(FULL, v.cms, d)};
}

// Scan 3: accepted segments.
struct AddOp {
  __device__ int operator()(int l, int r) const { return l + r; }
};
__device__ __forceinline__ int shfl_up(int v, int d) {
  return __shfl_up_sync(FULL, v, d);
}

// The thread's exclusive prefix of x under op, in thread order; `total`
// is the whole CTA's. Every thread of the CTA calls it.
template <class V, class Op>
__device__ __forceinline__ V block_scan(V x, Op op, V ident, V* tot,
                                        V& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  V inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const V y = shfl_up(inc, d);
    if (lane >= d) inc = op(y, inc);
  }
  V exc = shfl_up(inc, 1);
  if (lane == 0) exc = ident;
  if (lane == 31) tot[warp] = inc;
  __syncthreads();
  V pre = ident, all = ident;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    if (w == warp) pre = all;
    all = op(all, tot[w]);
  }
  __syncthreads();
  total = all;
  return op(pre, exc);
}

// ---- segments ---------------------------------------------------------------

struct Sums {
  int n, len, match;
};

// Record r of pair n: segment [s, e] with nt matches, decoded through the
// diagonal and strand in force at s and e (the previous block's before the
// block's switch point).
__device__ void write_record(const Args& a, int n, int r, int s, int e,
                            int nt) {
  if (r >= a.maxseg) return;
  int dv[2], strand = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int pos = k ? e : s;
    const size_t o = (size_t)n * a.NBF + (pos >> 5);
    const bool pre = (pos & 31) < tstar_of(a, o);
    dv[k] = pre ? a.Dp[o] : a.D[o];
    if (!k) strand = pre ? a.Sp[o] : a.S[o];
  }
  const int rl = a.rlen[n], rs = s + dv[0], re = e + dv[1];
  int32_t* out = a.recs + ((size_t)n * a.maxseg + r) * 6;
  out[0] = s;
  out[1] = e;
  out[2] = strand ? rl - 1 - rs : rs;
  out[3] = strand ? rl - 1 - re : re;
  out[4] = nt;
  out[5] = e - s + 1 - nt;
}

// Segment [s, e] closes: accepted when long enough and holding a MAL run
// (the last one up to e is at la).
__device__ __forceinline__ void close_segment(const Args& a, int n, int s,
                                              int e, int nt, int la,
                                              bool write, int& idx,
                                              Sums& sums) {
  if (e - s + 1 < a.reg || la < s) return;
  if (write) write_record(a, n, idx, s, e, nt);
  ++idx;
  ++sums.n;
  sums.len += e - s + 1;
  sums.match += nt;
}

// The walk over a thread's anchored matches in order: each segment start
// closes the segment before it. write = false counts and sums; write = true
// writes the records from index idx.
template <bool WRITE>
__device__ __forceinline__ void walk(const Args& a, int n, int w0,
                                     const uint32_t (&m)[WPT],
                                     const uint32_t (&ma)[WPT],
                                     const uint32_t (&anc)[WPT],
                                     const uint32_t (&sb)[WPT], Fwd f,
                                     Start st, int idx, Sums& sums) {
  int cm = f.cm, pm = f.ma, cmpm = f.cma, la = f.an;
#pragma unroll
  for (int o = 0; o < WPT; ++o) {
    const int base = 32 * (w0 + o);
    for (uint32_t x = ma[o]; x; x &= x - 1) {
      const int p = __ffs(x) - 1, i = base + p;
      const int cmi = cm + __popc(m[o] & upto(p));
      if ((sb[o] >> p) & 1u) {
        if (st.s >= 0)
          close_segment(a, n, st.s, pm, cmpm - st.cms, la, WRITE, idx, sums);
        st.s = i;
        st.cms = cmi - 1;
      }
      pm = i;
      cmpm = cmi;
      if ((anc[o] >> p) & 1u) la = i;
    }
    cm += __popc(m[o]);
  }
}

__global__ void __launch_bounds__(THREADS)
back_half_kernel(Args a) {
  __shared__ uint32_t mw[CW + 2 * HALO];   // refined flags, chunk + halo
  __shared__ uint32_t bw[CW];              // breaks
  __shared__ Fwd tot1[NWARPS];
  __shared__ Start tot2[NWARPS];
  __shared__ int tot3[NWARPS];
  __shared__ int red[3][NWARPS];
  const int n = blockIdx.x, tid = threadIdx.x, NBF = a.NBF;
  const bool records = a.recs != nullptr;
  const Fwd ident1{0, -1, 0, -1, -1};
  const Start ident2{-1, 0};
  Fwd carry1 = ident1;
  Start carry2 = ident2;
  int carry3 = 0;
  Sums sums{0, 0, 0};

  for (int c0 = 0; c0 < NBF; c0 += CW) {
    for (int k = tid; k < CW + 2 * HALO; k += THREADS) {
      const int f = c0 - HALO + k;
      const bool own = k >= HALO && k < CW + HALO;
      uint32_t m = 0, b = 0;
      if (f >= 0 && f < NBF) block_word(a, n, f, own, m, b);
      mw[k] = m;
      if (own) bw[k - HALO] = b;
    }
    __syncthreads();

    // This thread's words w0 .. w0 + WPT - 1, from flags of words w0 - 3 ..
    // w0 + WPT + 2 (index i of the window is word w0 - 3 + i).
    const int w0 = c0 + tid * WPT;
    uint32_t mwin[WPT + 6], st7[WPT + 5], ir7[WPT + 5], wb[WPT + 3],
        wf[WPT + 4], de[WPT + 4];
#pragma unroll
    for (int i = 0; i < WPT + 6; ++i) mwin[i] = mw[tid * WPT + i];
#pragma unroll
    for (int i = 0; i < WPT + 5; ++i)
      st7[i] = run_starts<MSL>(mwin[i], mwin[i + 1]);
    ir7[0] = 0;
#pragma unroll
    for (int i = 1; i < WPT + 5; ++i) ir7[i] = in_runs<MSL>(st7[i - 1], st7[i]);
#pragma unroll
    for (int i = 2; i < WPT + 3; ++i) wb[i] = any_back32(ir7[i - 1], ir7[i]);
#pragma unroll
    for (int i = 3; i < WPT + 4; ++i) {
      wf[i] = any_fwd32(ir7[i], ir7[i + 1]);
      de[i] = dense_ends(mwin[i - 1], mwin[i]);
    }
    uint32_t m[WPT], ma[WPT], anc[WPT], brk[WPT], sb[WPT];
    Fwd agg1 = ident1;
#pragma unroll
    for (int o = 0; o < WPT; ++o) {
      const int i = o + 3;
      const uint32_t near = wb[i] | behind(wb[i - 1], wb[i], AW - 31) |
                            wf[i] | ahead(wf[i], wf[i + 1], AW - 31);
      uint32_t dense = 0;
#pragma unroll
      for (int d = 0; d < AW_WIN; ++d) dense |= ahead(de[i], de[i + 1], d);
      m[o] = mwin[i];
      ma[o] = m[o] & near & (dense | ir7[i]);
      anc[o] = in_runs<MAL>(run_starts<MAL>(mwin[i - 1], mwin[i]),
                            run_starts<MAL>(mwin[i], mwin[i + 1]));
      brk[o] = bw[tid * WPT + o];
      const int base = 32 * (w0 + o);
      Fwd w{__popc(m[o]), -1, 0, -1, -1};
      if (ma[o]) {
        const int p = last_bit(ma[o]);
        w.ma = base + p;
        w.cma = __popc(m[o] & upto(p));
      }
      if (brk[o]) w.b = base + last_bit(brk[o]);
      if (anc[o]) w.an = base + last_bit(anc[o]);
      agg1 = FwdOp()(agg1, w);
    }
    Fwd all1;
    const Fwd f1 = FwdOp()(carry1, block_scan(agg1, FwdOp(), ident1, tot1,
                                              all1));

    // Segment starts: an anchored match with none in the mqd + 1 positions
    // before it, or with a break after the one before it.
    Start agg2 = ident2;
    {
      int cm = f1.cm, pm = f1.ma, lb = f1.b;
#pragma unroll
      for (int o = 0; o < WPT; ++o) {
        const int base = 32 * (w0 + o);
        sb[o] = 0;
        for (uint32_t x = ma[o]; x; x &= x - 1) {
          const int p = __ffs(x) - 1, i = base + p;
          const uint32_t bb = brk[o] & upto(p);
          const int lbi = bb ? base + last_bit(bb) : lb;
          if (pm < 0 || (long long)pm < (long long)i - a.mqd - 1 || lbi > pm) {
            sb[o] |= 1u << p;
            agg2 = Start{i, cm + __popc(m[o] & upto(p)) - 1};
          }
          pm = i;
        }
        cm += __popc(m[o]);
        if (brk[o]) lb = base + last_bit(brk[o]);
      }
    }
    Start all2;
    const Start f2 = StartOp()(carry2, block_scan(agg2, StartOp(), ident2,
                                                  tot2, all2));

    // Close the segments before this thread's starts; with records, place
    // them after every accepted segment before the thread and write them.
    Sums mine{0, 0, 0};
    walk<false>(a, n, w0, m, ma, anc, sb, f1, f2, 0, mine);
    if (records) {
      int all3;
      const int before = block_scan(mine.n, AddOp(), 0, tot3, all3);
      Sums dummy{0, 0, 0};
      walk<true>(a, n, w0, m, ma, anc, sb, f1, f2, carry3 + before, dummy);
      carry3 += all3;
    }
    sums.n += mine.n;
    sums.len += mine.len;
    sums.match += mine.match;
    carry1 = FwdOp()(carry1, all1);
    carry2 = StartOp()(carry2, all2);
  }

  // The last segment ends at the last anchored match.
  if (tid == 0 && carry2.s >= 0)
    close_segment(a, n, carry2.s, carry1.ma, carry1.cma - carry2.cms,
                  carry1.an, records, carry3, sums);

  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = __reduce_add_sync(FULL, sums.n);
  const int r1 = __reduce_add_sync(FULL, sums.match);
  const int r2 = __reduce_add_sync(FULL, sums.len);
  if (lane == 0) {
    red[0][warp] = r0;
    red[1][warp] = r1;
    red[2][warp] = r2;
  }
  __syncthreads();
  if (tid < 3) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += red[tid][w];
    a.agg[(size_t)n * 3 + tid] = s;
    if (tid == 0) a.nrec[n] = s;
  }
}

}  // namespace

extern "C" {

// K4. m1, m0: (N, Lq) bool, 16-byte aligned; sw, A, S, Ap, Sp: (N, Lq/32)
// bool; D, Dp: (N, Lq/32) int32; rlen: (N,) int32; agg: (N, 3) int32; recs:
// (N, maxseg, 6) int32 filled with -1 by the caller, or null for no
// records; nrec: (N,) int32. mqd >= 0. Returns cudaGetLastError().
int k4_back_half(const uint8_t* m1, const uint8_t* m0, const uint8_t* sw,
                 const uint8_t* A, const uint8_t* S, const int32_t* D,
                 const uint8_t* Ap, const uint8_t* Sp, const int32_t* Dp,
                 const int32_t* rlen, int N, int Lq, int mqd, int mrd,
                 int reg, int maxseg, int32_t* agg, int32_t* recs,
                 int32_t* nrec, void* stream) {
  if (N < 1 || Lq < 32 || Lq % 32 || mqd < 0 || (recs && maxseg < 1))
    return (int)cudaErrorInvalidValue;
  const Args a{m1, m0, sw, A, S, D, Ap, Sp, Dp, rlen, Lq / 32, mqd, mrd, reg,
               maxseg, agg, recs, nrec};
  back_half_kernel<<<N, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
