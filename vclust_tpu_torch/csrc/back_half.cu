// K4: the shared back half of the align row core, chunks of a pair over
// CTAs.
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
//   * Latency: a pair's chunks taken in series by one CTA (88 CTAs on the
//     v2 dispatch at 262,144), walks over every anchored match one bit at
//     a time, or a look-back for each carry below would leave most of the
//     card idle.
//   * Design: positions are bits, 32 to a word (one word a fine block). A
//     CTA takes one chunk of a pair, 2 consecutive words a thread (256
//     threads and 512 words = 16,384 positions; 64 or 128 threads where
//     the pair is shorter, so no thread idles): N * ceil(NBF / 512) CTAs.
//     It reads the flags of 3 words on each side (the halo that the runs,
//     the +-39 dilations and the 15-wide windows, a carry-save count,
//     need). From its own words a chunk forms a summary, with three
//     block-wide scans: its forward aggregate (count of m, last anchored
//     match and the count there, last break, last MAL run); its segment
//     starts, found a word at a time with masks, all but its first
//     anchored match's (that one depends on what came before); and the
//     segments those starts close, each at the last anchored match below
//     the next start, with its match count from a population count. Then
//     one single-pass decoupled look-back gives the state before the chunk
//     (forward state, last start, accepted segments with their lengths and
//     matches): the first warp reads 32 predecessors at once, back to the
//     nearest one whose state is out, and applies the summaries after it
//     in order. Applying its own summary resolves the chunk's first starts
//     and gives the state it publishes. A CTA takes its chunk from an
//     atomic ticket, in order, so it waits only on CTAs that are already
//     running. The records go after every accepted segment before them;
//     the pair's last chunk closes its last segment, writes the aggregates
//     and fills the record rows past the last one with -1. Nothing leaves
//     the chip but the results and 128 bytes a chunk of look-back state,
//     in a scratch buffer the wrapper keeps per device and stream (zeroed
//     once; an epoch that the launch's last CTA advances tells one
//     launch's flags from the next, so a launch needs no memset and may be
//     replayed in a graph).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WPT = 2;              // words a thread, per chunk
constexpr int HALO = 3;             // words of flags read on each side
constexpr int MSL = 7, MAL = 11, AW = 39, AW_WIN = 15, AM = 7;
static_assert(AW > 32 && AW < 64, "the dilations take two 32-wide steps");

// The scratch buffer: a header (the ticket, the CTAs finished, the epoch)
// and, a chunk, STATUS_INTS ints of look-back state (`status`).
constexpr int HEADER_INTS = 16;
constexpr int STATUS_INTS = 32;
constexpr uint32_t EPOCH_MASK = (1u << 30) - 1;
// Chunks a pair at most: MAX_TPU_LEN = 2^20 positions in chunks of 512
// words.
constexpr int MAX_CHUNKS = 64;

struct Args {
  const uint8_t *m1, *m0, *sw, *A, *S;
  const int32_t* D;
  const uint8_t *Ap, *Sp;
  const int32_t *Dp, *rlen;
  int NBF, chunks, units, mqd, mrd, reg, maxseg;
  int32_t *agg, *recs, *nrec, *scratch;
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
__device__ __forceinline__ uint32_t bits_of(const uint4& x, const uint4& y) {
  return pack4(x.x) | pack4(x.y) << 4 | pack4(x.z) << 8 | pack4(x.w) << 12 |
         pack4(y.x) << 16 | pack4(y.y) << 20 | pack4(y.z) << 24 |
         pack4(y.w) << 28;
}
__device__ __forceinline__ uint32_t load_bits(const uint8_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  return bits_of(__ldg(q), __ldg(q + 1));
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

// Block f's inputs, loaded with no use so that a thread's loads are in
// flight together: its two flag rows (32 bytes each), its switchable bit
// and, where its break is wanted, A, Ap, S, Sp and D, Dp.
struct BlockRaw {
  uint4 m1a, m1b, m0a, m0b;
  uint32_t bits;   // switchable, A, Ap, S, Sp: bits 0-4
  int32_t D, Dp;
};
__device__ __forceinline__ BlockRaw load_block(const Args& a, size_t o,
                                               bool want_break) {
  BlockRaw r;
  const uint4* q1 = reinterpret_cast<const uint4*>(a.m1 + o * 32);
  const uint4* q0 = reinterpret_cast<const uint4*>(a.m0 + o * 32);
  r.m1a = __ldg(q1);
  r.m1b = __ldg(q1 + 1);
  r.m0a = __ldg(q0);
  r.m0b = __ldg(q0 + 1);
  r.bits = __ldg(a.sw + o) != 0;
  r.D = r.Dp = 0;
  if (want_break) {
    r.bits |= (uint32_t)(__ldg(a.A + o) != 0) << 1 |
              (uint32_t)(__ldg(a.Ap + o) != 0) << 2 |
              (uint32_t)(__ldg(a.S + o) != 0) << 3 |
              (uint32_t)(__ldg(a.Sp + o) != 0) << 4;
    r.D = __ldg(a.D + o);
    r.Dp = __ldg(a.Dp + o);
  }
  return r;
}

// Block f (> 0 for a break): its refined flags m and its break bit (at the
// switch point, clamped to 31) where an assigned block follows an
// assigned block it does not link to.
__device__ __forceinline__ void block_word(const BlockRaw& r, int f, int mrd,
                                           uint32_t& m, uint32_t& brk) {
  const uint32_t w1 = bits_of(r.m1a, r.m1b), w0 = bits_of(r.m0a, r.m0b);
  const int t = (r.bits & 1u) ? switch_point(w0, w1) : 0;
  m = (w0 & below(t)) | (w1 & ~below(t));
  brk = 0;
  if (f > 0 && (r.bits & 6u) == 6u) {
    const bool same_strand = ((r.bits >> 3) & 1u) == ((r.bits >> 4) & 1u);
    if (!(same_strand && abs(r.D - r.Dp) <= mrd)) brk = 1u << min(t, 31);
  }
}

// Runs of at least L ones: their starts (word, next word), then every
// position of such a run (start words: previous, this); each by doubling
// over the 64-bit pair.
template <int L>
__device__ __forceinline__ uint32_t run_starts(uint32_t cur, uint32_t next) {
  uint64_t y = ((uint64_t)next << 32) | cur;
  int len = 1;
#pragma unroll
  for (; 2 * len <= L; len *= 2) y &= y >> len;
  if (len < L) y &= y >> (L - len);
  return (uint32_t)y;
}
template <int L>
__device__ __forceinline__ uint32_t in_runs(uint32_t sprev, uint32_t scur) {
  uint64_t y = ((uint64_t)scur << 32) | sprev;
  int len = 1;
#pragma unroll
  for (; 2 * len <= L; len *= 2) y |= y << len;
  if (len < L) y |= y << (L - len);
  return (uint32_t)(y >> 32);
}

// Any one in [i - 31, i] (words prev, cur) / in [i, i + 31] (cur, next) /
// in [i, i + AW_WIN - 1] (cur, next).
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
__device__ __forceinline__ uint32_t any_fwd15(uint32_t cur, uint32_t next) {
  static_assert(AW_WIN == 15, "the steps cover 0 .. 14");
  uint64_t y = ((uint64_t)next << 32) | cur;
  y |= y >> 1;
  y |= y >> 2;
  y |= y >> 4;
  y |= y >> 7;
  return (uint32_t)y;
}

// A carry-save adder: h:l = a + b + c, bit by bit.
__device__ __forceinline__ void csa(uint32_t& h, uint32_t& l, uint32_t a,
                                    uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  h = (a & b) | (u & c);
  l = u ^ c;
}

// Positions whose AW_WIN-window ending there holds at least AW_WIN - AM
// ones (words prev, cur): the 15 shifted copies summed bit-sliced by
// carry-save adders; the sum is at most 15, so it reaches 8 exactly when
// a carry of weight 8 comes out.
__device__ __forceinline__ uint32_t dense_ends(uint32_t prev, uint32_t cur) {
  static_assert(AW_WIN == 15 && AW_WIN - AM == 8, "a sum of 15, >= 8");
  uint32_t v[AW_WIN + 1];
  v[0] = cur;
#pragma unroll
  for (int k = 1; k < AW_WIN; ++k) v[k] = behind(prev, cur, k);
  v[AW_WIN] = 0;
  uint32_t ones = 0, twos = 0, fours = 0, eights = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t* x = v + 8 * h;
    uint32_t tA, tB, fA, fB, e;
    csa(tA, ones, ones, x[0], x[1]);
    csa(tB, ones, ones, x[2], x[3]);
    csa(fA, twos, twos, tA, tB);
    csa(tA, ones, ones, x[4], x[5]);
    csa(tB, ones, ones, x[6], x[7]);
    csa(fB, twos, twos, tA, tB);
    csa(e, fours, fours, fA, fB);
    eights |= e;
  }
  return eights;
}

// ---- carries --------------------------------------------------------------

// The forward state: over positions, the count of m, the last anchored
// match with the count of m up to and including it (relative to the start
// of the range), the last break and the last position of a MAL run.
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

// The last segment start and the count of m before it.
struct Start {
  int s, cms;
};
struct StartOp {
  __device__ Start operator()(const Start& l, const Start& r) const {
    return r.s >= 0 ? r : l;
  }
};

// Accepted segments, their lengths and their matches.
struct Sums {
  int n, len, match;
};
struct SumsOp {
  __device__ Sums operator()(const Sums& l, const Sums& r) const {
    return Sums{l.n + r.n, l.len + r.len, l.match + r.match};
  }
};

// A chunk's summary, from its own words (counts of m are the chunk's own):
// its forward aggregate; its first anchored match i0, the count before it
// and x0, whether a break in the chunk at or before it makes it a start
// whatever came before; the last of its other starts (determined, as they
// depend on the chunk alone); the first determined start p1 with the last
// anchored match below it (e1), the count up to e1 and the last MAL run
// below p1 (-1 if none in the chunk); the segments the determined starts
// after p1 close.
struct Summary {
  Fwd F;
  int i0, cms0, x0;
  Start sd;
  int p1, e1, cma1, la1;
  Sums D;
};
// The state between chunks: forward state, last start, accepted segments.
struct State {
  Fwd F;
  Start S;
  Sums C;
};
struct Seg {
  int s, e, nt;
};

// The state after a chunk, from the state X before it and its summary,
// and the accepted segments its first starts close (at most two: at i0
// when it starts one, and at p1), which only X decides.
__device__ State apply_summary(const Summary& sm, const State& X, int mqd,
                               int reg, Seg (&out)[2], int& nout) {
  State Y;
  Y.C = X.C;
  nout = 0;
  auto close = [&](const Start& st, int e, int cma, int la) {
    if (e - st.s + 1 < reg || la < st.s) return;
    out[nout++] = Seg{st.s, e, cma - st.cms};
    Y.C = SumsOp()(Y.C, Sums{1, e - st.s + 1, cma - st.cms});
  };
  Start open = X.S;
  if (sm.i0 >= 0 && (sm.x0 || X.F.ma < 0 || X.F.ma < sm.i0 - mqd - 1 ||
                     X.F.b > X.F.ma)) {
    if (X.S.s >= 0) close(X.S, X.F.ma, X.F.cma, X.F.an);
    open = Start{sm.i0, X.F.cm + sm.cms0};
  }
  if (sm.p1 >= 0 && open.s >= 0)
    close(open, sm.e1, X.F.cm + sm.cma1, sm.la1 >= 0 ? sm.la1 : X.F.an);
  Y.F = FwdOp()(X.F, sm.F);
  Y.S = sm.sd.s >= 0 ? Start{sm.sd.s, X.F.cm + sm.sd.cms} : open;
  Y.C = SumsOp()(Y.C, sm.D);
  return Y;
}

// A struct of ints, a lane to another.
template <class V>
__device__ __forceinline__ V shfl_up(V v, int d) {
  int* x = reinterpret_cast<int*>(&v);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(V) / 4); ++k)
    x[k] = __shfl_up_sync(FULL, x[k], d);
  return v;
}

// The thread's exclusive prefix of x under op, in thread order; `total`
// is the whole CTA's. Every thread of the CTA calls it.
template <int NT, class V, class Op>
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
  for (int w = 0; w < NT / 32; ++w) {
    if (w == warp) pre = all;
    all = op(all, tot[w]);
  }
  __syncthreads();
  total = all;
  return op(pre, exc);
}

// The look-back state of a chunk: a flag ((epoch << 2) | 1 once its
// summary is out, | 2 once also the state after it), the summary, the
// state after it.
constexpr int SUM_INTS = sizeof(Summary) / 4, STATE_INTS = sizeof(State) / 4;
static_assert(1 + SUM_INTS + STATE_INTS <= STATUS_INTS, "status slot");

__device__ __forceinline__ volatile int32_t* status(const Args& a,
                                                    int unit) {
  return a.scratch + HEADER_INTS + (size_t)unit * STATUS_INTS;
}

// Thread 0: publish chunk `unit`'s summary (state 1) or the state after it
// (state 2): the ints, a fence, the flag.
template <class V>
__device__ __forceinline__ void publish(const Args& a, int unit, const V& v,
                                        uint32_t epoch, int state) {
  volatile int32_t* p = status(a, unit);
  const int* x = reinterpret_cast<const int*>(&v);
  const int at = state == 2 ? 1 + SUM_INTS : 1;
#pragma unroll
  for (int k = 0; k < (int)(sizeof(V) / 4); ++k) p[at + k] = x[k];
  __threadfence();
  p[0] = (int32_t)(epoch << 2 | (uint32_t)state);
}

template <class V>
__device__ __forceinline__ void read(const volatile int32_t* p, V& v) {
  int* x = reinterpret_cast<int*>(&v);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(V) / 4); ++k) x[k] = p[k];
}

// The first warp: the state before chunk c of the pair (unit - c is its
// chunk 0). Lane l reads chunk k - l, 32 at a time going back, until a
// chunk has its state out (or the pair's start is reached); the summaries
// of the chunks after that one (each read by the lane that saw its flag,
// into shared memory) are then applied in order, by every lane alike.
__device__ State look_back(const Args& a, int unit, int c, uint32_t epoch,
                           Summary* sums, State* found) {
  const int lane = threadIdx.x & 31;
  int from = -1;   // the chunk whose state starts the fold, or the start
  for (int k = c - 1;; k -= 32) {
    const int j = k - lane;
    bool incl = j < 0;
    if (j >= 0) {
      const volatile int32_t* p = status(a, unit - (c - j));
      uint32_t fl;
      long long spins = 0;
      do {
        fl = (uint32_t)p[0];
        // A chunk publishes its summary without waiting on any other, so
        // within microseconds; seconds of waiting mean a broken protocol:
        // stop with an error rather than hang the card.
        if (++spins > (1ll << 24)) __trap();
      } while ((fl >> 2) != epoch || !(fl & 3u));
      __threadfence();
      incl = (fl & 3u) == 2u;
      read(p + 1, sums[j]);
      if (incl) read(p + 1 + SUM_INTS, found[lane]);
    }
    const unsigned m = __ballot_sync(FULL, incl);
    if (m) {
      const int l = __ffs(m) - 1;
      from = k - l;
      __syncwarp();
      State X = from >= 0 ? found[l] : State{Fwd{0, -1, 0, -1, -1},
                                              Start{-1, 0}, Sums{0, 0, 0}};
      Seg out[2];
      int nout;
      for (int q = from + 1; q < c; ++q)
        X = apply_summary(sums[q], X, a.mqd, a.reg, out, nout);
      return X;
    }
  }
}

// ---- segments ---------------------------------------------------------------

// Bit p: any bit of z in [p - w + 1, p] (1 <= w <= 32), by doubling.
__device__ __forceinline__ uint32_t window_or(uint32_t z, int w) {
  uint32_t r = 0, x = z;
  int off = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    if ((w >> k) & 1) {
      r |= off < 32 ? x << off : 0u;
      off += 1 << k;
    }
    if (k < 5) x |= x << (1 << k);
  }
  return r;
}

// The anchored matches with a break since the one before them (at or
// before their own position), inside one word: a carry from each break at
// a position that is no anchored match runs up to the next anchored match
// (~ma + x).
__device__ __forceinline__ uint32_t crossed_of(uint32_t ma, uint32_t brk) {
  return ((~ma + (brk & ~ma)) | brk) & ma;
}

// The segment starts of a word (positions base .. base + 31): an anchored
// match with none in the mqd + 1 positions before it, or with a break
// since the one before it. Inside the word the one before is the next
// lower bit; the word's first anchored match looks at F, the forward state
// before the word. At mqd + 1 >= 32 only the first can start by distance.
__device__ __forceinline__ uint32_t starts_of(uint32_t ma, uint32_t brk,
                                              const Fwd& F, int base,
                                              int mqd) {
  if (!ma) return 0;
  const uint32_t anyb = window_or(ma << 1, min(mqd + 1, 32));
  const uint32_t crossed = crossed_of(ma, brk);
  const uint32_t low = ma & (0u - ma);
  const int i0 = base + __ffs(ma) - 1;
  const bool first = F.ma < 0 || F.ma < i0 - mqd - 1 || F.b > F.ma ||
                     (crossed & low);
  return (ma & (~anyb | crossed) & ~low) | (first ? low : 0u);
}

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

// The walk over a thread's determined starts in order: each closes the
// segment before it, at the last anchored match below it; the chunk's
// first one (no start before it in the chunk: p1) closes nothing, and
// WRITE = false puts it in p1 = (p1, e1, cma1, la1). F and S: the forward
// state and the last start before the thread's first word, from the
// chunk's own words. WRITE = false counts and sums; WRITE = true writes
// the records from index idx.
template <bool WRITE>
__device__ __forceinline__ void walk(const Args& a, int n, int w0,
                                     const uint32_t (&m)[WPT],
                                     const uint32_t (&ma)[WPT],
                                     const uint32_t (&anc)[WPT],
                                     const uint32_t (&sb)[WPT],
                                     const Fwd (&wf)[WPT], Fwd F, Start S,
                                     int idx, Sums& sums, int4* p1) {
  // p1 may be shared memory: only the thread holding the chunk's first
  // determined start writes it.
#pragma unroll
  for (int o = 0; o < WPT; ++o) {
    const int base = 32 * (w0 + o);
    for (uint32_t x = sb[o]; x; x &= x - 1) {
      const int p = __ffs(x) - 1;
      const uint32_t mb = ma[o] & below(p);
      int e = F.ma, cma = F.cma;
      if (mb) {
        const int q = last_bit(mb);
        e = base + q;
        cma = F.cm + __popc(m[o] & upto(q));
      }
      const uint32_t ab = anc[o] & below(p);
      const int la = ab ? base + last_bit(ab) : F.an;
      if (S.s >= 0)
        close_segment(a, n, S.s, e, cma - S.cms, la, WRITE, idx, sums);
      else if (!WRITE)
        *p1 = make_int4(base + p, e, cma, la);
      S.s = base + p;
      S.cms = F.cm + __popc(m[o] & below(p));
    }
    F = FwdOp()(F, wf[o]);
  }
}

// NT threads a CTA, a chunk of NT * WPT words; at most 64 registers a
// thread.
template <int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
back_half_kernel(Args a) {
  constexpr int CW = NT * WPT;
  constexpr int MAXC = NT == 256 ? MAX_CHUNKS : 1;   // chunks a pair
  __shared__ uint32_t mw[CW + 2 * HALO];   // refined flags, chunk + halo
  __shared__ uint32_t bw[CW];              // breaks
  __shared__ Fwd tot1[NT / 32];
  __shared__ Start tot2[NT / 32];
  __shared__ Sums tot3[NT / 32];
  __shared__ Summary sums[MAXC];           // the look-back's summaries
  __shared__ State found[32], before, after;
  __shared__ int4 s_first, s_p1;           // (i0, cms0, x0), (p1, e1, ...)
  __shared__ Seg first[2];
  __shared__ int info[3];
  const int tid = threadIdx.x;
  const bool records = a.recs != nullptr;
  const Fwd ident1{0, -1, 0, -1, -1};
  const Start ident2{-1, 0};
  const Sums ident3{0, 0, 0};
  if (tid == 0) {
    info[0] = (int)atomicInc(reinterpret_cast<unsigned*>(a.scratch),
                             (unsigned)a.units - 1u);
    info[1] = *reinterpret_cast<volatile int32_t*>(a.scratch + 2);
    s_first = make_int4(-1, 0, 0, 0);
    s_p1 = make_int4(-1, 0, 0, -1);
  }
  __syncthreads();
  const int unit = info[0];
  const uint32_t epoch = (uint32_t)info[1];
  const int n = unit / a.chunks, c = unit % a.chunks, c0 = c * CW;

  // The chunk's words and 3 on each side: window index k is word
  // c0 - HALO + k. Two rounds of NT words, their loads all issued first,
  // then the 2 * HALO words left.
  {
    BlockRaw raw[2];
    bool has[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = tid + r * NT, f = c0 - HALO + k;
      const bool own = k >= HALO && k < CW + HALO;
      has[r] = f >= 0 && f < a.NBF;
      if (has[r]) raw[r] = load_block(a, (size_t)n * a.NBF + f, own);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = tid + r * NT, f = c0 - HALO + k;
      uint32_t m = 0, b = 0;
      if (has[r]) block_word(raw[r], f, a.mrd, m, b);
      mw[k] = m;
      if (k >= HALO && k < CW + HALO) bw[k - HALO] = b;
    }
    const int k = tid + 2 * NT, f = c0 - HALO + k;
    if (k < CW + 2 * HALO) {
      const bool own = k < CW + HALO;
      uint32_t m = 0, b = 0;
      if (f >= 0 && f < a.NBF)
        block_word(load_block(a, (size_t)n * a.NBF + f, own), f, a.mrd, m,
                   b);
      mw[k] = m;
      if (own) bw[k - HALO] = b;
    }
  }
  __syncthreads();

  // This thread's words w0 .. w0 + WPT - 1, from flags of words w0 - 3 ..
  // w0 + WPT + 2 (index i of the window is word w0 - 3 + i).
  const int w0 = c0 + tid * WPT;
  uint32_t mwin[WPT + 6], st7[WPT + 5], ir7[WPT + 5], wb[WPT + 3],
      wfw[WPT + 4], de[WPT + 4];
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
    wfw[i] = any_fwd32(ir7[i], ir7[i + 1]);
    de[i] = dense_ends(mwin[i - 1], mwin[i]);
  }
  uint32_t m[WPT], ma[WPT], anc[WPT], brk[WPT], sb[WPT];
  Fwd wf[WPT];
  Fwd agg1 = ident1;
#pragma unroll
  for (int o = 0; o < WPT; ++o) {
    const int i = o + 3;
    const uint32_t near = wb[i] | behind(wb[i - 1], wb[i], AW - 31) |
                          wfw[i] | ahead(wfw[i], wfw[i + 1], AW - 31);
    const uint32_t dense = any_fwd15(de[i], de[i + 1]);
    m[o] = mwin[i];
    ma[o] = m[o] & near & (dense | ir7[i]);
    anc[o] = in_runs<MAL>(run_starts<MAL>(mwin[i - 1], mwin[i]),
                          run_starts<MAL>(mwin[i], mwin[i + 1]));
    brk[o] = bw[tid * WPT + o];
    const int base = 32 * (w0 + o);
    wf[o] = Fwd{__popc(m[o]), -1, 0, -1, -1};
    if (ma[o]) {
      const int p = last_bit(ma[o]);
      wf[o].ma = base + p;
      wf[o].cma = __popc(m[o] & upto(p));
    }
    if (brk[o]) wf[o].b = base + last_bit(brk[o]);
    if (anc[o]) wf[o].an = base + last_bit(anc[o]);
    agg1 = FwdOp()(agg1, wf[o]);
  }

  // The chunk's summary, from its own words: the forward scan; the starts
  // a word at a time, all but the chunk's first anchored match's; the
  // segments they close.
  Fwd all1;
  const Fwd f1 = block_scan<NT>(agg1, FwdOp(), ident1, tot1, all1);
  Start agg2 = ident2;
  {
    Fwd F = f1;
#pragma unroll
    for (int o = 0; o < WPT; ++o) {
      const int base = 32 * (w0 + o);
      sb[o] = starts_of(ma[o], brk[o], F, base, a.mqd);
      if (ma[o] && F.ma < 0) {   // the chunk's first anchored match
        const uint32_t low = ma[o] & (0u - ma[o]);
        const int p = __ffs(ma[o]) - 1;
        s_first = make_int4(
            base + p, F.cm + __popc(m[o] & below(p)),
            F.b >= 0 || (crossed_of(ma[o], brk[o]) & low), 0);
        sb[o] &= ~low;
      }
      if (sb[o]) {
        const int p = last_bit(sb[o]);
        agg2 = Start{base + p, F.cm + __popc(m[o] & below(p))};
      }
      F = FwdOp()(F, wf[o]);
    }
  }
  Start all2;
  const Start f2 = block_scan<NT>(agg2, StartOp(), ident2, tot2, all2);
  Sums mine = ident3;
  walk<false>(a, n, w0, m, ma, anc, sb, wf, f1, f2, 0, mine, &s_p1);
  Sums all3;
  const Sums pre3 = block_scan<NT>(mine, SumsOp(), ident3, tot3, all3);

  // One look-back: the state before the chunk; the state after it, and the
  // segments its first starts close.
  if (tid < 32) {
    const bool later = c + 1 < a.chunks;
    const Summary sm{all1,       s_first.x, s_first.y, s_first.z, all2,
                     s_p1.x,     s_p1.y,    s_p1.z,    s_p1.w,    all3};
    if (later && tid == 0) publish(a, unit, sm, epoch, 1);
    const State X = c > 0 ? look_back(a, unit, c, epoch, sums, found)
                          : State{ident1, ident2, ident3};
    Seg out[2];
    int nout;
    const State Y = apply_summary(sm, X, a.mqd, a.reg, out, nout);
    if (tid == 0) {
      if (later) publish(a, unit, Y, epoch, 2);
      before = X;
      after = Y;
      first[0] = out[0];
      first[1] = out[1];
      info[2] = nout;
    }
  }
  __syncthreads();

  // Records: the first starts' segments, then the thread's, after every
  // accepted segment before them.
  if (records) {
    if (tid < info[2])
      write_record(a, n, before.C.n + tid, first[tid].s, first[tid].e,
                   first[tid].nt);
    if (mine.n) {
      Sums dummy = ident3;
      walk<true>(a, n, w0, m, ma, anc, sb, wf, f1, f2,
                 before.C.n + info[2] + pre3.n, dummy, nullptr);
    }
  }

  // The pair's last chunk: its last segment ends at the last anchored
  // match; the aggregates; the record rows past the last, -1.
  if (c == a.chunks - 1) {
    if (tid == 0) {
      Sums tot = after.C;
      int idx = tot.n;
      if (after.S.s >= 0)
        close_segment(a, n, after.S.s, after.F.ma,
                      after.F.cma - after.S.cms, after.F.an, records, idx,
                      tot);
      a.agg[(size_t)n * 3] = tot.n;
      a.agg[(size_t)n * 3 + 1] = tot.match;
      a.agg[(size_t)n * 3 + 2] = tot.len;
      a.nrec[n] = tot.n;
      info[0] = min(tot.n, a.maxseg);
    }
    __syncthreads();
    if (records) {
      const int r0 = info[0];
      int32_t* out = a.recs + ((size_t)n * a.maxseg + r0) * 6;
      for (int k = tid; k < (a.maxseg - r0) * 6; k += NT) out[k] = -1;
    }
  }

  // The launch's last CTA to finish moves the epoch on (every CTA has read
  // it by then) for the next launch on this scratch.
  if (tid == 0) {
    __threadfence();
    const unsigned done = atomicInc(
        reinterpret_cast<unsigned*>(a.scratch + 1), (unsigned)a.units - 1u);
    if (done == (unsigned)a.units - 1u)
      *reinterpret_cast<volatile int32_t*>(a.scratch + 2) =
          (int32_t)((epoch + 1) & EPOCH_MASK);
  }
}

// Threads a CTA for pairs of NBF words (a chunk is twice as many words):
// as few as leave no thread idle on a short pair, at most 256. On an H100
// CTAs of 1,024 threads (one chunk a pair at bucket 65,536) ran slower:
// one CTA an SM, whose waits no other CTA fills.
int chunk_threads(int NBF) {
  int nt = 64;
  while (nt < 256 && nt * WPT < NBF) nt *= 2;
  return nt;
}

}  // namespace

extern "C" {

// The scratch ints k4_back_half needs for N pairs of Lq positions, or -1
// past an int's range.
int k4_scratch_ints(int N, int Lq) {
  const int NBF = Lq / 32, cw = chunk_threads(NBF) * WPT;
  const long long ints =
      HEADER_INTS + (long long)N * ((NBF + cw - 1) / cw) * STATUS_INTS;
  return N < 1 || Lq < 32 || ints > 0x7fffffff ? -1 : (int)ints;
}

// K4. m1, m0: (N, Lq) bool, 16-byte aligned; sw, A, S, Ap, Sp: (N, Lq/32)
// bool; D, Dp: (N, Lq/32) int32; rlen: (N,) int32; agg: (N, 3) int32; recs:
// (N, maxseg, 6) int32 (rows past the last record are set to -1), or null
// for no records; nrec: (N,) int32; scratch: `scratch_ints` int32, at
// least k4_scratch_ints(N, Lq), zeroed before its first launch and then
// used by one stream only. mqd >= 0. Returns cudaGetLastError().
int k4_back_half(const uint8_t* m1, const uint8_t* m0, const uint8_t* sw,
                 const uint8_t* A, const uint8_t* S, const int32_t* D,
                 const uint8_t* Ap, const uint8_t* Sp, const int32_t* Dp,
                 const int32_t* rlen, int N, int Lq, int mqd, int mrd,
                 int reg, int maxseg, int32_t* agg, int32_t* recs,
                 int32_t* nrec, int32_t* scratch, int scratch_ints,
                 void* stream) {
  const int need = k4_scratch_ints(N, Lq);
  if (N < 1 || Lq < 32 || Lq % 32 || mqd < 0 || (recs && maxseg < 1) ||
      need < 0 || scratch_ints < need)
    return (int)cudaErrorInvalidValue;
  const int NBF = Lq / 32, nt = chunk_threads(NBF), cw = nt * WPT;
  const int chunks = (NBF + cw - 1) / cw;
  if (chunks > MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  const Args a{m1, m0, sw, A, S, D, Ap, Sp, Dp, rlen, NBF, chunks,
               N * chunks, mqd, mrd, reg, maxseg, agg, recs, nrec, scratch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
#define K4_CASE(t)                                    \
  case t:                                             \
    back_half_kernel<t><<<N * chunks, t, 0, s>>>(a); \
    break;
    K4_CASE(64) K4_CASE(128) K4_CASE(256)
#undef K4_CASE
  }
  return (int)cudaGetLastError();
}

const char* vk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
