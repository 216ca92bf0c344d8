"""Models, in numpy, of how the kernels of csrc/index.cu build the align
engine's two arenas, held against the plain versions on the CPU.

K9 (`index_v3_kernel`): a warp takes a coarse block of WQ positions of a
genome; lane l holds the hashes of positions 32 f + l (f < WQ / 32), its
k-mer's later codes read from the lanes after it (shuffles of this block
of 32 and the next). The warp owns an H-byte row of shared memory, zero
between rows: the lanes set the bytes of a row's hashes, the warp copies
the row out in lane-owned 16-byte chunks (lane l: chunks l, l + 32, ...)
and the lanes clear their bytes again. The FPB hashes of a lane give the
FPB reference-block rows (rocc) and the two query half-block rows (qocc):
at WQ = 128 each half's 64 hashes give its qocc row and two rocc rows,
and the qocc row is the OR of those two. The wide rows are 16-byte chunks
of the codes or of pads. `k9_model` starts from poisoned arrays, so every
byte of the arena must be written.

K10 (`index_v2_select`, `index_v2_pass`, `index_v2_pack`): the (genome,
strand) rows go a group at a time through one state. The selection: a
warp takes a fine block, lane l offset l; a bitonic network over the warp
sorts the keys hash << 5 | l and lane r < C takes the r-th; a CTA of
blocks counts both passes' digits of its valid slots and adds them to
the row's totals once a digit, each total tagged with the epoch of the
group's first pass (`counts_model`: CTAs in a random order, stale words
replaced). The valid slots' items (value << 16 | position, 4 bytes, up to
bucket 65,536; value << 40 | position + 1 << 20 above) are then sorted by
value, stably, by LSD radix passes of 8-bit digits (two at k = 8, one at
k = 4), a CTA a (row, tile of W x I x 32 items): W warps of I rounds of
32 items in order, each item ranked among its round's lanes of one digit
(its digit peers, by ballots) and after the warp's earlier rounds (a
per-warp digit count), the tile's items staged by digit in that order
(`rank_tiles`);
each digit's count in the tile published, the tiles before found by a
decoupled look-back (`look_back`: units started in a seeded random order
and advanced a random half of their digits at a time, words of older
epochs passed over), and the staging stored in runs (`pass_model`, every
place written once); then sv, pk1 and pk2 from the sorted items. The
state starts with stale words, as one that other shapes used. Mutation
checks: a look-back that takes an aggregate for an inclusive prefix or
ignores epochs, and an unstable staging, must fail.

No JAX here (tests/test_torch_index.py holds the plain versions against
the JAX package); every output is an integer, so the tolerance is 0.
"""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, '.')

from index_cases import index_genomes, padded  # noqa: E402
from vclust_tpu_torch.ops import align_gpu as ag  # noqa: E402

torch.set_num_threads(1)

FINE = 32
BIG = ag.BIG
MUL = 2654435761
NONE = np.uint64(2 ** 64 - 1)
NONE32 = np.uint64(2 ** 32 - 1)
POISON = 0x55
LANE = np.arange(32)


def kmer_value(cur, nxt, k):
    """The k-mer value at each lane's position (-1 where a code is >= 4):
    cur and nxt (..., 32) are the codes of its block and of the next, the
    code j after the lane read from lane (l + j) & 31 of one of them."""
    v = np.zeros(cur.shape, np.int64)
    bad = np.zeros(cur.shape, bool)
    for j in range(k):
        src = LANE + j
        c = np.where(src < 32, cur[..., src & 31], nxt[..., src & 31])
        bad |= c >= 4
        v = (v << 2) | (c & 3)
    return np.where(bad, -1, v)


def blocks_of(codes):
    """(G, Lp) codes as (G, Lp / 32 + 1, 32): the blocks of 32 and one
    block of pads past the end (a lane's `nxt` past the bucket)."""
    G, Lp = codes.shape
    ext = np.concatenate([codes, np.full((G, FINE), 4, codes.dtype)], 1)
    return ext.astype(np.int64).reshape(G, Lp // FINE + 1, FINE)


def canon_bucket(v, ck, H):
    """`_canon_hash` in uint32 arithmetic, H - 1 where v < 0."""
    rc = np.zeros_like(v)
    t = v.copy()
    for _ in range(ck):
        rc = (rc << 2) | ((t & 3) ^ 3)
        t >>= 2
    vc = np.minimum(v, rc) & 0xFFFFFFFF
    h = ((vc * MUL) & 0xFFFFFFFF) >> (32 - int(np.log2(H)))
    return np.where(v >= 0, h, H - 1)


def k9_model(fwd, rc, k, ck, H, WQ, ROWW):
    """K9's arena from poisoned arrays: qocc, rocc, roww_f, roww_r."""
    G, Lp = fwd.shape
    FPB, NQB, NRB, RC = WQ // FINE, Lp // WQ, Lp // FINE, ROWW // 16
    qocc = np.full((G, 2 * NQB, H), POISON, np.int8)
    rocc = np.full((G, NRB, H), POISON, np.int8)
    roww = [np.full((G, NRB, ROWW), POISON, np.int8) for _ in range(2)]
    blk = blocks_of(fwd)
    # Every (genome, coarse block) task at once: t = g * NQB + q.
    T = G * NQB
    tg, tq = np.divmod(np.arange(T), NQB)
    hs = np.stack([canon_bucket(kmer_value(
        blk[tg, tq * FPB + f], blk[tg, tq * FPB + f + 1], k), ck, H)
        for f in range(FPB)], axis=1)                     # (T, FPB, 32)
    row = np.zeros((T, H), np.int8)                       # each warp's row
    owner = np.arange(H // 16) % 32                       # chunk -> lane
    t_ix = np.arange(T)[:, None]

    def copy_out(dst_rows):
        for lane in range(32):
            mine = np.flatnonzero(owner == lane)
            for c in mine:
                dst_rows[:, 16 * c:16 * c + 16] = row[:, 16 * c:16 * c + 16]

    for f in range(FPB):
        row[t_ix, hs[:, f]] = 1
        out = np.empty((T, H), np.int8)
        copy_out(out)
        rocc[tg, tq * FPB + f] = out
        row[t_ix, hs[:, f]] = 0
    for half in range(2):
        for f in range(FPB):
            lanes = LANE[(32 * f + LANE >= WQ // 2) == (half == 1)]
            row[t_ix, hs[:, f, lanes]] = 1
        out = np.empty((T, H), np.int8)
        copy_out(out)
        qocc[tg, 2 * tq + half] = out
        for f in range(FPB):
            lanes = LANE[(32 * f + LANE >= WQ // 2) == (half == 1)]
            row[t_ix, hs[:, f, lanes]] = 0
    assert not row.any()            # every row left clear for the next
    if WQ == 128:                   # three rows from 64 hashes
        for half in range(2):
            both = rocc[tg, tq * FPB + 2 * half] | \
                rocc[tg, tq * FPB + 2 * half + 1]
            assert np.array_equal(qocc[tg, 2 * tq + half], both)
    pad = np.full(16, 4, np.int8)
    for s, src in enumerate((fwd, rc)):
        for lane in range(32):
            for c in range(lane, FPB * RC, 32):
                f, m = divmod(c, RC)
                for t in range(T):
                    r = tq[t] * FPB + f
                    idx = 32 * r + 16 * m - (WQ + 32)
                    assert idx % 16 == 0
                    roww[s][tg[t], r, 16 * m:16 * m + 16] = (
                        src[tg[t], idx:idx + 16] if 0 <= idx < Lp else pad)
    return qocc, rocc, roww[0], roww[1]


def bitonic(keys):
    """keys (..., 32) sorted over the last axis by the warp's bitonic
    network: at each step lane l keeps the min or the max of its key and
    lane l ^ stride's."""
    key = keys.copy()
    size = 2
    while size <= 32:
        stride = size // 2
        while stride:
            other = key[..., LANE ^ stride]
            keep_min = ((LANE & stride) == 0) == ((LANE & size) == 0)
            key = np.where(keep_min, np.minimum(key, other),
                           np.maximum(key, other))
            stride //= 2
        size *= 2
    return key


KBAD = 1 << 31


def kmer_doubling(cur, nxt, k):
    """K10's k-mer values (-1 where a code is >= 4), by doubling: the
    values of windows of 1, 2, 4 codes at each lane's position (lo) and 32
    on (hi), a window twice as long joined from one and the window w
    positions on (lane l reads lane (l + w) & 31: its lo, or, for l + w >=
    32, its hi); then k's binary digits joined from the longest. A code >=
    4 sets KBAD. Only the hi values the later reads take are exact."""
    def join(a, b, w):
        return ((a | b) & KBAD) | ((a & ~KBAD) << 2 * w) | (b & ~KBAD)

    def at(lo, hi, off):
        src = (LANE + off) & 31
        return np.where(LANE + off < 32, lo[..., src], hi[..., src])

    top = k.bit_length() - 1
    lo = [np.where(cur >= 4, KBAD, cur)]
    hi = [np.where(nxt >= 4, KBAD, nxt)]
    for i in range(1, top + 1):
        w = 1 << (i - 1)
        lo.append(join(lo[i - 1], at(lo[i - 1], hi[i - 1], w), w))
        if i < top:
            hi.append(join(hi[i - 1], hi[i - 1][..., (LANE + w) & 31], w))
    v, off = lo[top], 1 << top
    for i in range(top - 1, -1, -1):
        if k >> i & 1:
            v = join(v, at(lo[i], hi[i], off), 1 << i)
            off += 1 << i
    return np.where(v & KBAD, -1, v)


def select_model(codes, k, C):
    """The selection of every fine block (G, NBF) at once: values, hashes,
    the warp's bitonic sort of h << 5 | lane, lane r < C taking the r-th:
    each slot's value (-1 where invalid) and offset in its block."""
    G, Lp = codes.shape
    NBF = Lp // FINE
    blk = blocks_of(codes)
    v = kmer_doubling(blk[:, :NBF], blk[:, 1:], k)        # (G, NBF, 32)
    h = np.where(v >= 0, ((v & 0xFFFFFFFF) * MUL & 0xFFFFFFFF) >> 16, 65536)
    key = bitonic((h << 5) | LANE)
    assert np.array_equal(key, np.sort((h << 5) | LANE, axis=-1))
    off = key[..., :C] & 31
    vv = np.take_along_axis(v, off, axis=-1)              # (G, NBF, C)
    return vv.reshape(G, NBF * C), off.reshape(G, NBF * C)


def layout(wide):
    """K10's items: (value shift, the invalid slot's item). 8 bytes, value
    << 40 | position + 1 << 20; or, at buckets up to 65,536, 4 bytes,
    value << 16 | position."""
    return (40, NONE) if wide else (16, NONE32)


def make_items(sel_v, sel_o, C, wide):
    """The items of the selected slots in slot order."""
    NQ = sel_v.shape[1]
    pos = (FINE * (np.arange(NQ) // C))[None, :] + sel_o
    v = np.maximum(sel_v, 0).astype(np.uint64)
    vs, none = layout(wide)
    it = (v << np.uint64(40)) | ((pos + 1).astype(np.uint64) << np.uint64(
        20)) if wide else (v << np.uint64(16)) | pos.astype(np.uint64)
    items = np.where(sel_v >= 0, it, none)
    assert not (items[sel_v >= 0] == none).any()   # no valid item is NONE
    return items


def digit(items, p, vs):
    return ((items >> np.uint64(vs + 8 * p)) & np.uint64(255)).astype(
        np.int64)


def counts_model(sel_v, C, passes, sel_blocks, st, rng):
    """The selection launch's counts: a CTA a chunk of `sel_blocks` fine
    blocks of one row histograms both passes' digits of its valid slots
    in shared memory, then adds each nonzero count to the row's total, a
    word tagged with the epoch of the group's first pass (st.now): a word
    of another tag (an earlier group's, or stale) is replaced, one of this
    tag added to; the CTAs in a seeded random order. Returns the number of
    global adds (one a CTA, pass and digit at most)."""
    R, NQ = sel_v.shape
    per = sel_blocks * C
    adds = 0
    rows = np.arange(R)[:, None]
    for c0 in rng.permutation(np.arange(0, NQ, per)):
        v = sel_v[:, c0:c0 + per]
        for p in range(passes):
            h = np.zeros((R, 257), np.int64)
            np.add.at(h, (rows, np.where(v >= 0, (v >> 8 * p) & 255, 256)),
                      1)
            h = h[:, :256]
            adds += int((h > 0).sum())
            tag, tot = st.tag[p, :R], st.total[p, :R]
            fresh = (h > 0) & (tag != st.now)
            tot[fresh] = 0
            tag[fresh] = st.now
            tot += h
    return adds


def rank_tiles(src, n, p, vs, none, warps, ipt, bug):
    """Each tile's ranking: W warps of I rounds of 32 items in order, an
    item ranked among its round's lanes of one digit (its digit peers)
    and after the warp's earlier rounds (a per-warp digit count); the
    tile's digit counts (its aggregate), the warps' offsets in each digit
    and each valid item's place in the tile's staging (a stable counting
    sort by digit; bug 'unstable_staging' reverses each digit's run).
    Returns the items (R, tiles, tile), the aggregates (R, tiles, 256),
    the staging places and each digit's first place in the staging."""
    R, NQ = src.shape
    tile = warps * ipt * 32
    tiles = -(-NQ // tile)
    idx = np.arange(tiles * tile).reshape(tiles, warps, ipt, 32)
    inside = idx[None] < n[:, None, None, None, None]
    it = np.where(inside, src[:, np.minimum(idx, NQ - 1)], none)
    ok = it != none
    dg = np.where(ok, digit(it, p, vs), 256)
    whist = np.zeros((R, tiles, warps, 257), np.int64)
    rk = np.zeros(dg.shape, np.int64)
    lower = LANE[None, :] < LANE[:, None]                 # [l, l'] l' < l
    ri, ti = np.meshgrid(np.arange(R), np.arange(tiles), indexing='ij')
    ri, ti = ri[..., None], ti[..., None]
    for w in range(warps):
        for j in range(ipt):
            d = dg[:, :, w, j]                            # (R, tiles, 32)
            same = d[..., :, None] == d[..., None, :]
            rk[:, :, w, j] = whist[ri, ti, w, d] + (same & lower).sum(-1)
            lead = np.argmax(same, axis=-1) == LANE       # lowest peer
            r, t, l = np.nonzero(lead & ok[:, :, w, j])
            np.add.at(whist, (r, t, w, d[r, t, l]), same.sum(-1)[r, t, l])
    wh = whist[..., :256]
    agg = wh.sum(2)                                       # (R, tiles, 256)
    woff = np.cumsum(wh, axis=2) - wh
    lstart = np.cumsum(agg, -1) - agg
    dd = np.minimum(dg, 255)
    r5 = np.arange(R)[:, None, None, None, None]
    t5 = np.arange(tiles)[None, :, None, None, None]
    w5 = np.arange(warps)[None, None, :, None, None]
    first = lstart[r5, t5, dd]
    at = first + woff[r5, t5, w5, dd] + rk
    if bug == 'unstable_staging':
        at = 2 * first + agg[r5, t5, dd] - 1 - at
    at = np.where(ok, at, -1).reshape(R, tiles, tile)
    return it.reshape(R, tiles, tile), agg, at, lstart


class Status:
    """K10's state: the look-back words, a (row, tile, digit) each:
    (epoch, flag, count), flag 1 an aggregate, 2 an inclusive prefix; the
    digit totals, a (pass, row, digit) each: (tag, count). They start as
    stale words of older epochs (a state that earlier launches used) and
    live on through the passes and groups of a call."""

    def __init__(self, rows, tiles, rng):
        shape = (rows, tiles, 256)
        self.epoch = rng.integers(0, 3, shape)
        self.flag = rng.integers(0, 3, shape)
        self.val = rng.integers(0, 1 << 20, shape)
        self.tag = rng.integers(0, 3, (2, rows, 256))
        self.total = rng.integers(0, 1 << 20, (2, rows, 256))
        self.now = 3            # the next launch's epoch

    def totals(self, p, nr):
        """Pass p's totals of the group's nr rows: 0 where no CTA of the
        group counted the digit (a stale tag)."""
        return np.where(self.tag[p, :nr] == self.now - p,
                        self.total[p, :nr], 0)

    def publish(self, r, t, D, flag, val):
        self.epoch[r, t, D] = self.now
        self.flag[r, t, D] = flag
        self.val[r, t, D] = val


def look_back(agg, live, st, rng, bug, stats):
    """One pass launch's decoupled look-back. Units (row, tile) start in a
    seeded random order; at each step a started unit advances a random
    half of its digits: a digit not yet out publishes its aggregate (tile
    0 its inclusive prefix), a digit out as an aggregate walks back over
    the row's earlier tiles, adding their words (spinning, here: trying
    again later, where a word is not of this launch's epoch) up to one
    with an inclusive prefix, then publishes its own. Returns each unit's
    exclusive prefix a digit. bug 'agg_as_incl' stops at any word of this
    epoch, 'no_epoch' takes words of any epoch."""
    R, tiles, _ = agg.shape
    units = [(r, t) for r in range(R) for t in range(tiles) if live[r, t]]
    order = [units[i] for i in rng.permutation(len(units))]
    state = np.zeros((R, tiles, 256), np.int8)
    excl = np.zeros((R, tiles, 256), np.int64)
    started = []
    while True:
        pending = [u for u in started if (state[u] < 2).any()]
        if not pending and len(started) == len(order):
            break
        if len(started) < len(order) and (not pending or rng.random() < .3):
            started.append(order[len(started)])
            continue
        r, t = pending[rng.integers(len(pending))]
        D = np.flatnonzero((state[r, t] < 2) & (rng.random(256) < 0.5))
        new, walk = D[state[r, t, D] == 0], D[state[r, t, D] == 1]
        st.publish(r, t, new, 2 if t == 0 else 1, agg[r, t, new])
        state[r, t, new] = 2 if t == 0 else 1
        acc = np.zeros(len(walk), np.int64)
        active = np.ones(len(walk), bool)
        done = active.copy()
        for tt in range(t - 1, -1, -1):
            ep, fl = st.epoch[r, tt, walk], st.flag[r, tt, walk]
            ready = fl > 0
            if bug != 'no_epoch':
                stats['stale'] += int((active & ready & (ep != st.now)).sum())
                ready &= ep == st.now
            done &= ~(active & ~ready)
            take = active & ready
            acc += np.where(take, st.val[r, tt, walk], 0)
            stats['agg_reads'] += int((take & (fl == 1)).sum())
            active = take & (fl != 2) & (bug != 'agg_as_incl')
            if not active.any():
                break
        stats['waits'] += int((~done).sum())
        walk, acc = walk[done], acc[done]
        st.publish(r, t, walk, 2, acc + agg[r, t, walk])
        excl[r, t, walk] = acc
        state[r, t, walk] = 2
    st.now += 1
    return excl


def pass_model(src, n, totals, p, vs, none, warps, ipt, st, rng, bug,
               stats):
    """One radix pass, a CTA a (row, tile): the tile ranked and staged by
    digit (rank_tiles), its offsets by the look-back, then its staging
    stored in runs: thread i stores staged item i at the digit's first
    place in the row (its base from the totals, plus the tiles before)
    plus i less the digit's first place in the staging. Returns dst (each
    place written once)."""
    R, NQ = src.shape
    items, agg, at, lstart = rank_tiles(src, n, p, vs, none, warps, ipt,
                                        bug)
    tiles = agg.shape[1]
    tile = warps * ipt * 32
    live = np.arange(tiles)[None, :] * tile < n[:, None]
    excl = look_back(agg, live, st, rng, bug, stats)
    dbase = np.cumsum(totals, -1) - totals                # (R, 256)
    gofs = dbase[:, None, :] + excl - lstart              # (R, tiles, 256)
    dst = np.full((R, NQ), 9, np.uint64)
    hits = np.zeros((R, NQ), np.int64)
    for r, t in zip(*np.nonzero(live)):
        ok = at[r, t] >= 0
        staged = np.empty(int(ok.sum()), np.uint64)
        staged[at[r, t, ok]] = items[r, t, ok]
        i = np.arange(len(staged))
        place = gofs[r, t, digit(staged, p, vs)] + i
        dst[r, place] = staged
        np.add.at(hits, (r, place), 1)
    placed = np.arange(NQ)[None, :] < totals.sum(-1)[:, None]
    assert (hits[placed] == 1).all() and (hits[~placed] == 0).all()
    return dst


def pack_model(sorted_items, count, pack_bits, wide):
    """sv, pk1 and pk2 of rows from their sorted items: the previous
    position where the entry before holds the same value."""
    vs, _ = layout(wide)
    R, NQ = sorted_items.shape
    i = np.arange(NQ)[None, :]
    ok = i < count[:, None]
    it = np.where(ok, sorted_items, np.uint64(0)).astype(np.int64)
    v = it >> vs
    pos1 = (it >> 20) & 0xFFFFF if wide else (it & 0xFFFF) + 1
    prev_v = np.concatenate([np.full((R, 1), -1), v[:, :-1]], 1)
    prev_p = np.concatenate([np.zeros((R, 1), np.int64), pos1[:, :-1]], 1)
    prev1 = np.where(ok & (prev_v == v), prev_p, 0)
    sv = np.where(ok, v, BIG).astype(np.int32)
    if pack_bits == 64:
        pk1 = np.where(ok, (v << 40) | (pos1 << 20) | prev1, 0)
        return sv, pk1, pk1
    pk1 = np.where(ok, (v << 16) | pos1, 0)
    pk2 = np.where(ok & (prev1 > 0), (v << 16) | prev1, 0)
    return sv, pk1, pk2


def group_rows(G, NQ, wide):
    """The kernel's rows a group: as many as 128 MiB of items hold."""
    return int(min(2 * G, max(1, (128 << 20) // ((8 if wide else 4) * NQ))))


def k10_model(fwd, rc, k, pack_bits, C, warps=8, ipt=16, group=None,
              sel_blocks=128, wide=None, seed=0, bug=None):
    """K10's arena: qsv, qoff, per strand sv, pk1, pk2, then r2dov; and the
    run's counts (global adds of the totals, look-back words read as
    aggregates, stale words passed over, walks that waited). The 2 G rows
    (row 2 g + s) go `group` at a time through one state: the selection
    with counts, ceil(2 k / 8) passes, the packs."""
    G, Lp = fwd.shape
    NBF = Lp // FINE
    NQ = NBF * C
    wide = Lp > 65536 if wide is None else wide
    vs, none = layout(wide)
    tile = warps * ipt * 32
    passes = (2 * k + 7) // 8
    rng = np.random.default_rng(seed)
    sel = [select_model(x, k, C) for x in (fwd, rc)]
    sel_v = np.stack([sel[0][0], sel[1][0]], 1).reshape(2 * G, NQ)
    sel_o = np.stack([sel[0][1], sel[1][1]], 1).reshape(2 * G, NQ)
    group = group or group_rows(G, NQ, wide)
    st = Status(group, -(-NQ // tile), rng)
    stats = dict(agg_reads=0, stale=0, waits=0, adds=0)
    sorted_items = np.empty((2 * G, NQ), np.uint64)
    count = np.empty(2 * G, np.int64)
    for r0 in range(0, 2 * G, group):
        rs = slice(r0, min(r0 + group, 2 * G))
        nr = rs.stop - r0
        stats['adds'] += counts_model(sel_v[rs], C, passes, sel_blocks, st,
                                      rng)
        src = make_items(sel_v[rs], sel_o[rs], C, wide)
        n = np.full(nr, NQ)
        for p in range(passes):
            totals = st.totals(p, nr)
            src = pass_model(src, n, totals, p, vs, none, warps, ipt, st,
                             rng, bug, stats)
            n = totals.sum(-1)
        count[rs] = n
        sorted_items[rs] = src
    assert np.array_equal(count, (sel_v >= 0).sum(1))
    out = [sel[0][0].astype(np.int32), sel[0][1].astype(np.int32)]
    for s in range(2):
        out += pack_model(sorted_items[s::2], count[s::2], pack_bits, wide)
    pad = np.full(16, 4, np.int8)
    r2dov = np.full((G, 2 * (NBF + 1), 64), POISON, np.int8)
    for s, codes in enumerate((fwd, rc)):
        for c in range(4 * (NBF + 1)):
            r, m = divmod(c, 4)
            idx = 32 * (r - 1) + 16 * m
            r2dov[:, s * (NBF + 1) + r, 16 * m:16 * m + 16] = (
                codes[:, idx:idx + 16] if r > 0 and idx < Lp else pad)
    return tuple(out) + (r2dov,), stats


def _same(got, want, keys):
    for key, g, w in zip(keys, got, want):
        w = w.numpy()
        assert g.shape == w.shape, key
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), key


@pytest.mark.parametrize('Lp,k,H,wq', [
    (4096, 8, 2048, 128), (4096, 8, 256, 128), (4096, 4, 256, 128),
    (4096, 8, 256, 64), (4096, 4, 2048, 256), (6144, 8, 256, 96)])
def test_k9_model_matches_plain(monkeypatch, Lp, k, H, wq):
    """K9's decomposition == index_block_v3_plain: every (genome, coarse
    block) warp's hashes, its rows built in one H-byte row and copied out
    in lane-owned chunks (qocc at WQ 128 the OR of two rocc rows), the
    wide rows in 16-byte chunks; H 256 and 2,048, k 4 and 8 (the canonical
    complement over SEED_K digits, as `_canon_hash`), half-blocks of 32,
    48 (across a block of 32), 64 and 128."""
    monkeypatch.setattr(ag, 'V3_H', H)
    monkeypatch.setattr(ag, 'V3_WQ', wq)
    fwd, rc = padded(index_genomes(3, Lp), Lp)
    want = ag.index_block_v3_plain(torch.from_numpy(fwd),
                                   torch.from_numpy(rc), k, Lp)
    got = k9_model(fwd, rc, k, ag.SEED_K, H, wq,
                   ag._v3_geom(Lp, Lp)['ROWW'])
    _same(got, want, ag._V3_KEYS)
    # The all-N genome marks only bucket H - 1.
    assert (want[1][1, :, H - 1] == 1).all() and \
        not want[1][1, :, :H - 1].any()



# The kernel's tiles (8 warps x 16) and small ones (many a row), rows in
# groups; a selection CTA takes 4 x warps fine blocks (the kernel's 128).
K10_CASES = [
    (4096, 8, 16, 32, 8, 16, None), (4096, 8, 16, 32, 4, 2, 5),
    (4096, 8, 1, 32, 2, 1, None), (4096, 8, 8, 64, 3, 2, 1),
    (4096, 8, 32, 32, 8, 16, 3), (4096, 8, 32, 64, 8, 1, None),
    (4096, 4, 16, 32, 4, 2, None), (4096, 4, 32, 64, 8, 16, 4),
    (8192, 8, 16, 64, 4, 4, None)]


def _k10(Lp, k, C, pack, warps, ipt, group, seed=4, **kw):
    fwd, rc = padded(index_genomes(seed, Lp), Lp)
    want = ag.index_block_plain(torch.from_numpy(fwd), torch.from_numpy(rc),
                                k, pack, C)
    return fwd, rc, want, lambda **more: k10_model(
        fwd, rc, k, pack, C, warps, ipt, group, sel_blocks=4 * warps,
        **kw, **more)


@pytest.mark.parametrize('Lp,k,C,pack,warps,ipt,group', K10_CASES)
def test_k10_model_matches_plain(Lp, k, C, pack, warps, ipt, group):
    """K10's decomposition == index_block_plain: the selection by the
    warp's bitonic sort with both passes' digit counts a CTA, the stable
    radix passes (two at k = 8, one at k = 4), each tile ranked by
    its digit peers and per-warp counts, its offsets by a look-back over
    the row's earlier tiles in a seeded random order, staged by digit and
    stored in runs; rows `group` at a time through one scratch, the packs
    from the sorted items, the window rows; C = 1, 8, 16 and 32, both
    pack widths, 4-byte items."""
    fwd, rc, want, run = _k10(Lp, k, C, pack, warps, ipt, group)
    got, stats = run()
    _same(got, want, ag._V2_KEYS)
    sv_f, pk2_f = want[2].numpy(), want[4].numpy()
    # The all-N genome has no valid seed; its qoff still holds offsets.
    assert (want[0][1] == -1).all() and (sv_f[1] == BIG).all()
    assert set(want[1][1].tolist()) == set(range(C))
    # The poly-A run: one value (0) over many blocks, the positions of its
    # run ascending in the packs.
    assert (sv_f[0] == 0).sum() > 60 * min(C, 2)
    assert (pk2_f[0][sv_f[0] == 0] > 0).sum() >= (sv_f[0] == 0).sum() - 1
    # One global add a selection CTA, pass and digit at most; where a row
    # spans tiles, look-backs passed over aggregates and stale words.
    G, NQ = fwd.shape[0], Lp // FINE * C
    ctas = 2 * G * -(-(Lp // FINE) // (4 * warps))
    assert stats['adds'] <= ctas * 256 * ((2 * k + 7) // 8)
    tiles = -(-NQ // (warps * ipt * 32))
    assert (stats['stale'] > 0) == (tiles > 1)
    assert (stats['agg_reads'] > 0) == (tiles > 2)


def test_k10_model_kmer_doubling():
    """K10's k-mer values by doubling (5 shuffles at k = 8, not 16) ==
    the lane-by-lane values K9 takes (kmer_value), at every k from 1 to 8,
    on seeded codes with Ns and on the index genomes' blocks."""
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 5, (64, 2, 32))
    codes[:8] = 0
    fwd, _ = padded(index_genomes(4, 4096), 4096)
    blk = blocks_of(fwd)
    for cur, nxt in ((codes[:, 0], codes[:, 1]), (blk[:, :-1], blk[:, 1:])):
        for k in range(1, 9):
            assert np.array_equal(kmer_doubling(cur, nxt, k),
                                  kmer_value(cur, nxt, k)), k


@pytest.mark.parametrize('Lp,k,C,pack', [(4096, 8, 16, 32),
                                         (8192, 4, 8, 64)])
def test_k10_model_wide_items(Lp, k, C, pack):
    """The 8-byte items (value << 40 | position + 1 << 20) that buckets
    above 65,536 take, here at small buckets: == index_block_plain."""
    fwd, rc, want, run = _k10(Lp, k, C, pack, 4, 2, None, wide=True)
    _same(run()[0], want, ag._V2_KEYS)


def test_k10_model_one_value_rows():
    """Rows whose valid slots all hold one value: a poly-A genome (0 on
    the forward strand, 65,535 on the reverse at k = 8) over 32 tiles a
    row, each tile one run of one digit in both passes; == the plain
    version, the positions of each row ascending in its packs."""
    Lp, C = 8192, 32
    codes = [np.zeros(Lp - 300, np.int8),
             np.random.default_rng(1).integers(0, 4, 5000).astype(np.int8)]
    fwd, rc = padded(codes, Lp)
    want = ag.index_block_plain(torch.from_numpy(fwd), torch.from_numpy(rc),
                                8, 32, C)
    got, stats = k10_model(fwd, rc, 8, 32, C, 4, 2, None, sel_blocks=16)
    _same(got, want, ag._V2_KEYS)
    for s, value in ((0, 0), (1, 65535)):
        sv, pk1 = want[2 + 3 * s][0].numpy(), want[3 + 3 * s][0].numpy()
        n = int((sv < BIG).sum())
        assert n > 7000 and (sv[:n] == value).all()
        assert (np.diff(pk1[:n] & 0xFFFF) > 0).all()
    assert stats['agg_reads'] > 0


@pytest.mark.parametrize('bug', ['agg_as_incl', 'unstable_staging',
                                 'no_epoch'])
def test_k10_model_mutations_fail(bug):
    """Mutation checks of the model: a look-back that takes an aggregate
    for an inclusive prefix, a staging that is not stable, or a look-back
    that takes words of an earlier launch must not equal the plain
    version (or must store out of the row: an IndexError)."""
    _, _, want, run = _k10(8192, 8, 16, 32, 4, 2, None)
    with pytest.raises((AssertionError, IndexError)):
        _same(run(bug=bug)[0], want, ag._V2_KEYS)


def test_k10_model_invalid_tail_order_is_free():
    """The claim K10 rests on: the plain version's sort of a strand (here
    in numpy, == index_block_plain's sv_f and pk1_f) gives the same
    outputs with its invalid slots' positions in any order (sv is BIG and
    the packs 0 there, and no output holds their positions)."""
    Lp, C = 4096, 16
    fwd, rc = padded(index_genomes(5, Lp), Lp)
    plain = ag.index_block_plain(torch.from_numpy(fwd), torch.from_numpy(rc),
                                 8, 32, C)
    sel_v, sel_o = select_model(fwd, 8, C)
    rng = np.random.default_rng(0)
    NQ = Lp // FINE * C
    blk = (np.arange(NQ) // C) * FINE
    outs = []
    for shuffle in (False, True):
        vs = np.where(sel_v < 0, BIG, sel_v)
        pos = blk + sel_o
        if shuffle:
            for g in range(len(vs)):
                bad = np.flatnonzero(vs[g] == BIG)
                pos[g, bad] = pos[g, rng.permutation(bad)]
        order = np.argsort(vs, axis=1, kind='stable')
        sv = np.take_along_axis(vs, order, 1)
        spos = np.take_along_axis(pos, order, 1)
        pk = np.where(sv < BIG, (sv << 16) | (spos + 1), 0)
        outs.append((sv, pk))
    assert np.array_equal(outs[0][0], plain[2].numpy())
    assert np.array_equal(outs[0][1], plain[3].numpy())
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
