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

K10 (`index_v2_select`, `_scan`, `_scatter`, `_pack`): the (genome,
strand) rows go a group at a time. A warp takes a fine block, lane l
offset l; a bitonic network over the warp sorts the keys hash << 5 | l
and lane r < C takes the r-th. The valid slots' items (value << 40 |
position + 1 << 20) are then sorted by value, stably, by LSD radix passes
of 8-bit digits (two at k = 8, one at k = 4): the digit counts of each
tile of W x I x 32 slots, their scan (each tile's offset inside a digit,
each digit's first place), then a CTA a (row, tile): W warps of I rounds
of 32 items in order, each item ranked among its round's lanes of one
digit (__match_any_sync) and after the warp's earlier rounds (a per-warp
digit count), the warps' counts scanned per digit from the tile's
offset, the item counted for the next pass at its new tile. `k10_model`
runs the kernel's tile (8 warps x 16) and small ones (many a row), rows
in groups, and asserts that every place is written once and that the
next pass's counts match the items' new places; then sv, pk1 and pk2
from the sorted items.

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


def select_model(codes, k, C, tile):
    """The selection of every fine block (G, NBF) at once: values, hashes,
    the warp's bitonic sort of h << 5 | lane, lane r < C taking the r-th;
    the slots written (value, offset, item), each slot once, and the first
    pass's digit counts a tile of `tile` slots (the warps' atomics)."""
    G, Lp = codes.shape
    NBF = Lp // FINE
    blk = blocks_of(codes)
    v = kmer_value(blk[:, :NBF], blk[:, 1:], k)           # (G, NBF, 32)
    h = np.where(v >= 0, ((v & 0xFFFFFFFF) * MUL & 0xFFFFFFFF) >> 16, 65536)
    key = bitonic((h << 5) | LANE)
    assert np.array_equal(key, np.sort((h << 5) | LANE, axis=-1))
    off = key[..., :C] & 31
    vv = np.take_along_axis(v, off, axis=-1)              # (G, NBF, C)
    NQ = NBF * C
    sel_v = vv.reshape(G, NQ)
    sel_o = off.reshape(G, NQ)
    pos = (FINE * np.arange(NBF)[None, :, None] + off).reshape(G, NQ)
    items = np.where(sel_v >= 0, (sel_v.astype(np.uint64) << np.uint64(40))
                     | ((pos + 1).astype(np.uint64) << np.uint64(20)), NONE)
    tiles = -(-NQ // tile)
    hist = np.zeros((G, tiles, 256), np.int64)
    g, slot = np.nonzero(sel_v >= 0)
    np.add.at(hist, (g, slot // tile, sel_v[g, slot] & 255), 1)
    return sel_v, sel_o, items, hist


def scan_model(hist):
    """index_v2_scan: each tile's digit count becomes its offset inside
    the digit, the digits' totals their first places; and the valid
    count."""
    offs = np.cumsum(hist, axis=1) - hist
    totals = hist.sum(axis=1)
    return offs, np.cumsum(totals, axis=1) - totals, totals.sum(axis=1)


def digit(items, p):
    return ((items >> np.uint64(40 + 8 * p)) & np.uint64(255)).astype(
        np.int64)


def scatter_model(src, n, offs, dbase, p, next_p, warps, ipt):
    """index_v2_scatter: every (row, tile) CTA of warps x ipt rounds of 32
    items; returns dst (each place written once) and the next pass's
    digit counts a tile, counted at the items' new places."""
    R, NQ = src.shape
    tile = warps * ipt * 32
    tiles = offs.shape[1]
    dst = np.full((R, NQ), 9, np.uint64)
    hits = np.zeros((R, NQ), np.int64)
    nxt = np.zeros((R, tiles, 256), np.int64)
    rows = np.arange(R)
    lower = LANE[None, :] < LANE[:, None]                 # [l, l'] l' < l
    for t in range(tiles):
        t0 = t * tile
        whist = np.zeros((R, warps, 257), np.int64)
        held = []
        for w in range(warps):
            for j in range(ipt):
                i = t0 + (w * ipt + j) * 32 + LANE
                inside = i[None, :] < n[:, None]
                ii = np.minimum(i, NQ - 1)
                it = np.where(inside, src[:, ii], NONE)
                ok = it != NONE
                dg = np.where(ok, digit(it, p), 256)
                same = dg[:, :, None] == dg[:, None, :]   # [r, l, l']
                rk = whist[rows[:, None], w, dg] + (same & lower).sum(2)
                lead = np.argmax(same, axis=2) == LANE    # lowest peer
                r, l = np.nonzero(ok & lead)
                np.add.at(whist, (r, w, dg[r, l]), same.sum(2)[r, l])
                held.append((w, it, ok, dg, rk))
        run = dbase + offs[:, t]                          # (R, 256)
        for w in range(warps):
            c = whist[:, w, :256].copy()
            whist[:, w, :256] = run
            run = run + c
        for w, it, ok, dg, rk in held:
            r, l = np.nonzero(ok & (t0 < n)[:, None])
            at = whist[r, w, dg[r, l]] + rk[r, l]
            dst[r, at] = it[r, l]
            np.add.at(hits, (r, at), 1)
            if next_p is not None:
                np.add.at(nxt, (r, at // tile, digit(it[r, l], next_p)), 1)
    return dst, hits, nxt


def k10_model(fwd, rc, k, pack_bits, C, warps=8, ipt=16, group=None):
    """K10's arena: qsv, qoff, per strand sv, pk1, pk2, then r2dov. The 2 G
    rows (row 2 g + s) go `group` at a time, as the entry point runs
    them."""
    G, Lp = fwd.shape
    NBF = Lp // FINE
    NQ = NBF * C
    tile = warps * ipt * 32
    passes = (2 * k + 7) // 8
    sel = [select_model(x, k, C, tile) for x in (fwd, rc)]
    items = np.stack([sel[0][2], sel[1][2]], 1).reshape(2 * G, NQ)
    hist = np.stack([sel[0][3], sel[1][3]], 1).reshape(2 * G, -1, 256)
    sorted_items = np.empty_like(items)
    count = np.empty(2 * G, np.int64)
    group = group or 2 * G
    for r0 in range(0, 2 * G, group):
        rs = slice(r0, min(r0 + group, 2 * G))
        src, h = items[rs], hist[rs]
        n = np.full(len(src), NQ)
        for p in range(passes):
            offs, dbase, nv = scan_model(h)
            if p == 0:
                count[rs] = nv
            nxt_p = p + 1 if p + 1 < passes else None
            src, hits, h = scatter_model(src, n, offs, dbase, p, nxt_p,
                                         warps, ipt)
            n = count[rs]
            placed = np.arange(NQ)[None, :] < n[:, None]
            assert (hits[placed] == 1).all() and (hits[~placed] == 0).all()
            if nxt_p is not None:       # counted at the new places
                direct = np.zeros_like(h)
                r, i = np.nonzero(placed)
                np.add.at(direct, (r, i // tile, digit(src[r, i], nxt_p)), 1)
                assert np.array_equal(h, direct)
        sorted_items[rs] = src
    out = [sel[0][0].astype(np.int32), sel[0][1].astype(np.int32)]
    for s in range(2):
        it_all = sorted_items[s::2]
        n = count[s::2]
        i = np.arange(NQ)[None, :]
        ok = i < n[:, None]
        it = np.where(ok, it_all, np.uint64(0)).astype(np.int64)
        v = it >> 40
        pos1 = (it >> 20) & 0xFFFFF
        prev_it = np.concatenate([np.zeros((G, 1), np.int64), it[:, :-1]], 1)
        same = ok & (i > 0) & ((prev_it >> 40) == v)
        prev1 = np.where(same, (prev_it >> 20) & 0xFFFFF, 0)
        sv = np.where(ok, v, BIG).astype(np.int32)
        if pack_bits == 64:
            pk1 = np.where(ok, it | prev1, 0)
            pk2 = pk1
        else:
            pk1 = np.where(ok, (v << 16) | pos1, 0)
            pk2 = np.where(ok & (prev1 > 0), (v << 16) | prev1, 0)
        out += [sv, pk1, pk2]
    pad = np.full(16, 4, np.int8)
    r2dov = np.full((G, 2 * (NBF + 1), 64), POISON, np.int8)
    for s, codes in enumerate((fwd, rc)):
        for c in range(4 * (NBF + 1)):
            r, m = divmod(c, 4)
            idx = 32 * (r - 1) + 16 * m
            r2dov[:, s * (NBF + 1) + r, 16 * m:16 * m + 16] = (
                codes[:, idx:idx + 16] if r > 0 and idx < Lp else pad)
    return tuple(out) + (r2dov,)


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


@pytest.mark.parametrize('Lp,k,C,pack,warps,ipt,group', [
    (4096, 8, 16, 32, 8, 16, None), (4096, 8, 16, 32, 4, 2, 5),
    (4096, 8, 1, 32, 2, 1, None), (4096, 8, 8, 64, 3, 2, 1),
    (4096, 8, 32, 32, 8, 16, 3), (4096, 8, 32, 64, 8, 1, None),
    (4096, 4, 16, 32, 4, 2, None), (4096, 4, 32, 64, 8, 16, 4),
    (8192, 8, 16, 64, 4, 4, None)])
def test_k10_model_matches_plain(Lp, k, C, pack, warps, ipt, group):
    """K10's decomposition == index_block_plain: the selection by the
    warp's bitonic sort, the stable radix passes (two at k = 8, one at k =
    4), each a scan of the tiles' digit counts and a scatter of tiles of
    `warps` x `ipt` rounds of 32 (the kernel's 8 x 16, and small tiles:
    many a row, counted for the next pass at the items' new tiles), rows
    `group` at a time, the packs from the sorted items, the window rows;
    C = 1, 8, 16 and 32, both pack widths."""
    fwd, rc = padded(index_genomes(4, Lp), Lp)
    want = ag.index_block_plain(torch.from_numpy(fwd), torch.from_numpy(rc),
                                k, pack, C)
    got = k10_model(fwd, rc, k, pack, C, warps, ipt, group)
    _same(got, want, ag._V2_KEYS)
    sv_f, pk2_f = want[2].numpy(), want[4].numpy()
    # The all-N genome has no valid seed; its qoff still holds offsets.
    assert (want[0][1] == -1).all() and (sv_f[1] == BIG).all()
    assert set(want[1][1].tolist()) == set(range(C))
    # The poly-A run: one value (0) over many blocks, the positions of its
    # run ascending in the packs.
    assert (sv_f[0] == 0).sum() > 60 * min(C, 2)
    assert (pk2_f[0][sv_f[0] == 0] > 0).sum() >= (sv_f[0] == 0).sum() - 1


def test_k10_model_invalid_tail_order_is_free():
    """The claim K10 rests on: the plain version's sort of a strand (here
    in numpy, == index_block_plain's sv_f and pk1_f) gives the same
    outputs with its invalid slots' positions in any order (sv is BIG and
    the packs 0 there, and no output holds their positions)."""
    Lp, C = 4096, 16
    fwd, rc = padded(index_genomes(5, Lp), Lp)
    plain = ag.index_block_plain(torch.from_numpy(fwd), torch.from_numpy(rc),
                                 8, 32, C)
    sel_v, sel_o, _, _ = select_model(fwd, 8, C, 4096)
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
