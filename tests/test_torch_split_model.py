"""Models, in numpy, of how kernels K3, K5 and K4 cut their work across
the card, held against the plain versions on the CPU.

K3 (csrc/align_v3.cu, `bands_kernel`): a warp takes a coarse block of
one task and reads each band's wide row in place (the candidate's block
on the forward strand, its mirror, clamped, on the reverse): it builds the
row's plane words (low bit, high bit, "is a base") once, 2 FPB + 3 words
from byte 16 on, and fine block k's window is words k .., so a shift is a
funnel shift of two of them; a band without codes above 3 in its row and
query skips the "is a base" planes. The election's packed max is reduced
over the warp and decoded by lane k: count, strand, diagonal (the band's
first, 32 g - (q + 1) WQ - 16, plus the shift), and the gate and
threshold. The model forms the same words and shifts, on seeded arenas at
V3_WQ 64 to 416, with codes 4 in rows and queries, candidates at blocks 0
and NRB - 1, and rows whose lengths are not multiples of 32.

K5 (csrc/align_v3.cu, `propagate_kernel`): a warp takes a tile of T
blocks of one pair, EXT_ITERS + 1 blocks of halo on its left and
EXT_ITERS on its right; each block's counts at the 2 * EXT_ITERS + 1
states its cone can hand it are gathered before the first step (the
candidate table; only initially assigned candidates), and the steps carry
each block's source index. The model runs the same tiles (here of 8 to 128
blocks, so that edges occur) and asserts that every source a step reads
lies in the table and was assigned from the start. Its bands' first
diagonals come from g1 and g2 (K3's rule), and its flags read each
band's window from the band's row: bytes 16 + 32 (f % FPB) + shift of
row (first diagonal + (f / FPB + 1) WQ + 16) / 32.

K4 (csrc/back_half.cu, `back_half_kernel`): a CTA takes a chunk of CW
words (one word a fine block) of one pair. From its own words it forms a
summary: its forward aggregate (count of m, last anchored match and the
count there, last break, last MAL run), its segment starts found a word
at a time with masks (all but its first anchored match's, which depends
on what came before), and the segments those close. One decoupled
look-back gives the state before the chunk (forward state, last start,
accepted segments with their lengths and matches): the nearest
predecessor's inclusive state with the summaries after it applied in
order. Applying its own summary resolves the chunk's first starts; the
pair's last chunk closes the last segment, writes the aggregates and
fills the unused record rows with -1. The model runs chunks of 3 to 512
words, and its look-back finds each predecessor's inclusive state or only
its summary at random (from a seed), as the kernel may.

Inputs from tests/back_half_cases.py (seeded numpy; K3's and K5's on
crafted arenas of wide rows and query codes); every output is an integer
or a flag, so the tolerance is 0. No JAX program runs here.
"""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, '.')

from back_half_cases import (CASES, K3_ARGS, K5_ARGS,  # noqa: E402
                             PARAMS, back_half_case, band_rows, bands_case,
                             chain_case, last_chunk_case, long_segment_case,
                             propagate_case, torch_args)
from vclust_tpu_torch.ops import align_gpu as ag  # noqa: E402

torch.set_num_threads(1)

FINE = 32
M32 = 0xffffffff

# --------------------------------------------------------------------------
# K3
# --------------------------------------------------------------------------

_POPC8 = np.array([bin(i).count('1') for i in range(256)], np.int64)
_LANES = np.arange(32, dtype=np.uint64)


def _popc_words(x):
    """Population count of 32-bit words held in uint64."""
    return sum(_POPC8[(x >> np.uint64(8 * i)) & np.uint64(255)]
               for i in range(4))


def _planes(codes):
    """Codes (..., 32) -> the words of the three planes (low bit, high bit,
    code in 0-3), bit p = code p, as uint64."""
    bit = np.uint64(1) << _LANES
    c = codes.astype(np.int64)
    return tuple(((x != 0).astype(np.uint64) * bit).sum(-1, dtype=np.uint64)
                 for x in (c & 1, c & 2, (c >= 0) & (c < 4)))


def _shift(w, c):
    """Each lane's word: bits lane .. lane + 31 of words c and c + 1 (the
    kernel's funnel shift), (..., 32)."""
    pair = (w[..., c + 1, None] << np.uint64(32)) | w[..., c, None]
    return (pair >> _LANES) & np.uint64(M32)


def k3_model(case, tband, smin):
    """K3's outputs as its warps form them: cnt (4, R, K, NBF, BAND) and
    cnt_best, A, S, D (R, K, NBF)."""
    g3 = case['g3']
    FPB, WQ, BAND = g3['FPB'], g3['WQ'], g3['BAND']
    NW = 2 * FPB + 3
    R, K, NQB = case['g1'].shape
    N, NBF = R * K, NQB * FPB
    gs = band_rows(case).reshape(4, N, NQB)
    rr = np.repeat(case['r_rows'], K)[:, None]
    # One plane build a coarse block and band: word c is the row's bytes
    # 16 + 32 c .. 47 + 32 c, read in place.
    x = np.stack([case['b']['roww_r' if b & 1 else 'roww_f'][rr, gs[b]]
                  for b in range(4)])[..., 16:16 + 32 * NW]
    x = x.reshape(4, N, NQB, NW, 32)
    wl, wh, wv = _planes(x)
    bases = ((x >= 0) & (x < 4)).all(axis=(-2, -1))          # (4, N, NQB)
    wv = np.where(bases[..., None], np.uint64(M32), wv)
    qc = case['b']['fwd'][case['q_rows'].reshape(N)].reshape(N, NQB, FPB,
                                                              32)
    ql, qh, qv = _planes(qc)                                 # (N, NQB, FPB)
    cnt = np.zeros((4, N, NQB, FPB, FPB + 3, 32), np.int8)
    best = np.full((N, NQB, FPB), -1, np.int64)
    t_lane = _LANES.astype(np.int64)
    for b in range(4):
        tag = (2048 if b < 2 else 0) | (0 if b & 1 else 1024)
        for k in range(FPB):
            # Without codes above 3 in the row and the query block, the
            # "is a base" planes are left out.
            fast = bases[b] & (qv[..., k] == M32)
            q_l, q_h, q_v = (p[..., k, None] for p in (ql, qh, qv))
            for j in range(FPB + 3):
                m = ~((q_l ^ _shift(wl[b], k + j))
                      | (q_h ^ _shift(wh[b], k + j))) & np.uint64(M32)
                m = np.where(fast[..., None], m,
                             m & _shift(wv[b], k + j) & q_v)
                c = _popc_words(m)
                cnt[b, :, :, k, j] = c
                best[..., k] = np.maximum(best[..., k], (
                    (c << 12) | tag | (32 * j + t_lane)).max(-1))
    # The decode, lane k of the warp.
    cb = best >> 12
    c1 = (best & 2048) != 0
    rev = (best & 1024) == 0
    g = np.take_along_axis(gs[..., None], (np.where(c1, 0, 2) + rev)[None],
                           0)[0]
    q = np.arange(NQB)[:, None]
    D = 32 * g - (q + 1) * WQ - 16 + (best & 511)
    c1n, c2n = (case[k].reshape(N, NQB)[..., None] for k in ('cnt1',
                                                             'cnt2'))
    gate = np.where(c1, c1n >= smin, c2n >= max(smin // 2, 3))
    tb = np.minimum(np.maximum((_popc_words(qv) * tband) >> 5, 4), tband)
    A = (cb >= tb) & gate
    shape = (R, K, NBF)
    return dict(cnt=cnt.reshape(4, R, K, NBF, BAND),
                cnt_best=cb.reshape(shape).astype(np.int32),
                A=A.reshape(shape), S=rev.reshape(shape),
                D=D.reshape(shape).astype(np.int32))


def _bands_plain(case, tband, smin):
    b, args = torch_args(torch, case, K3_ARGS)
    return ag.bands_v3_plain(b, *args, tband, smin, case['g3'])


@pytest.mark.parametrize('wq,R,K,NQB,mode,tband,smin', [
    (64, 2, 3, 8, None, 17, 5),
    (128, 3, 2, 6, None, 17, 5),
    (128, 2, 2, 4, 'clean', 17, 5),
    (416, 1, 2, 3, None, 17, 5),
    (128, 2, 2, 4, 'ties', 17, 5),
    # tband below the threshold's floor of 4 (the min wins), smin // 2
    # below 3
    (96, 2, 2, 5, None, 3, 1),
    (128, 5, 1, 1, None, 17, 9)])        # one coarse block a task
def test_k3_model_matches_plain(wq, R, K, NQB, mode, tband, smin):
    """K3's rows in place, one plane build a coarse block and band, the
    mirror at its clamps and the decode == bands_v3_plain (stages 2-4 on
    the windows of `_band_windows`), every output."""
    case = bands_case(wq + R + NQB, R, K, NQB, wq, ties=mode == 'ties',
                      clean=mode == 'clean')
    want = _bands_plain(case, tband, smin)
    got = k3_model(case, tband, smin)
    for k, w in want.items():
        assert got[k].shape == tuple(w.shape)
        assert np.array_equal(got[k], w.numpy()), k
    gs = band_rows(case)
    assert (gs[0] == 0).any() and (gs[0] == case['g3']['NRB'] - 1).any()
    if R >= 5:     # the 100-base reference: every mirror clamps to 0
        assert (gs[1::2, 4] == 0).all()
    if mode == 'ties':    # every band ties: candidate 1 forward wins
        assert not got['S'].any()
    else:
        assert got['A'].any() and not got['A'].all()


# --------------------------------------------------------------------------
# K5
# --------------------------------------------------------------------------


def k5_model(case, iters, ext_min, ext_margin, cont, tile):
    """K5's outputs as its tiles form them: m1, m0 (R, K, Lq) and sw, A,
    S, D, Ap, Sp, Dp (R, K, NBF)."""
    el, g3 = case['el'], case['g3']
    band, FPB, WQ = g3['BAND'], g3['FPB'], g3['WQ']
    R, K, NBF = el['A'].shape
    N = R * K
    cnt = el['cnt'].reshape(4, N, NBF, band)
    # The four bands' first diagonals from the coarse blocks' candidates.
    fcs = np.arange(NBF) // FPB
    base = 32 * band_rows(case).reshape(4, N, -1)[..., fcs] \
        - (fcs + 1) * WQ - 16
    rows = np.stack([case['b']['roww_f'], case['b']['roww_r']])
    rr = np.repeat(case['r_rows'], K)
    qrow = case['q_rows'].reshape(N)
    fwd = case['b']['fwd']
    A0, S0, D0, best = (el[k].reshape(N, NBF) for k in
                        ('A', 'S', 'D', 'cnt_best'))
    E = iters
    out = tile - 2 * E - 1       # blocks a tile after the first writes
    assert out >= 1
    tiles = 1 + -(-max(NBF - tile, 0) // out)
    res = {k: np.zeros((N, NBF), dt) for k, dt in (
        ('A', bool), ('S', bool), ('D', np.int32), ('Ap', bool),
        ('Sp', bool), ('Dp', np.int32), ('sw', bool))}
    m1 = np.zeros((N, NBF, FINE), bool)
    m0 = np.zeros((N, NBF, FINE), bool)
    i = np.arange(tile)
    for n in range(N):
        for t in range(tiles):
            # The first tile from block 0, the others with E + 1 blocks of
            # halo on their left; each writes to E blocks before the end of
            # what it holds, or to the pair's end where it holds it.
            o_t = tile - E + (t - 1) * out if t else 0
            f_lo = o_t - (E + 1) if t else 0
            f_end = NBF if f_lo + tile >= NBF else f_lo + tile - E
            f = f_lo + i
            real = (f >= 0) & (f < NBF)
            fc = np.clip(f, 0, NBF - 1)
            d = np.where(real, D0[n, fc], 0)
            s = np.where(real, S0[n, fc], False)
            a = real & A0[n, fc]
            cc = np.where(a, best[n, fc], -1)
            bs = base[:, n, fc]                       # (4, tile)
            # The candidate table: block i's count at the initial state of
            # block i - E + c, each over the two bands of that strand; only
            # for an initially assigned candidate (no other state reaches a
            # neighbour as an assigned one; the steps assert it).
            cand = np.full((tile, 2 * E + 1), -1)
            for c in range(2 * E + 1):
                g = i - E + c
                ok = real & (g >= 0) & (g < tile)
                gc = np.clip(g, 0, tile - 1)
                ok &= a[gc]
                for k in range(2):
                    b = s[gc].astype(int) + 2 * k
                    tn = d[gc] - bs[b, i]
                    hit = ok & (tn >= 0) & (tn < band)
                    v = cnt[b, n, fc, np.clip(tn, 0, band - 1)]
                    cand[:, c] = np.maximum(cand[:, c], np.where(hit, v, -1))
            src = i.copy()
            a0 = a.copy()
            for step in range(2 * E):
                nb = i + (1 if step & 1 else -1)
                inb = (nb >= 0) & (nb < tile)
                nc = np.clip(nb, 0, tile - 1)
                nd, ns, na, nsrc = d[nc], s[nc], inb & a[nc], src[nc]
                need = real & na & ((nd != d) | (ns != s))
                off = nsrc - i + E
                assert ((off[need] >= 0) & (off[need] <= 2 * E)).all()
                assert a0[nsrc[need]].all()
                cn = np.where(need, cand[i, np.clip(off, 0, 2 * E)], -1)
                better = (cn >= ext_min) & (cn > cc + ext_margin)
                cv = a & (cn >= ext_min) & (cn + cont >= cc) & (cn <= cc)
                adopt = better | cv
                d = np.where(adopt, nd, d)
                s = np.where(adopt, ns, s)
                src = np.where(adopt, nsrc, src)
                cc = np.where(adopt, cn, cc)
                a = a | better
            o = np.arange(o_t - f_lo, f_end - f_lo)
            fo = f[o]
            # The block before (none before block 0).
            p = np.maximum(o - 1, 0)
            ap, sp, dp = a[p] & (o > 0), s[p] & (o > 0), np.where(o > 0,
                                                                 d[p], 0)
            sw = a[o] & ap & ((d[o] != dp) | (s[o] != sp))
            for key, v in (('A', a[o]), ('S', s[o]), ('D', d[o]),
                           ('Ap', ap), ('Sp', sp), ('Dp', dp), ('sw', sw)):
                res[key][n, fo] = v
            # The flags: the window at the final state (m1) and at the
            # block before's (m0), each band of the strand read once, from
            # the band's row; the query bases from the query's codes.
            q = fwd[qrow[n], 32 * fo[:, None] + np.arange(FINE)]
            fco = fo // FPB
            for flags, on, ss, dd in ((m1, a[o], s[o], d[o]),
                                      (m0, sw, sp, dp)):
                hit = np.zeros((len(o), FINE), bool)
                for k in range(2):
                    b = ss.astype(int) + 2 * k
                    first = bs[b, o]
                    tn = dd - first
                    ok = on & (tn >= 0) & (tn < band)
                    g = (first + (fco + 1) * WQ + 16) >> 5
                    at = 16 + 32 * (fo - fco * FPB) + np.clip(tn, 0,
                                                              band - 1)
                    w = rows[(b & 1)[:, None], rr[n], g[:, None],
                             at[:, None] + np.arange(FINE)]
                    hit |= ok[:, None] & (w == q)
                flags[n, fo] = hit & (q < 4)
    shape = (R, K, NBF)
    return (m1.reshape(R, K, NBF * FINE), m0.reshape(R, K, NBF * FINE),
            *(res[k].reshape(shape) for k in ('sw', 'A', 'S', 'D', 'Ap',
                                              'Sp', 'Dp')))


def _k5_check(case, knobs, tile, monkeypatch):
    names = ('EXT_ITERS', 'EXT_MIN', 'EXT_MARGIN', 'V3_CONT')
    for name, v in zip(names, knobs):
        monkeypatch.setattr(ag, name, v)
    b, args = torch_args(torch, case, K5_ARGS)
    el = {k: torch.from_numpy(v) for k, v in case['el'].items()}
    want = ag.propagate_v3_plain(el, b, *args, case['g3'])
    got = k5_model(case, *knobs, tile)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    return got


@pytest.mark.parametrize('R,K,NBF,band,ties,knobs,tile', [
    (2, 3, 300, 224, False, (3, 17, 4, 6), 16),
    (2, 2, 64, 160, True, (3, 17, 4, 6), 16),
    (1, 2, 33, 224, False, (0, 17, 4, 6), 8),     # EXT_ITERS = 0
    (1, 1, 1, 224, False, (3, 17, 4, 6), 16),     # one block
    (1, 2, 100, 224, True, (16, 12, 0, 32), 40),  # EXT_ITERS = 16
    (2, 2, 250, 224, False, (3, 17, 4, 6), 128),  # the kernel's tile
    (1, 3, 128, 224, True, (3, 17, 4, 6), 128),   # one tile holds the pair
    (1, 3, 129, 224, False, (3, 17, 4, 6), 128),  # ... one block too many
    (2, 3, 121, 224, False, (5, 20, 8, 0), 32)])
def test_k5_tiles_match_plain(monkeypatch, R, K, NBF, band, ties, knobs,
                              tile):
    """K5's tiles with halos and candidate tables, and its windows read
    from the rows, == propagate_v3_plain, every output, at tile sizes that
    put edges all over the pairs."""
    case = propagate_case(NBF + R + K, R, K, NBF, band, ties)
    got = _k5_check(case, knobs, tile, monkeypatch)
    if knobs[0] and NBF > 1:
        assert not np.array_equal(got[5], case['el']['D'])   # adopted
    assert got[0].any() and got[1].any() or NBF == 1


@pytest.mark.parametrize('c0,tile', [(12, 16), (13, 16), (124, 128),
                                     (125, 128), (60, 64), (22, 16)])
def test_k5_chain_across_tile_edge(monkeypatch, c0, tile):
    """A state handed on block by block across a tile's edge (K5's tile t
    >= 1 writes from T - EXT_ITERS + (t - 1) (T - 2 EXT_ITERS - 1))."""
    iters = 3
    case = chain_case(c0, 1, 2, 300, 224, c0, iters)
    got = _k5_check(case, (iters, 17, 4, 6), tile, monkeypatch)
    lo, hi = case['chain']
    A = got[3]
    assert A[..., lo:hi].all() and A.sum() == 2 * (hi - lo)
    out = tile - 2 * iters - 1
    assert any(lo < tile - iters + k * out < hi for k in range(300 // out))


@pytest.mark.parametrize('wq,NQB', [(128, 8), (64, 12), (416, 2)])
def test_k5_model_on_k3_output(monkeypatch, wq, NQB):
    """K5 on stage 4's election of a seeded arena (bands_v3_plain), with
    its windows read from the same rows K3 read, == propagate_v3_plain."""
    case = bands_case(wq + NQB, 2, 3, NQB, wq)
    case['el'] = {k: v.numpy() for k, v in _bands_plain(
        case, ag.V3_TBAND, ag.V3_SMIN).items()}
    got = _k5_check(case, (3, 17, 4, 6), 128, monkeypatch)
    assert got[0].any() and got[3].any()


# --------------------------------------------------------------------------
# K4
# --------------------------------------------------------------------------

def _words(bits):
    """(N, L) bool -> (N, L / 32) lists of 32-bit words, bit p = position
    32 w + p."""
    N, L = bits.shape
    b = np.packbits(bits.reshape(N, L // 8, 8), axis=-1, bitorder='little')
    return b.reshape(N, L // 32, 4).view('<u4')[..., 0].astype(np.int64) \
        .tolist()


def _word_inputs(x, Lq, mrd):
    """Per pair and word: refined flags m, anchored matches ma, MAL-run
    positions anc and the break bit brk; and each block's switch point.
    As the plain version defines them (the words K4 forms)."""
    t = [torch.from_numpy(a) for a in x]
    d = ag.blocks_to_measures_plain(*t, Lq=Lq, mqd=0, mrd=mrd, reg=1,
                                    debug=True)
    m, ma = d['m'], d['ma']
    anc = ag._run_positions(m, ag.MAL)
    m1, m0, sw, A, S, D, Ap, Sp, Dp, _ = x
    N, NBF = A.shape
    g = np.cumsum(m0.reshape(N, NBF, FINE).astype(int)
                  - m1.reshape(N, NBF, FINE), axis=-1)
    gpad = np.concatenate([np.zeros((N, NBF, 1), int), g], axis=-1)
    tstar = np.where(sw, np.argmax(gpad, axis=-1), 0)
    linked = A & Ap & (S == Sp) & (np.abs(D - Dp) <= mrd)
    brk_blk = A & Ap & ~linked
    brk_blk[:, 0] = False
    brk = np.where(brk_blk, 1 << np.minimum(tstar, FINE - 1), 0).tolist()
    return (_words(m.numpy()), _words(ma.numpy()), _words(anc.numpy()), brk,
            tstar)


def _popc(x):
    return bin(x).count('1')


def _below(t):
    return M32 if t >= 32 else (1 << t) - 1


def _last_bit(x):
    return x.bit_length() - 1


FWD_ID = (0, -1, 0, -1, -1)      # cm, ma, cma, b, an
START_ID = (-1, 0)               # s, cms
SUMS_ID = (0, 0, 0)              # accepted, length, matches


def fwd_op(l, r):
    return (l[0] + r[0], r[1] if r[1] >= 0 else l[1],
            l[0] + r[2] if r[1] >= 0 else l[2], max(l[3], r[3]),
            max(l[4], r[4]))


def sums_op(l, r):
    return tuple(a + b for a, b in zip(l, r))


def look_back(summaries, incls, c, X0, apply, rng):
    """Chunk c's carry as the kernel's look-back forms it: the nearest
    predecessor that shows its inclusive state (each does at random, chunk
    0 always), or the pair's start state X0, and then the summaries of the
    chunks after it applied in order."""
    j = c - 1
    while j > 0 and rng.random() < 0.5:
        j -= 1
    X = incls[j] if j >= 0 else X0
    for k in range(j + 1, c):
        X = apply(summaries[k], X)[0]
    return X


def window_or(z, w):
    """Bit p: any bit of z in [p - w + 1, p] (1 <= w <= 32), by the
    kernel's doubling steps."""
    r, x, off = 0, z, 0
    for k in range(6):
        if (w >> k) & 1:
            r |= (x << off) & M32 if off < 32 else 0
            off += 1 << k
        if k < 5:
            x = (x | (x << (1 << k))) & M32
    return r


def word_starts(ma, brk, F, base, mqd):
    """The segment starts of one word: an anchored match with none in the
    mqd + 1 positions before it, or with a break since the one before.
    F: the forward state before the word."""
    if not ma:
        return 0
    anyb = window_or((ma << 1) & M32, min(mqd + 1, 32))
    x = brk & ~ma & M32
    crossed = ((((~ma & M32) + x) & M32) | brk) & ma
    s = ma & ((~anyb & M32) | crossed)
    low = ma & -ma
    i0 = base + _last_bit(low)
    first = F[1] < 0 or F[1] < i0 - mqd - 1 or F[3] > F[1] or bool(
        crossed & low)
    return (s & ~low) | (low if first else 0)


def chunk_summary(w, fw, span, mqd, reg):
    """A chunk's summary from its own words alone (w: the pair's m, ma,
    anc, brk word lists): its forward aggregate; its first anchored match
    i0 with the count of m before it (in the chunk) and whether a break in
    the chunk at or before it makes it a start whatever came before; its
    last start among the other anchored matches (determined starts) with
    the count before it; the first determined start p1 with the last
    anchored match below it, the count up to that and the last MAL run
    below p1 (-1 if none in the chunk); and the segments that determined
    starts after p1 close, summed. Counts are the chunk's own. Also those
    segments, (start, end, matches)."""
    m, ma, anc, brk = w
    F = FWD_ID
    first = (-1, 0, False)
    sd, p1 = START_ID, (-1, 0, 0, -1)
    closes = []
    for f in span:
        base = 32 * f
        sb = word_starts(ma[f], brk[f], F, base, mqd)
        if ma[f] and first[0] < 0:
            low = ma[f] & -ma[f]
            p = _last_bit(low)
            crossed = (((((~ma[f] & M32) + (brk[f] & ~ma[f] & M32)) & M32)
                        | brk[f]) & ma[f])
            first = (base + p, F[0] + _popc(m[f] & _below(p)),
                     F[3] >= 0 or bool(crossed & low))
            sb &= ~low
        while sb:
            p = _last_bit(sb & -sb)
            sb &= sb - 1
            mb = ma[f] & _below(p)
            if mb:
                q = _last_bit(mb)
                e, cma = base + q, F[0] + _popc(m[f] & _below(q + 1))
            else:
                e, cma = F[1], F[2]
            ab = anc[f] & _below(p)
            la = base + _last_bit(ab) if ab else F[4]
            if sd[0] < 0:
                p1 = (base + p, e, cma, la)
            elif e - sd[0] + 1 >= reg and la >= sd[0]:
                closes.append((sd[0], e, cma - sd[1]))
            sd = (base + p, F[0] + _popc(m[f] & _below(p)))
        F = fwd_op(F, fw[f])
    D = (len(closes), sum(e - s + 1 for s, e, _ in closes),
         sum(nt for _, _, nt in closes))
    return dict(F=F, first=first, sd=sd, p1=p1, D=D), closes


def apply_summary(sm, X, mqd, reg):
    """The state after a chunk from the state X = (forward, last start,
    sums) before it and the chunk's summary; and the segments the chunk's
    first starts close (at i0 if it starts one, at p1), which need X."""
    F_in, S_in, C_in = X
    i0, cms0, x0 = sm['first']
    out = []

    def close(seg, e, cma, la):
        if e - seg[0] + 1 >= reg and la >= seg[0]:
            out.append((seg[0], e, cma - seg[1]))

    S_open = S_in
    if i0 >= 0 and (x0 or F_in[1] < 0 or F_in[1] < i0 - mqd - 1
                    or F_in[3] > F_in[1]):
        if S_in[0] >= 0:
            close(S_in, F_in[1], F_in[2], F_in[4])
        S_open = (i0, F_in[0] + cms0)
    p1, e1, cma1, la1 = sm['p1']
    if p1 >= 0 and S_open[0] >= 0:
        close(S_open, e1, F_in[0] + cma1, la1 if la1 >= 0 else F_in[4])
    sd = sm['sd']
    S_out = (sd[0], F_in[0] + sd[1]) if sd[0] >= 0 else S_open
    C_out = sums_op(sums_op(C_in, (len(out), sum(e - s + 1 for s, e, _ in
                                                 out),
                                   sum(nt for _, _, nt in out))), sm['D'])
    return (fwd_op(F_in, sm['F']), S_out, C_out), out


def k4_model(x, Lq, mqd, mrd, reg, CW, seed):
    """K4's aggregates, records and counts as its chunks of CW words form
    them: each chunk's summary from its own words, one look-back for the
    state before it, its own summary applied to that."""
    m_w, ma_w, anc_w, brk_w, tstar = _word_inputs(x, Lq, mrd)
    _, _, _, _, S, D, _, Sp, Dp, rlen = x
    N, NBF = S.shape
    width = min(ag._maxseg(Lq, reg), Lq)
    agg = np.zeros((N, 3), np.int32)
    recs = np.full((N, width, 6), -1, np.int32)
    nrec = np.zeros(N, np.int32)
    rng = np.random.default_rng(seed)
    chunks = -(-NBF // CW)
    X0 = (FWD_ID, START_ID, SUMS_ID)

    def record(n, s, e, nt):
        dv = []
        for pos in (s, e):
            pre = (pos & 31) < tstar[n, pos >> 5]
            dv.append(int((Dp if pre else D)[n, pos >> 5]))
            if pos == s:
                strand = bool((Sp if pre else S)[n, pos >> 5])
        rs, re_ = s + dv[0], e + dv[1]
        rl = int(rlen[n])
        return (s, e, rl - 1 - rs if strand else rs,
                rl - 1 - re_ if strand else re_, nt, e - s + 1 - nt)

    def apply(sm, X):
        return apply_summary(sm, X, mqd, reg)

    for n in range(N):
        w = m_w[n], ma_w[n], anc_w[n], brk_w[n]
        fw = []
        for f in range(NBF):
            m, ma, anc, brk = (v[f] for v in w)
            v = [_popc(m), -1, 0, -1, -1]
            if ma:
                p = _last_bit(ma)
                v[1], v[2] = 32 * f + p, _popc(m & _below(p + 1))
            if brk:
                v[3] = 32 * f + _last_bit(brk)
            if anc:
                v[4] = 32 * f + _last_bit(anc)
            fw.append(tuple(v))
        summaries, incls = [], []
        for c in range(chunks):
            sm, closes = chunk_summary(
                w, fw, range(c * CW, min((c + 1) * CW, NBF)), mqd, reg)
            X = look_back(summaries, incls, c, X0, apply, rng)
            X_out, first = apply(sm, X)
            summaries.append(sm)
            incls.append(X_out)
            for k, (s, e, nt) in enumerate(first + closes):
                if X[2][0] + k < width:
                    recs[n, X[2][0] + k] = record(n, s, e, nt)
        # The pair's last chunk closes its last segment.
        F, S_, total = incls[-1]
        if S_[0] >= 0 and F[1] - S_[0] + 1 >= reg and F[4] >= S_[0]:
            if total[0] < width:
                recs[n, total[0]] = record(n, S_[0], F[1], F[2] - S_[1])
            total = sums_op(total, (1, F[1] - S_[0] + 1, F[2] - S_[1]))
        agg[n] = (total[0], total[2], total[1])
        nrec[n] = total[0]
    return agg, recs, nrec


def _k4_check(x, Lq, params, CW, seed=0):
    mqd, mrd, reg = params
    want = ag.blocks_to_measures_plain(
        *(torch.from_numpy(a) for a in x), Lq=Lq, mqd=mqd, mrd=mrd, reg=reg,
        with_alns=True)
    got = k4_model(x, Lq, mqd, mrd, reg, CW, seed)
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape) and np.array_equal(g, w.numpy())
    return got


@pytest.mark.parametrize('CW', [3, 7, 128])
@pytest.mark.parametrize('case,params', [(c, 'default') for c in CASES]
                         + [(c, 'tight') for c in CASES] + [('cap', 'cap')])
def test_k4_chunks_match_plain(case, params, CW):
    """K4's chunks, carries and word-at-a-time starts == the plain version:
    aggregates, records and counts before the cap, at Lq = 4,096 (128
    words: 43, 19 and 1 chunks)."""
    x = back_half_case(case, 4096, 4096 + len(case))
    got = _k4_check(x, 4096, PARAMS[params], CW, seed=CW)
    if case == 'cap':
        assert (got[2] > got[1].shape[1]).all()


@pytest.mark.parametrize('make,CW', [(long_segment_case, 512),
                                     (long_segment_case, 200),
                                     (last_chunk_case, 512)])
def test_k4_segments_across_chunks(make, CW):
    """One segment whose start, MAL run and end lie in three chunks; and a
    pair whose only matches lie in its last chunk (Lq = 65,536)."""
    x = make(65536, 2)
    got = _k4_check(x, 65536, PARAMS['default'], CW)
    assert (got[0][:, 0] == 1).all()


def test_k4_start_masks():
    """The word masks against a position-by-position walk: every mqd from
    0 to 40, breaks anywhere, the carried state before and inside the
    distance."""
    rng = np.random.default_rng(7)
    for trial in range(3000):
        ma = int(rng.integers(0, 1 << 32)) & int(rng.integers(0, 1 << 32))
        brk = int(rng.integers(0, 1 << 32)) if trial % 3 == 0 else (
            1 << int(rng.integers(0, 32)) if trial % 3 == 1 else 0)
        mqd = int(rng.integers(0, 41))
        base = 32 * int(rng.integers(1, 4))
        pm = int(rng.choice([-1, base - 1, base - 20, base - 45]))
        lb = int(rng.choice([-1, pm, pm + 1 if pm + 1 < base else -1]))
        F = (0, pm, 0, lb, -1)
        want, prev, last_b = 0, pm, lb
        for p in range(32):
            i = base + p
            if (brk >> p) & 1:
                last_b = i
            if (ma >> p) & 1:
                if prev < 0 or prev < i - mqd - 1 or last_b > prev:
                    want |= 1 << p
                prev = i
        assert word_starts(ma, brk, F, base, mqd) == want, (ma, brk, mqd, F)
