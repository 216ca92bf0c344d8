"""Models, in numpy, of how kernels K8, K6 and K7 (csrc/align_v2.cu) do the
v2 front end's work, held against the plain versions on the CPU.

K8 (`votes_kernel`): a CTA stages every stride-th entry of a reference
row's sorted seed values (stride 1 up to K8_SAMPLES entries), finds for
each query seed the entries <= its value by a branch-free power-of-two
descent over the sample, refines between two samples through the row,
and takes the max of the packs over the run of entries equal to the
value (the plain version's stable sort join and running max give the
same). The model runs the kernel's sample size and a small one (stride
> 1).

K6 (`elect_kernel`): a warp takes a coarse block; its 4 fine blocks' 4C
votes each padded with BIG to a power of two P, a bitonic network whose
first step of each merge compares mirrored elements sorts each run
ascending, then merges the four; the fine elections run on the runs, the
coarse one on every fourth vote of the merged list, the fine block's
support for the coarse mode on its own votes. The model runs the same
network on every coarse block at once.

K7 (`propagate_v2_kernel`): a warp takes a tile of T blocks of one pair,
EXT_ITERS + 1 blocks of halo on its left and EXT_ITERS on its right; each
block's match masks at the initial states of the initially assigned
blocks of [i - EXT_ITERS - 1, i + EXT_ITERS] are evaluated before the
first step, the steps carry each block's source block, and m1 and m0 are
the masks of the block's and the previous block's final sources. The
model runs tiles of 8 to 128 blocks (edges all over the pairs) and asserts
that every source a step or a flag reads lies in the table and was
assigned from the start.

Inputs from tests/v2_cases.py (seeded numpy and the port's v2 index);
every output is an integer or a flag, so the tolerance is 0. No JAX
program runs here.
"""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, '.')

from v2_cases import (chain_election, election_case, v2_arena,  # noqa: E402
                      v2_genomes, v2_rows, votes_case)
from vclust_tpu_torch.ops import align_gpu as ag  # noqa: E402

torch.set_num_threads(1)

FINE = 32
BIG = ag.BIG
K8_SAMPLES = 32768      # csrc/align_v2.cu

# --------------------------------------------------------------------------
# K8
# --------------------------------------------------------------------------


def _descend(sample, v, limit, lo=None, top=None):
    """The kernel's power-of-two descent, for every value of v at once:
    from lo (default 0), the number of consecutive entries of `sample`
    <= v, up to `limit` (an array of exclusive ends) by steps from `top`
    down to 1."""
    u = np.zeros(v.shape, np.int64) if lo is None else lo.copy()
    step = top
    while step:
        at = np.clip(u + step - 1, 0, len(sample) - 1)
        u += np.where((u + step <= limit) & (sample[at] <= v), step, 0)
        step >>= 1
    return u


def k8_model(b, r_rows, q_rows, Lq, Lr, C, samples):
    """K8's votes (R, K, NQ, 4) and the lengths of the equal runs it
    scanned."""
    qsv, qoff = b['qsv'].numpy(), b['qoff'].numpy()
    R, K = q_rows.shape
    NQ = Lq // FINE * C
    dspan = Lq + Lr + 64
    out = np.full((R, K, NQ, 4), BIG, np.int64)
    runs = set()
    for r in range(R):
        g = int(r_rows[r])
        qr = q_rows[r].numpy()
        v = qsv[qr].astype(np.int64)                      # (K, NQ)
        qpos = (np.arange(NQ) // C) * FINE + (qoff[qr] & 31)
        for s, keys in enumerate((('sv_f', 'pk1_f', 'pk2_f'),
                                  ('sv_r', 'pk1_r', 'pk2_r'))):
            sv, pk1, pk2 = (b[k][g].numpy().astype(np.int64) for k in keys)
            NR = len(sv)
            stride = 1
            while -(-NR // stride) > samples:
                stride *= 2
            sample = sv[::stride]
            ns = len(sample)
            top = 1
            while top * 2 <= ns:
                top *= 2
            u = _descend(sample, v, ns, top=top)
            # Between samples u - 1 and u, through the row.
            ub = _descend(sv, v, np.minimum(u * stride, NR),
                          lo=(u - 1) * stride + 1, top=stride >> 1)
            live = (v >= 0) & (u > 0)
            i = ub - 1
            live &= sv[np.clip(i, 0, NR - 1)] == v
            m1 = np.zeros(v.shape, np.int64)
            m2 = np.zeros(v.shape, np.int64)
            run = np.zeros(v.shape, np.int64)
            while live.any():
                ic = np.clip(i, 0, NR - 1)
                m1 = np.where(live, np.maximum(m1, pk1[ic]), m1)
                m2 = np.where(live, np.maximum(m2, pk2[ic]), m2)
                run += live
                i -= 1
                live &= (i >= 0) & (sv[np.clip(i, 0, NR - 1)] == v)
            runs.update(np.unique(run).tolist())
            base = Lq + (dspan if s else 0) - qpos
            if b['pack_bits'] == 32:
                d1 = np.where(((m1 >> 16) == v) & (m1 > 0),
                              (m1 & 0xFFFF) - 1 + base, BIG)
                d2 = np.where(((m2 >> 16) == v) & (m2 > 0),
                              (m2 & 0xFFFF) - 1 + base, BIG)
            else:
                ok = ((m1 >> 40) == v) & (m1 > 0)
                cq = m1 & 0xFFFFF
                d1 = np.where(ok, ((m1 >> 20) & 0xFFFFF) - 1 + base, BIG)
                d2 = np.where(ok & (cq > 0), cq - 1 + base, BIG)
            found = (v >= 0) & (u > 0)
            out[r, :, :, 2 * s] = np.where(found, d1, BIG)
            out[r, :, :, 2 * s + 1] = np.where(found, d2, BIG)
    return out.astype(np.int32), runs


@pytest.mark.parametrize('samples', [K8_SAMPLES, 16])
@pytest.mark.parametrize('C', [1, 8, 16])
@pytest.mark.parametrize('pack', [32, 64])
def test_k8_search_matches_plain(pack, C, samples):
    """K8's search and equal-run max == votes_v2_plain at both pack widths:
    values that occur once, twice and 3+ times (the tandem repeat), values
    absent from the reference (the unrelated genome), the value 0 at
    position 0, invalid query seeds (the N run, the genome of N) and a
    reference row of N only (row 1)."""
    codes = v2_genomes(5, 3300)
    b = v2_arena(codes, 4096, pack, C)
    r_rows, rlens, q_rows, qlens = v2_rows(codes, 6, 3, 8, refs=(0, 5))
    want = ag.votes_v2_plain(b, r_rows, q_rows, Lq=4096, Lr=4096, C=C)
    got, runs = k8_model(b, r_rows, q_rows, 4096, 4096, C, samples)
    assert np.array_equal(got, want.numpy())
    w = want.numpy()
    qsv = b['qsv'][q_rows.long()].numpy()
    assert int(b['sv_f'][0, 0]) == 0 and int(b['qsv'][0, 0]) == 0
    assert (w[0, ..., 0] < BIG).any() and (w[0, ..., 2] < BIG).any()
    assert (w[1] == BIG).all()                          # no valid reference
    assert ((qsv >= 0) & (w[..., 0] == BIG) & (w[..., 2] == BIG)).any()
    assert (qsv < 0).any()
    assert {0, 1} <= runs                     # absent, and once
    if C > 1:
        assert 2 in runs and max(runs) >= 3 and (w[..., 1] < BIG).any()


# --------------------------------------------------------------------------
# K6
# --------------------------------------------------------------------------


def sort_runs(x, frm, seg):
    """The kernel's bitonic network on every row of x (rows, n) at once:
    runs of `frm` sorted become runs of `seg` sorted, each ascending."""
    n = x.shape[1]
    p = np.arange(n // 2)
    k = 2 * frm
    while k <= seg:
        j = k >> 1
        while j:
            i = ((p & ~(j - 1)) << 1) | (p & (j - 1))
            o = i ^ (k - 1) if j == k >> 1 else i + j
            lo, hi = np.minimum(x[:, i], x[:, o]), np.maximum(x[:, i], x[:, o])
            x[:, i], x[:, o] = lo, hi
            j >>= 1
        k <<= 1
    return x


def elect_model(x, w, y, vbits):
    """The kernel's election on rows of sorted votes x[:, :w] and full rows
    y: (mode, its votes)."""
    vmask = (1 << vbits) - 1
    smax = min(ag.SMAX, w - 1)
    xs = x[:, :w]
    xp = np.concatenate([xs, np.full((len(xs), smax), BIG)], axis=1)
    cnt = 1 + sum((xp[:, s:s + w] - xs <= ag.GAP_DIAG).astype(np.int64)
                  for s in range(1, smax + 1))
    eq = 1 + sum((xp[:, s:s + w] == xs).astype(np.int64)
                 for s in range(1, smax + 1))
    ok = xs < BIG
    cnt, eq = np.where(ok, cnt, 0), np.where(ok, eq, 0)
    inv = vmask - np.minimum(xs, vmask)
    best = ((cnt << vbits) | inv).max(axis=1)
    vb = best >> vbits
    start = (vmask - (best & vmask))[:, None]
    inb = (xs >= start) & (xs <= start + ag.GAP_DIAG)
    bm = np.where(inb, (eq << vbits) | inv, -1).max(axis=1)
    medv = np.where(vb > 0, vmask - (bm & vmask), BIG)
    votes = (np.abs(y - medv[:, None]) <= ag.GAP_DIAG).sum(axis=1)
    return medv, np.where(medv < BIG, votes, 0)


def k6_model(votes, Lq, Lr):
    """K6's A, S, D, vb (R, K, NBF) from votes (R, K, NQ, 4)."""
    R, K, NQ, _ = votes.shape
    N, NBF = R * K, Lq // FINE
    NBC, C = NBF // 4, NQ // NBF
    C4 = 4 * C
    P = 1
    while P < C4:
        P *= 2
    dspan = Lq + Lr + 64
    vbits = 22 if 2 * dspan + 64 < 1 << 22 else 32
    v = votes.numpy().astype(np.int64).reshape(N * NBC, 4, C4)
    x = np.full((N * NBC, 4, P), BIG, np.int64)
    x[:, :, :C4] = v
    x = sort_runs(x.reshape(N * NBC, 4 * P), 1, P)
    assert np.array_equal(x.reshape(-1, 4, P), np.sort(
        x.reshape(-1, 4, P), axis=-1))
    fine = [elect_model(x[:, q * P:(q + 1) * P], C4,
                        x[:, q * P:q * P + C4], vbits) for q in range(4)]
    x = sort_runs(x, P, 4 * P)
    assert np.array_equal(x, np.sort(x, axis=-1))
    medv_c, vb_c = elect_model(x[:, 0:4 * C4:4], C4, x[:, :4 * C4], vbits)
    A_c, S_c = vb_c >= ag.MIN_VOTES_C, medv_c >= dspan
    D_c = np.where(S_c, medv_c - dspan, medv_c) - Lq
    out = np.zeros((4, N * NBC, 4), np.int64)
    for q, (medv_f, vb_f) in enumerate(fine):
        sup = (np.abs(v[:, q] - medv_c[:, None]) <= ag.GAP_DIAG).sum(axis=1)
        A_f, S_f = vb_f >= ag.MIN_VOTES_F, medv_f >= dspan
        D_f = np.where(S_f, medv_f - dspan, medv_f) - Lq
        use_f = A_f & (~A_c | (vb_f > sup))
        out[:, :, q] = (use_f | A_c, np.where(use_f, S_f, S_c),
                        np.where(use_f, D_f, D_c),
                        np.where(use_f, vb_f, vb_c))
    shape = (R, K, NBF)
    return (out[0].reshape(shape).astype(bool),
            out[1].reshape(shape).astype(bool),
            out[2].reshape(shape).astype(np.int32),
            out[3].reshape(shape).astype(np.int32))


@pytest.mark.parametrize('wide', [False, True])
@pytest.mark.parametrize('C', [1, 5, 8, 16, 32])
def test_k6_coarse_blocks_match_plain(C, wide):
    """K6's warp-a-coarse-block decomposition == elect_v2_plain, at C = 1-32
    (4C not a power of two at C = 5) and both vote-pack widths (22 bits,
    and 32 where Lr = 2^21 puts 2 DSPAN + 64 past 2^22): equal counts, empty
    blocks, and a fine election that ties its support for the coarse
    mode."""
    Lq = 4096
    Lr = (1 << 21) if wide else 4096
    assert (2 * (Lq + Lr + 64) + 64 >= 1 << 22) == wide
    votes = votes_case(C + 40 * wide, 1, 3, Lq // FINE, C, Lq, Lr)
    want = ag.elect_v2_plain(votes, Lq=Lq, Lr=Lr)
    got = k6_model(votes, Lq, Lr)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    A, S, D, vb = (w.numpy() for w in want)
    assert A.any() and (~A).any() and (A & S).any() and (A & ~S).any()
    assert not A[0, 0, 4:8].any()                 # the empty coarse block
    assert A[0, 0, 0] and D[0, 0, 0] == D[0, 0, 1]   # the coarse mode wins


# --------------------------------------------------------------------------
# K7
# --------------------------------------------------------------------------


def _popc(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def block_masks(b, q_row, r_row, qlen, rlen, Lr, f, d, s):
    """Match masks (bit t: position t of the block) of blocks f at the
    states (d, s): the window of 32 reference bases at f * 32 + d clipped
    to [-32, Lr - 1] (0 where clipped), inside the reference and the
    query, query bases 0-3."""
    r2 = b['r2dov'].numpy()
    fwd = b['fwd'].numpy()
    NRT = r2.shape[1] // 2
    t = np.arange(FINE)
    start = f * FINE + d
    sc = np.clip(start, -FINE, Lr - 1)
    row = (sc + FINE) >> 5
    phase = sc + FINE - (row << 5)
    rb = r2[r_row, (row + np.where(s, NRT, 0))[:, None], phase[:, None] + t]
    qb = fwd[q_row, f[:, None] * FINE + t]
    hit = (rb == qb) & (qb < 4) & (start == sc)[:, None]
    hi = np.minimum(np.minimum(rlen - start, qlen - f * FINE), FINE)
    hit &= (t >= np.maximum(0, -start)[:, None]) & (t < hi[:, None])
    return (hit.astype(np.int64) << t).sum(axis=1)


def k7_model(b, rows, A, S, D, Lr, iters, ext_min, ext_margin, tile):
    """K7's outputs as its tiles form them: m1, m0 (R, K, Lq) and sw, A,
    S, D, Ap, Sp, Dp (R, K, NBF)."""
    r_rows, rlens, q_rows, qlens = (x.numpy() for x in rows)
    R, K, NBF = A.shape
    N = R * K
    A0, S0, D0 = (x.numpy().reshape(N, NBF) for x in (A, S, D))
    E, Cn = iters, 2 * iters + 2
    out = tile - 2 * E - 1        # blocks a tile after the first writes
    assert out >= 1
    tiles = 1 + -(-max(NBF - tile, 0) // out)
    res = {k: np.zeros((N, NBF), dt) for k, dt in (
        ('sw', bool), ('A', bool), ('S', bool), ('D', np.int32),
        ('Ap', bool), ('Sp', bool), ('Dp', np.int32))}
    m1 = np.zeros((N, NBF), np.int64)
    m0 = np.zeros((N, NBF), np.int64)
    i = np.arange(tile)
    for n in range(N):
        r = n // K
        ctx = (q_rows.reshape(-1)[n], r_rows[r], qlens.reshape(-1)[n],
               rlens[r], Lr)
        for t in range(tiles):
            o_t = tile - E + (t - 1) * out if t else 0
            f_lo = o_t - (E + 1) if t else 0
            f_end = NBF if f_lo + tile >= NBF else f_lo + tile - E
            f = f_lo + i
            real = (f >= 0) & (f < NBF)
            fc = np.clip(f, 0, NBF - 1)
            d = np.where(real, D0[n, fc], 0)
            s = np.where(real, S0[n, fc], False)
            a = real & A0[n, fc]
            # The mask table: block i at the initial state of block
            # g = i - E - 1 + c, only for an initially assigned g.
            tab = np.zeros((tile, Cn), np.int64)
            for c in range(Cn):
                g = i - E - 1 + c
                ok = real & (g >= 0) & (g < tile)
                gc = np.clip(g, 0, tile - 1)
                ok &= a[gc]
                tab[ok, c] = block_masks(b, *ctx, f[ok], d[gc][ok],
                                         s[gc][ok])
            a0 = a.copy()
            src = i.copy()
            cc = np.where(a, _popc(tab[:, E + 1]), -1)
            for step in range(2 * E):
                nb = i + (1 if step & 1 else -1)
                nc = np.clip(nb, 0, tile - 1)
                need = real & (nb >= 0) & (nb < tile) & a[nc]
                nsrc = src[nc]
                off = nsrc - i + E + 1
                assert ((off[need] >= 1) & (off[need] <= 2 * E + 1)).all()
                assert a0[nsrc[need]].all()
                cn = np.where(need, _popc(tab[i, np.clip(off, 0, Cn - 1)]),
                              -1)
                better = need & (cn >= ext_min) & (cn > cc + ext_margin)
                d = np.where(better, d[nc], d)
                s = np.where(better, s[nc], s)
                src = np.where(better, nsrc, src)
                a |= better
                cc = np.where(better, cn, cc)
            dp = np.concatenate([[0], d[:-1]])
            sp = np.concatenate([[False], s[:-1]])
            ap = np.concatenate([[False], a[:-1]])
            srcp = np.concatenate([[0], src[:-1]])
            sw = a & ap & ((d != dp) | (s != sp))
            o1, o0 = src - i + E + 1, srcp - i + E + 1
            assert ((o1[a] >= 1) & (o1[a] <= 2 * E + 1)).all()
            assert ((o0[sw] >= 0) & (o0[sw] <= 2 * E)).all()
            w1 = np.where(a, tab[i, np.clip(o1, 0, Cn - 1)], 0)
            w0 = np.where(sw, tab[i, np.clip(o0, 0, Cn - 1)], 0)
            keep = slice(o_t - f_lo, f_end - f_lo)
            fo = f[keep]
            for k, x in (('D', d), ('S', s), ('A', a), ('Dp', dp),
                         ('Sp', sp), ('Ap', ap), ('sw', sw)):
                res[k][n, fo] = x[keep]
            m1[n, fo], m0[n, fo] = w1[keep], w0[keep]
    bits = np.arange(FINE)

    def flags(m):
        return (((m[..., None] >> bits) & 1) == 1).reshape(R, K, NBF * FINE)

    shape = (R, K, NBF)
    return (flags(m1), flags(m0), *(res[k].reshape(shape) for k in (
        'sw', 'A', 'S', 'D', 'Ap', 'Sp', 'Dp')))


def _k7_check(monkeypatch, b, rows, A, S, D, Lr, knobs, tile):
    for name, v in zip(('EXT_ITERS', 'EXT_MIN', 'EXT_MARGIN'), knobs):
        monkeypatch.setattr(ag, name, v)
    r_rows, rlens, q_rows, qlens = rows
    want = ag.propagate_v2_plain(b, r_rows, rlens, q_rows, qlens, A, S, D,
                                 Lr=Lr)
    got = k7_model(b, rows, A, S, D, Lr, *knobs, tile)
    for g, w in zip(got, want):
        assert g.dtype == w.numpy().dtype and np.array_equal(g, w.numpy())
    return got


@pytest.mark.parametrize('Lp,knobs,tile', [
    (4096, (3, 17, 4), 16), (4096, (3, 17, 4), 128), (4096, (0, 17, 4), 8),
    (4096, (16, 17, 4), 40), (6144, (16, 12, 0), 128),
    (6144, (3, 17, 4), 128), (6144, (5, 20, 8), 24)])
def test_k7_tiles_match_plain(monkeypatch, Lp, knobs, tile):
    """K7's tiles with halos and mask tables == propagate_v2_plain, every
    output, on elections of the index genomes with blocks unassigned,
    diagonals moved and windows clipped at -32 and past Lr - 1: adoption,
    strand switches (the mosaic, the reverse complement) and tile edges
    all over the pairs (NBF 128 and 192 against tiles of 8-128)."""
    codes = v2_genomes(7, Lp - 700)
    b = v2_arena(codes, Lp, 32, 16)
    rows = v2_rows(codes, 8, 2, 4, refs=(0, 3))
    A, S, D = election_case(b, rows, Lp, Lp, 16, 9)
    got = _k7_check(monkeypatch, b, rows, A, S, D, Lp, knobs, tile)
    NBF = Lp // FINE
    f = np.arange(NBF)
    start = f * FINE + D.numpy()
    assert (A.numpy() & (start < -FINE)).any()
    assert (A.numpy() & (start > Lp - 1)).any()
    sw, S, Sp = got[2], got[4], got[7]
    assert (sw & (S != Sp)).any()                 # a strand switch
    assert (got[3] & S).any() and (got[3] & ~S).any()
    if knobs[0]:
        assert (got[3] & ~A.numpy()).any()            # something adopted


@pytest.mark.parametrize('Lp,c0,tile', [(4096, 12, 16), (4096, 13, 16),
                                        (4096, 22, 16), (6144, 124, 128),
                                        (6144, 125, 128)])
def test_k7_chain_across_tile_edge(monkeypatch, Lp, c0, tile):
    """A state handed on block by block across a tile's edge (tile t >= 1
    writes from T - EXT_ITERS + (t - 1)(T - 2 EXT_ITERS - 1)): the
    reference against itself and its mutant from one assigned block."""
    iters = 3
    codes = v2_genomes(7, Lp - 700)
    b = v2_arena(codes, Lp, 32, 16)
    r_rows = torch.tensor([0], dtype=torch.int32)
    q_rows = torch.tensor([[0, 1]], dtype=torch.int32)
    lens = torch.tensor([len(c) for c in codes], dtype=torch.int32)
    rows = (r_rows, lens[r_rows.long()], q_rows, lens[q_rows.long()])
    A, S, D = chain_election(q_rows, Lp // FINE, c0)
    got = _k7_check(monkeypatch, b, rows, A, S, D, Lp, (iters, 17, 4), tile)
    assert got[3][0, :, c0 - iters:c0 + iters + 1].all()
    assert int(got[3].sum()) == 2 * (2 * iters + 1)
