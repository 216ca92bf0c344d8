"""Models, in numpy, of how the kernels of csrc/align_v2.cu do the v2 front
end's work, held against the plain versions on the CPU.

K6 (`front_kernel`, K8 fused in): a CTA takes one reference row and a run
of (query, coarse block) items of it, and stages a directory of each
strand's sorted seed values: every s-th value (s the least power of two
with at most DIR_SAMPLES samples), as a complete search tree in
breadth-first order. A warp takes an item; lanes 8q .. 8q + 7 take fine
block q's seeds. A seed's search is a branch-free descent of the tree,
then the segment between two samples read 16 bytes at a time, then pk1 at
the end of the run of entries equal to the seed's value and at the entry
before it (the plain version's stable sort join and running max give the
same on `_index_block`'s packs, whose order the model checks). The votes stay
in registers: each lane sorts its own by a network, shuffle merges sort
each fine block's votes over 8 lanes and then the coarse block's over the
warp; the window counts read the next lanes by shuffles and count by a
binary search (the window ascends); the coarse sample
is registers 0, 4, ... of every lane; the support for the coarse mode
counts the lane's votes again. The model runs the search with small
directories (s up to 64), the lanes and their shuffles on every coarse
block at once, and the two together.

K7 (`propagate_v2_kernel`): a warp takes a tile of T blocks of one pair,
EXT_ITERS + 1 blocks of halo on its left and EXT_ITERS on its right.
`k7_model` is the kernel's first design: each block's match masks at the
initial states of the initially assigned blocks of [i - EXT_ITERS - 1,
i + EXT_ITERS] evaluated before the first step, the steps carrying each
block's source block; it asserts that every source a step or a flag reads
lies in that window and was assigned from the start, which the present
design rests on. `k7_lazy_model` is the present design: each assigned
block's own mask; a state carries the first block of its run of one
state; before every step from the block before, the masks at both
neighbours' current states that the table lacks, listed and evaluated;
the masks built from the window's aligned 16-byte pieces, bits
transposed; two steps without an adoption end the steps. Both run tiles
of 8 to 128 blocks (edges all over the pairs).

Inputs from tests/v2_cases.py (seeded numpy and the port's v2 index);
every output is an integer or a flag, so the tolerance is 0. No JAX
program runs here.
"""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, '.')

from v2_cases import (CRAFTED, chain_election, clipped_election,  # noqa
                      crafted_case, distinct_election, election_case,
                      relay_election, v2_arena, v2_genomes, v2_rows,
                      votes_case)
from vclust_tpu_torch.ops import align_gpu as ag  # noqa: E402

torch.set_num_threads(1)

FINE = 32
BIG = ag.BIG
DIR_SAMPLES = 16384     # csrc/align_v2.cu: the directory's samples a strand
TOP = 0xFFFF            # csrc/align_v2.cu: the largest seed value (SEED_K 8)

# --------------------------------------------------------------------------
# K6's search: the seeds' votes (what K8 computed)
# --------------------------------------------------------------------------


def dir_geometry(NR, most=DIR_SAMPLES):
    """The directory of a reference row of NR sorted values: the stride s
    (the least power of two from 4 with ceil(NR / s) <= most), the
    samples ns and the tree's levels H (2^H - 1 nodes hold samples 1 ..
    ns - 1)."""
    s = 4
    while -(-NR // s) > most:
        s *= 2
    ns = -(-NR // s)
    return s, ns, max(1, (ns - 1).bit_length())


def directory(sv, s, ns, H):
    """The kernel's staged directory of one strand: T[k], k = 1 .. 2^H - 1,
    the nodes of a complete search tree in breadth-first order; in-order
    node m holds sample m + 1 (sv[(m + 1) s]) in 16 bits, BIG (and past
    the samples) as TOP."""
    T = np.full(1 << H, TOP, np.int64)
    for i in range(1, min(ns, 1 << H)):
        d = H - 1 - ((i & -i).bit_length() - 1)        # H - 1 - ctz(i)
        T[(1 << d) + (i >> (H - d))] = min(sv[i * s], TOP)
    return T


def valid_tail(sv, s, ns):
    """What the CTA finds at staging: the row's valid entries (< BIG), from
    its last valid sample's segment, and whether the last holds TOP."""
    valid = [i for i in range(ns) if sv[i * s] < BIG]
    if not valid:
        return 0, False
    lo = valid[-1] * s
    seg = sv[lo:min(lo + s, len(sv))]
    nv = lo + int((seg < BIG).sum())
    return nv, bool(sv[nv - 1] == TOP)


def dir_search(sv, v, s, ns, H):
    """For every value of v at once, as the kernel finds them: the entries
    <= v (ub) and those == v at the end of them (eqc). The descent gives
    the samples 1 .. ns - 1 <= v (g); the entries <= v and == v of the
    segment [g s, g s + s) come from 16-byte loads, none past NR, each only
    while every entry before it was <= v. TOP, which the directory cannot
    tell from BIG, takes the row's valid entries (valid_tail)."""
    NR = len(sv)
    T = directory(sv, s, ns, H)
    k = np.ones(v.shape, np.int64)
    for _ in range(H):
        k = 2 * k + (T[k] <= v)
    seg0 = (k - (1 << H)) * s
    live = v >= 0
    cnt = np.zeros(v.shape, np.int64)
    eqc = np.zeros(v.shape, np.int64)
    assert NR % 4 == 0 and s >= 4
    for o in range(0, s, 4):
        ok = live & (v != TOP) & (seg0 + o < NR) & (cnt == o)
        for e in range(4):
            x = sv[np.clip(seg0 + o + e, 0, NR - 1)]
            cnt += ok & (x <= v)
            eqc += ok & (x == v)
    nv, last_top = valid_tail(sv, s, ns)
    top = v == TOP
    return np.where(top, nv, seg0 + cnt), np.where(top, int(last_top), eqc)


def check_pack_order(sv, pk1, pk2, pack):
    """What the kernel takes from `_index_block`: inside a run of one
    value the positions ascend, and pk2 of an entry is the position of the
    entry before it where the two hold one value (0 where not), so the
    plain version's maxes over a run are pk1 and pk2 of its last entry."""
    same = np.zeros(len(sv), bool)
    same[1:] = (sv[1:] == sv[:-1]) & (sv[1:] < BIG)
    if pack == 32:
        pos = pk1 & 0xFFFF
        prev = np.where(same, (sv << 16) | np.roll(pos, 1), 0)
        assert np.array_equal(pk2, np.where(sv < BIG, prev, 0))
    else:
        pos = (pk1 >> 20) & 0xFFFFF
        assert np.array_equal(pk1 & 0xFFFFF, np.where(same, np.roll(pos, 1),
                                                      0) * (sv < BIG))
    assert (pos[1:][same[1:]] > pos[:-1][same[1:]]).all()


def k8_model(b, r_rows, q_rows, Lq, Lr, C, most):
    """The fused kernel's votes (R, K, NQ, 4) and the lengths of the runs
    of entries equal to the seeds' values (0 where absent): the search,
    then pk1 at the run's last entry ub - 1 and, for 32-bit packs, at the
    entry before it (its value checked in the pack's top bits)."""
    qsv, qoff = b['qsv'].numpy(), b['qoff'].numpy()
    R, K = q_rows.shape
    NQ = Lq // FINE * C
    dspan = Lq + Lr + 64
    pack = b['pack_bits']
    out = np.full((R, K, NQ, 4), BIG, np.int64)
    runs = set()
    for r in range(R):
        g = int(r_rows[r])
        qr = q_rows[r].numpy()
        v = qsv[qr].astype(np.int64)                      # (K, NQ)
        qpos = (np.arange(NQ) // C) * FINE + (qoff[qr] & 31)
        for s_, keys in enumerate((('sv_f', 'pk1_f', 'pk2_f'),
                                   ('sv_r', 'pk1_r', 'pk2_r'))):
            sv, pk1, pk2 = (b[k][g].numpy().astype(np.int64) for k in keys)
            check_pack_order(sv, pk1, pk2, pack)
            NR = len(sv)
            s, ns, H = dir_geometry(NR, most)
            ub, eqc = dir_search(sv, v, s, ns, H)
            found = eqc > 0
            m1 = np.where(found, pk1[np.clip(ub - 1, 0, NR - 1)], 0)
            m0 = np.where(found & (ub >= 2), pk1[np.clip(ub - 2, 0, NR - 1)],
                          0)
            runs.update(np.unique(np.searchsorted(sv, v, 'right')
                                  - np.searchsorted(sv, v)).tolist())
            base = Lq + (dspan if s_ else 0) - qpos
            if pack == 32:
                d1 = np.where(((m1 >> 16) == v) & (m1 > 0),
                              (m1 & 0xFFFF) - 1 + base, BIG)
                d2 = np.where(((m0 >> 16) == v) & (m0 > 0),
                              (m0 & 0xFFFF) - 1 + base, BIG)
            else:
                ok = ((m1 >> 40) == v) & (m1 > 0)
                cq = m1 & 0xFFFFF
                d1 = np.where(ok, ((m1 >> 20) & 0xFFFFF) - 1 + base, BIG)
                d2 = np.where(ok & (cq > 0), cq - 1 + base, BIG)
            out[r, :, :, 2 * s_] = np.where(found, d1, BIG)
            out[r, :, :, 2 * s_ + 1] = np.where(found, d2, BIG)
    return out.astype(np.int32), runs


@pytest.mark.parametrize('C,most,s', [(1, 16384, 4), (8, 256, 4),
                                      (16, 256, 8), (8, 64, 16),
                                      (32, 128, 32), (32, 64, 64)])
@pytest.mark.parametrize('pack', [32, 64])
def test_k8_search_matches_plain(pack, C, most, s):
    """The fused kernel's search (a descent over a breadth-first directory
    of every s-th sorted value, 16-byte loads between two samples, pk1 at
    the end of the equal run) == votes_v2_plain at both pack widths, s
    from 4 (the kernel's least) to 64: values that occur once, twice and
    3+ times (the tandem repeat), values absent from the reference (the
    unrelated genome), the value 0 at position 0, invalid query seeds (the
    N run, the genome of N) and a reference row of N only (row 1). The
    kernel's directory holds DIR_SAMPLES samples; `most` shrinks it here
    so that s reaches 64 on small rows."""
    codes = v2_genomes(5, 3300)
    b = v2_arena(codes, 4096, pack, C)
    assert dir_geometry(b['sv_f'].shape[1], most)[0] == s
    r_rows, rlens, q_rows, qlens = v2_rows(codes, 6, 3, 8, refs=(0, 5))
    want = ag.votes_v2_plain(b, r_rows, q_rows, Lq=4096, Lr=4096, C=C)
    got, runs = k8_model(b, r_rows, q_rows, 4096, 4096, C, most)
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


@pytest.mark.parametrize('C,most', [(16, 16384), (16, 128), (8, 256)])
@pytest.mark.parametrize('pack', [32, 64])
def test_k8_search_top_value(pack, C, most):
    """Seeds of the value TOP (TTTTTTTT), which the 16-bit directory holds
    as it holds BIG: a reference with a poly-T run (a run of TOP entries
    across several segments, then BIG), queried by itself and by a mutant
    with the run, and a reference row with no TOP entry; == votes_v2_plain."""
    codes = v2_genomes(5, 3300)
    for g in (0, 1):
        codes[g][2000:2100] = 3
    b = v2_arena(codes, 4096, pack, C)
    r_rows, _, q_rows, _ = v2_rows(codes, 6, 3, 8, refs=(0, 4, 1))
    q_rows[1, :2] = torch.tensor([0, 1])
    want = ag.votes_v2_plain(b, r_rows, q_rows, Lq=4096, Lr=4096, C=C)
    got = k8_model(b, r_rows, q_rows, 4096, 4096, C, most)[0]
    assert np.array_equal(got, want.numpy())
    sv = b['sv_f'][0].numpy()
    s = dir_geometry(len(sv), most)[0]
    assert (sv == TOP).sum() > s and (sv == BIG).any()
    top = b['qsv'][q_rows.long()].numpy() == TOP
    w = want.numpy()
    assert top[0].any() and (w[0][top[0]][:, 0] < BIG).any()
    assert top[1].any() and (w[1][top[1]][:, 0] == BIG).all()


# --------------------------------------------------------------------------
# K6's election: a warp a coarse block, the votes in registers
# --------------------------------------------------------------------------


def lane_regs(C):
    """Seeds a lane (ceil(C / 8)) and the votes a lane holds, V (4 a seed,
    padded to a power of two)."""
    spl = -(-C // 8)
    return spl, 4 if spl == 1 else 8 if spl == 2 else 16


def to_lanes(votes, C):
    """The coarse blocks' votes as the kernel holds them, X (blocks, 32, V):
    lane 8q + l holds the votes of seeds l, l + 8, ... of fine block q,
    register 4t + j vote j of seed l + 8t; BIG where there is no seed and
    past 4 ceil(C / 8)."""
    R, K, NQ, _ = votes.shape
    NBC = NQ // C // 4
    spl, V = lane_regs(C)
    v = votes.numpy().astype(np.int64).reshape(R * K * NBC, 4, C, 4)
    X = np.full((R * K * NBC, 32, V), BIG, np.int64)
    for lane in range(32):
        for t in range(spl):
            c = (lane & 7) + 8 * t
            if c < C:
                X[:, lane, 4 * t:4 * t + 4] = v[:, lane >> 3, c]
    return X


def _ce(X, i, j):
    lo, hi = np.minimum(X[..., i], X[..., j]), np.maximum(X[..., i], X[..., j])
    X[..., i], X[..., j] = lo, hi


def sort_lane(X):
    """Each lane's V registers ascending: a bitonic network whose first
    step of each merge compares mirrored registers."""
    V = X.shape[-1]
    i = np.arange(V)
    k = 2
    while k <= V:
        p = i ^ (k - 1)
        _ce(X, i[i < p], p[i < p])
        j = k >> 2
        while j:
            p = i ^ j
            _ce(X, i[i < p], p[i < p])
            j >>= 1
        k <<= 1


def merge_lanes(X, m):
    """Runs of m lanes (ascending, lane-major) become runs of 2m: the
    mirrored step by a shuffle over 2m - 1 (register V - 1 - i of the
    partner), half cleaners by shuffles over m/2 .. 1, then in the lane."""
    V = X.shape[-1]
    lane = np.arange(32)
    low = ((lane & m) == 0)[:, None]
    Y = X[:, lane ^ (2 * m - 1), ::-1]
    X[:] = np.where(low, np.minimum(X, Y), np.maximum(X, Y))
    mm = m >> 1
    while mm:
        low = ((lane & mm) == 0)[:, None]
        Y = X[:, lane ^ mm]
        X[:] = np.where(low, np.minimum(X, Y), np.maximum(X, Y))
        mm >>= 1
    i = np.arange(V)
    j = V >> 1
    while j:
        p = i ^ j
        _ce(X, i[i < p], p[i < p])
        j >>= 1


def window_counts(X, span):
    """Each value's count of the values within GAP_DIAG among the next SMAX
    of the lane-major list of `span` lanes, and of those equal (0 for
    BIG): the next SMAX values come from the lane's own registers and
    from lanes + 1, + 2, ... by shuffles, BIG past the span; they ascend,
    so each count is a binary search (count_le)."""
    n = X.shape[-1]
    lane = np.arange(32)
    nx = np.empty(X.shape[:2] + (n + ag.SMAX,), np.int64)
    nx[..., :n] = X
    for j in range(ag.SMAX):
        d = 1 + j // n
        src = np.minimum(lane + d, 31)
        nx[..., n + j] = np.where(((lane % span) + d < span)[None],
                                  X[:, src, j % n], BIG)
    assert (np.diff(nx, axis=-1) >= 0).all()          # the window ascends
    ok = X < BIG
    return (np.where(ok, 1 + count_le(nx, X + ag.GAP_DIAG), 0),
            np.where(ok, 1 + count_le(nx, X), 0))


def count_le(nx, lim):
    """The kernel's count of nx[i + 1 .. i + SMAX] <= lim[i] for each of
    the n values of a lane (nx holds n + SMAX, ascending): a binary search
    of four steps, k grows by 8, 4, 2, 1 where nx[i + k + step] <= lim."""
    n = lim.shape[-1]
    i = np.arange(n)
    k = np.zeros(lim.shape, np.int64)
    for step in (8, 4, 2, 1):
        at = np.broadcast_to(i + k + step, lim.shape)
        k += np.where(np.take_along_axis(nx, at, axis=-1) <= lim, step, 0)
    return k


def reduce_span(x, span, op):
    """A reduction over each group of `span` lanes (shuffles over span/2
    .. 1), every lane of the group holding the result."""
    B = x.shape[0]
    r = op(x.reshape(B, 32 // span, span), axis=2)
    return np.repeat(r, span, axis=1)


def elect_lanes(W, span, Y, vbits):
    """The election on the list W (lane-major over groups of `span`
    lanes), its exact votes counted over Y: (mode, votes) a lane."""
    vmask = (1 << vbits) - 1
    cnt, eq = window_counts(W, span)
    inv = vmask - np.minimum(W, vmask)
    best = reduce_span(((cnt << vbits) | inv).max(axis=2), span, np.max)
    vb = best >> vbits
    start = (vmask - (best & vmask))[..., None]
    inb = (W >= start) & (W <= start + ag.GAP_DIAG)
    bm = reduce_span(np.where(inb, (eq << vbits) | inv, -1).max(axis=2),
                     span, np.max)
    medv = np.where(vb > 0, vmask - (bm & vmask), BIG)
    n = (np.abs(Y - medv[..., None]) <= ag.GAP_DIAG).sum(axis=2)
    return medv, np.where(medv < BIG, reduce_span(n, span, np.sum), 0)


def k6_model(votes, Lq, Lr, C, coarse=False):
    """The fused kernel's A, S, D, vb (R, K, NBF) from the votes (R, K, NQ,
    4) as its warps hold them (to_lanes); with `coarse` the coarse mode
    and votes of every block instead."""
    R, K, NQ, _ = votes.shape
    NBF = Lq // FINE
    dspan = Lq + Lr + 64
    vbits = 22 if 2 * dspan + 64 < 1 << 22 else 32
    X = to_lanes(votes, C)
    Y = X.copy()                       # the support reads the votes again
    sort_lane(X)
    for m in (1, 2, 4):
        merge_lanes(X, m)
    assert np.array_equal(X.reshape(-1, 4, 8 * X.shape[-1]),
                          np.sort(Y.reshape(-1, 4, 8 * X.shape[-1]), axis=-1))
    medv_f, vb_f = elect_lanes(X, 8, X, vbits)
    for m in (8, 16):
        merge_lanes(X, m)
    assert np.array_equal(X.reshape(len(X), -1),
                          np.sort(Y.reshape(len(X), -1), axis=-1))
    # The sample, every fourth of the sorted list: registers 0, 4, ...
    medv_c, vb_c = elect_lanes(X[..., ::4], 32, X, vbits)
    if coarse:
        return medv_c[:, 0], vb_c[:, 0]
    sup = reduce_span((np.abs(Y - medv_c[..., None]) <= ag.GAP_DIAG).sum(
        axis=2), 8, np.sum)
    A_c, S_c = vb_c >= ag.MIN_VOTES_C, medv_c >= dspan
    D_c = np.where(S_c, medv_c - dspan, medv_c) - Lq
    A_f, S_f = vb_f >= ag.MIN_VOTES_F, medv_f >= dspan
    D_f = np.where(S_f, medv_f - dspan, medv_f) - Lq
    use_f = A_f & (~A_c | (vb_f > sup))
    # Lane 8q writes fine block q.
    shape = (R, K, NBF)
    pick = (slice(None), slice(0, 32, 8))
    return ((use_f | A_c)[pick].reshape(shape),
            np.where(use_f, S_f, S_c)[pick].reshape(shape),
            np.where(use_f, D_f, D_c)[pick].reshape(shape).astype(np.int32),
            np.where(use_f, vb_f, vb_c)[pick].reshape(shape).astype(
                np.int32))


@pytest.mark.parametrize('wide', [False, True])
@pytest.mark.parametrize('C', [1, 5, 8, 16, 32])
def test_k6_coarse_blocks_match_plain(C, wide):
    """The fused kernel's election, a warp a coarse block with the votes in
    registers (lane-major sorts: in-lane networks, shuffle merges; window
    counts from the next lanes; the coarse sample from registers 0, 4, ...)
    == elect_v2_plain, at C = 1-32 (4C not a power of two at C = 5, lanes
    without a seed at C < 8) and both vote-pack widths (22 bits, and 32
    where Lr = 2^21 puts 2 DSPAN + 64 past 2^22): equal counts, empty
    blocks, and a fine election that ties its support for the coarse
    mode."""
    Lq = 4096
    Lr = (1 << 21) if wide else 4096
    assert (2 * (Lq + Lr + 64) + 64 >= 1 << 22) == wide
    votes = votes_case(C + 40 * wide, 1, 3, Lq // FINE, C, Lq, Lr)
    want = ag.elect_v2_plain(votes, Lq=Lq, Lr=Lr)
    got = k6_model(votes, Lq, Lr, C)
    for g, w in zip(got, want):
        assert g.dtype == w.numpy().dtype and np.array_equal(g, w.numpy())
    A, S, D, vb = (w.numpy() for w in want)
    assert A.any() and (~A).any() and (A & S).any() and (A & ~S).any()
    assert not A[0, 0, 4:8].any()                 # the empty coarse block
    assert A[0, 0, 0] and D[0, 0, 0] == D[0, 0, 1]   # the coarse mode wins


@pytest.mark.parametrize('C', [5, 16])
def test_k6_votes_permuted_in_blocks(C):
    """The election does not depend on where the votes sit: permuted
    inside each fine block (seeds and strands), the model gives the same
    A, S, D and vb; permuted across each coarse block's 16C votes, the
    same coarse mode and votes."""
    Lq = Lr = 4096
    NBF = Lq // FINE
    votes = votes_case(60 + C, 2, 2, NBF, C, Lq, Lr)
    want = ag.elect_v2_plain(votes, Lq=Lq, Lr=Lr)
    rng = np.random.default_rng(C)
    v = votes.numpy().reshape(-1, 4 * C)
    fine = torch.from_numpy(rng.permuted(v, axis=1).reshape(votes.shape))
    for g, w in zip(k6_model(fine, Lq, Lr, C), want):
        assert np.array_equal(g, w.numpy())
    coarse = torch.from_numpy(rng.permuted(v.reshape(-1, 16 * C), axis=1)
                              .reshape(votes.shape))
    medv, vb = k6_model(votes, Lq, Lr, C, coarse=True)
    medv_p, vb_p = k6_model(coarse, Lq, Lr, C, coarse=True)
    assert np.array_equal(medv, medv_p) and np.array_equal(vb, vb_p)
    assert (vb > 0).any() and not np.array_equal(coarse, votes)


@pytest.mark.parametrize('Lq,C,pack', CRAFTED)
def test_crafted_arena_gives_crafted_votes(Lq, C, pack):
    """The arena of tests/v2_cases.py:crafted_arena, on which the card
    holds the fused kernel against the plain pair, makes votes_v2_plain
    give votes_case's crafted votes (moved as one per coarse block): each
    fine block's the same multiset, so the same election, ties included
    (the empty coarse block, the fine election that ties its support for
    the coarse mode)."""
    b, r_rows, q_rows, moved = crafted_case(Lq, C, pack)
    R, K = q_rows.shape
    votes = ag.votes_v2_plain(b, r_rows, q_rows, Lq=Lq, Lr=Lq, C=C)
    assert torch.equal(votes.view(moved.shape).sort(dim=-1).values,
                       moved.sort(dim=-1).values)
    want = ag.elect_v2_plain(moved.view(R, K, -1, 4), Lq=Lq, Lr=Lq)
    got = ag.elect_v2_plain(votes, Lq=Lq, Lr=Lq)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    A, _, D, _ = got
    assert A.any() and not A.all()
    assert not A[0, 0, 4:8].any()                 # the empty coarse block
    assert A[0, 0, 0] and D[0, 0, 0] == D[0, 0, 1]   # the coarse mode wins


@pytest.mark.parametrize('pack,C', [(32, 16), (64, 8)])
def test_fused_front_matches_plain_pair(pack, C):
    """The fused kernel as a whole, search then election, ==
    elect_v2_plain(votes_v2_plain(...)) on the index genomes."""
    codes = v2_genomes(9, 3300)
    b = v2_arena(codes, 4096, pack, C)
    r_rows, _, q_rows, _ = v2_rows(codes, 10, 2, 8, refs=(0, 3))
    votes = ag.votes_v2_plain(b, r_rows, q_rows, Lq=4096, Lr=4096, C=C)
    want = ag.elect_v2_plain(votes, Lq=4096, Lr=4096)
    got_votes = k8_model(b, r_rows, q_rows, 4096, 4096, C, DIR_SAMPLES)[0]
    assert np.array_equal(got_votes, votes.numpy())
    got = k6_model(torch.from_numpy(got_votes), 4096, 4096, C)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
    assert want[0].any()


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


# --------------------------------------------------------------------------
# K7 as the kernel forms it: own masks, masks listed when first needed,
# 16-byte pieces
# --------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def range_t(lo, hi):
    """The transposed bits (8 j + k is position 4 k + j) of positions
    [lo, hi), as the kernel's k7_range forms them."""
    m = np.zeros(np.shape(lo), np.int64)
    for j in range(4):
        k0 = (lo - j + 3) >> 2
        k1 = (hi - j + 3) >> 2
        m |= (((1 << k1) - 1) & ~((1 << k0) - 1) & 0xFF) << (8 * j)
    return m


def masks_16b(b, q_row, r_row, qlen, rlen, Lr, f, d, s):
    """Transposed match masks of blocks f at states (d, s), as k7_mask
    forms them: the window's 2 or 3 aligned 16-byte pieces of its 64-byte
    row (asserted inside the row), the words selected by bits 1 and 0 of
    the word offset, funnel-shifted to the phase, a byte equal where
    (r ^ q') + 0x7F7F7F7F clears its top bit (q' = q, N made 0x44), the
    positions kept clipped to the reference and the query."""
    r2 = b['r2dov'].numpy()
    fwd = b['fwd'].numpy()
    NRT = r2.shape[1] // 2
    f, d, s = (np.asarray(x, np.int64) for x in (f, d, s))
    start = f * FINE + d
    sc = np.clip(start, -FINE, Lr - 1)
    t_lo = np.maximum(0, -start)
    t_hi = np.minimum(FINE, np.minimum(rlen - start, qlen - f * FINE))
    keep = (start == sc) & (t_hi > t_lo)
    row = (sc + FINE) >> 5
    phase = sc + FINE - (row << 5)
    c0 = phase >> 4
    three = (phase & 15) != 0
    assert (c0 + np.where(three, 2, 1) <= 3).all()
    rows = r2[r_row, row + np.where(s, NRT, 0)]            # (n, 64) int8
    pieces = np.zeros((len(f), 48), np.uint8)
    for p in range(3):
        c = np.minimum(c0 + p, 3)
        got = np.take_along_axis(rows.view(np.uint8),
                                 (16 * c)[:, None] + np.arange(16), 1)
        pieces[:, 16 * p:16 * p + 16] = np.where(
            (p < 2) | three[:, None], got, 0)
    w = pieces.view('<u4').astype(np.int64)                 # (n, 12)
    wo = (phase >> 2) & 3
    v = np.where((wo & 2)[:, None] != 0, w[:, 2:12], w[:, 0:10])
    u = np.where((wo & 1)[:, None] != 0, v[:, 1:10], v[:, 0:9])
    sh = 8 * (phase & 3)
    q = fwd[q_row, f[:, None] * FINE + np.arange(FINE)].astype(np.uint8)
    qw = q.copy().view('<u4').astype(np.int64)              # (n, 8)
    qx = qw | ((qw & 0x04040404) << 4)
    m = np.zeros(len(f), np.int64)
    for k in range(8):     # a left shift's wrap leaves the low 32 bits
        r = (u[:, k] >> sh | u[:, k + 1] << (32 - sh)) & M32
        y = ((r ^ qx[:, k]) + 0x7F7F7F7F) & M32
        m |= ((~y & M32) >> (7 - k)) & (0x01010101 << k)
    part = (t_lo > 0) | (t_hi < FINE)
    m = np.where(part, m & range_t(np.where(keep, t_lo, 0),
                                   np.where(keep, t_hi, 1)), m)
    return np.where(keep, m, 0)


def untranspose(m):
    """Flags (..., 32) of transposed masks: position 4 k + j is bit
    8 j + k."""
    p = np.arange(FINE)
    return ((m[..., None] >> (8 * (p % 4) + p // 4)) & 1) == 1


def k7_lazy_model(b, rows, A, S, D, Lr, iters, ext_min, ext_margin,
                  tile=128):
    """K7's outputs as the redesigned kernel forms them, tile by tile:
    each assigned block's own mask; runs of one state (a state carries its
    run's first block); before every step from the block before (the
    first, the third, ...), the masks at both neighbours' current states
    that the table lacks, listed and evaluated (asserted: each at its
    neighbour's state, in a slot of [0, 2 EXT_ITERS + 2)), which covers
    that step and the next; the steps stopped after two without an
    adoption; the masks at the previous blocks' final states where they
    are switchable. Every mask the steps and flags read is asserted to be
    the block's own or in the table. Returns the nine outputs and the
    number of masks evaluated beyond the own ones."""
    r_rows, rlens, q_rows, qlens = (x.numpy() for x in rows)
    R, K, NBF = A.shape
    N = R * K
    A0, S0, D0 = (x.numpy().reshape(N, NBF) for x in (A, S, D))
    E, Cn = iters, 2 * iters + 2
    out = tile - 2 * E - 1
    assert out >= 1
    tiles = 1 + -(-max(NBF - tile, 0) // out)
    res = {k: np.zeros((N, NBF), dt) for k, dt in (
        ('sw', bool), ('A', bool), ('S', bool), ('D', np.int32),
        ('Ap', bool), ('Sp', bool), ('Dp', np.int32))}
    m1 = np.zeros((N, NBF), np.int64)
    m0 = np.zeros((N, NBF), np.int64)
    i = np.arange(tile)
    tasks = 0
    for n in range(N):
        r = n // K
        ctx = (q_rows.reshape(-1)[n], r_rows[r], qlens.reshape(-1)[n],
               rlens[r], Lr)
        for t in range(tiles):
            o_t = tile - E + (t - 1) * out if t else 0
            f_lo = o_t - (E + 1) if t else 0
            f_end = NBF if f_lo + tile >= NBF else f_lo + tile - E
            f = f_lo + i
            real = f < NBF
            fc = np.minimum(f, NBF - 1)
            d0 = np.where(real, D0[n, fc], 0)
            s0 = real & S0[n, fc]
            a0 = real & A0[n, fc]
            own = np.zeros(tile, np.int64)
            own[a0] = masks_16b(b, *ctx, f[a0], d0[a0], s0[a0])
            cont = np.zeros(tile, bool)
            cont[1:] = a0[:-1] & a0[1:] & (d0[1:] == d0[:-1]) & (
                s0[1:] == s0[:-1])
            start = a0 & ~cont
            src = np.maximum.accumulate(np.where(start, i, 0))
            d, s, a = d0.copy(), s0.copy(), a0.copy()
            cc = np.where(a0, _popc(own), -1)
            tab = np.zeros((Cn, tile), np.int64)
            done = np.zeros((Cn, tile), bool)

            def slot(g):
                return np.maximum(g, i - E - 1) - (i - E - 1)

            def neighbours(after):
                k = 1 if after else -1
                nd, ns, na, ng = (np.roll(x, -k) for x in (d, s, a, src))
                edge = tile - 1 if after else 0
                nd[edge], ns[edge], na[edge], ng[edge] = 0, False, False, 0
                return nd, ns, na, ng

            def own_state(nd, ns):
                return a0 & (nd == d0) & (ns == s0)

            def evaluate(want, nd, ns, ng):
                c = slot(ng)
                w = np.flatnonzero(want)
                assert ((c[w] >= 0) & (c[w] < Cn)).all()
                assert not done[c[w], w].any()
                g = ng[w]
                assert (d0[g] == nd[w]).all() and (s0[g] == ns[w]).all()
                assert a0[g].all()
                tab[c[w], w] = masks_16b(b, *ctx, f[w], d0[g], s0[g])
                done[c[w], w] = True
                return len(w)

            def lookup(use, nd, ns, ng):
                mine = own_state(nd, ns)
                c = np.clip(slot(ng), 0, Cn - 1)
                assert (mine | done[c, i] | ~use).all()
                return np.where(mine, own, tab[c, i])

            def need_of(nd, ns, na):
                return real & na & ~((cc >= 0) & (nd == d) & (ns == s))

            quiet = 0
            for step in range(2 * E):
                if quiet == 2:
                    break
                if step % 2 == 0:      # before a step from the block before
                    for after in (False, True):
                        nd, ns, na, ng = neighbours(after)
                        want = need_of(nd, ns, na) & ~own_state(nd, ns)
                        want &= ~done[np.clip(slot(ng), 0, Cn - 1), i]
                        tasks += evaluate(want, nd, ns, ng)
                nd, ns, na, ng = neighbours(step & 1)
                need = need_of(nd, ns, na)
                cn = np.where(need, _popc(lookup(need, nd, ns, ng)), -1)
                better = need & (cn >= ext_min) & (cn > cc + ext_margin)
                d = np.where(better, nd, d)
                s = np.where(better, ns, s)
                src = np.where(better, ng, src)
                a |= better
                cc = np.where(better, cn, cc)
                quiet = 0 if better.any() else quiet + 1
            dp, sp, ap, gp = neighbours(False)
            sw = a & ap & ((d != dp) | (s != sp))
            want = sw & ~own_state(dp, sp)
            want &= ~done[np.clip(slot(gp), 0, Cn - 1), i]
            tasks += evaluate(want, dp, sp, gp)
            w1 = np.where(a, lookup(a, d, s, src), 0)
            w0 = np.where(sw, lookup(sw, dp, sp, gp), 0)
            keep = slice(o_t - f_lo, f_end - f_lo)
            fo = f[keep]
            for k, x in (('D', d), ('S', s), ('A', a), ('Dp', dp),
                         ('Sp', sp), ('Ap', ap), ('sw', sw)):
                res[k][n, fo] = x[keep]
            m1[n, fo], m0[n, fo] = w1[keep], w0[keep]
    shape = (R, K, NBF)
    return ((untranspose(m1).reshape(R, K, NBF * FINE),
             untranspose(m0).reshape(R, K, NBF * FINE),
             *(res[k].reshape(shape) for k in ('sw', 'A', 'S', 'D', 'Ap',
                                                'Sp', 'Dp'))), tasks)


def _k7_lazy_check(monkeypatch, b, rows, A, S, D, Lr, knobs, tile=128):
    for name, v in zip(('EXT_ITERS', 'EXT_MIN', 'EXT_MARGIN'), knobs):
        monkeypatch.setattr(ag, name, v)
    r_rows, rlens, q_rows, qlens = rows
    want = ag.propagate_v2_plain(b, r_rows, rlens, q_rows, qlens, A, S, D,
                                 Lr=Lr)
    got, tasks = k7_lazy_model(b, rows, A, S, D, Lr, *knobs, tile)
    for g, w in zip(got, want):
        assert g.dtype == w.numpy().dtype and np.array_equal(g, w.numpy())
    return got, tasks


def test_k7_masks_from_16_byte_pieces():
    """k7_mask's transposed masks from the aligned pieces == the plain
    flags of `_eval_on` (block_masks), at every phase, both strands, query
    N and windows clipped at -32 and past Lr - 1 and at the reference's and
    the query's ends (also lengths short of the arena's bases, where only
    the clip to them leaves a position out)."""
    Lp = 4096
    codes = v2_genomes(11, Lp - 700)
    b = v2_arena(codes, Lp, 32, 16)
    rng = np.random.default_rng(12)
    NBF = Lp // FINE
    hits = 0
    for q_row, r_row, cut in ((0, 0, 0), (1, 0, 0), (2, 3, 0), (6, 5, 0),
                              (0, 6, 0), (1, 0, 45), (0, 0, 1000)):
        qlen, rlen = len(codes[q_row]) - cut, len(codes[r_row]) - cut // 3
        f = rng.integers(0, NBF, 4000)
        d = np.concatenate([rng.integers(-40, 40, 2000),
                            rng.integers(-Lp, Lp, 1900),
                            -FINE * f[3900:3950] - 32,
                            -FINE * f[3950:] + Lp - 1])
        d[:64] = np.arange(64) - 32                    # every phase
        s = rng.random(4000) < 0.5
        got = untranspose(masks_16b(b, q_row, r_row, qlen, rlen, Lp, f, d,
                                    s))
        want = (block_masks(b, q_row, r_row, qlen, rlen, Lp, f, d, s)[
            :, None] >> np.arange(FINE)) & 1 == 1
        assert np.array_equal(got, want)
        hits += int(got.sum())
    assert hits > 10000


@pytest.mark.parametrize('Lp,knobs,tile', [
    (4096, (3, 17, 4), 64), (4096, (0, 17, 4), 8), (4096, (3, 17, 4), 16),
    (4096, (16, 17, 4), 40), (6144, (16, 12, 0), 128),
    (6144, (5, 20, 8), 24)])
def test_k7_lazy_matches_plain(monkeypatch, Lp, knobs, tile):
    """The redesigned K7 (own masks, masks at a neighbour's state listed
    when first needed, 16-byte pieces, two quiet steps stop) ==
    propagate_v2_plain, every output, on elections of the index genomes
    with blocks unassigned, diagonals moved and windows clipped; every mask
    read was evaluated first (asserted inside the model)."""
    codes = v2_genomes(7, Lp - 700)
    b = v2_arena(codes, Lp, 32, 16)
    rows = v2_rows(codes, 8, 2, 4, refs=(0, 3))
    A, S, D = election_case(b, rows, Lp, Lp, 16, 9)
    got, tasks = _k7_lazy_check(monkeypatch, b, rows, A, S, D, Lp, knobs,
                                tile)
    assert tasks > 0
    if knobs[0]:
        assert (got[3] & ~A.numpy()).any()            # something adopted


def _crafted_rows(Lp):
    codes = v2_genomes(7, Lp - 700)
    b = v2_arena(codes, Lp, 32, 16)
    lens = torch.tensor([len(c) for c in codes], dtype=torch.int32)
    r_rows = torch.tensor([0, 3], dtype=torch.int32)
    q_rows = torch.tensor([[0, 1, 2, 7], [3, 0, 4, 6]], dtype=torch.int32)
    return b, (r_rows, lens[r_rows.long()], q_rows, lens[q_rows.long()])


@pytest.mark.parametrize('iters', [0, 3, 16])
@pytest.mark.parametrize('kind', ['distinct', 'distinct_c0', 'relay',
                                  'clipped', 'chain'])
def test_k7_lazy_crafted_elections(monkeypatch, kind, iters):
    """The redesigned K7 == propagate_v2_plain on crafted elections, at
    EXT_ITERS 0, 3 and 16: every block's neighbours at other states (no
    candidate repeats; with blocks at diagonal 0 whose state spreads), a
    state handed on over assigned blocks (each adopts it a step after its
    neighbour did), windows at and past the clips, and one assigned block
    whose state spreads over unassigned ones."""
    Lp = 4096
    NBF = Lp // FINE
    b, rows = _crafted_rows(Lp)
    R, K = rows[2].shape
    A, S, D = {
        'distinct': lambda: distinct_election(NBF, R, K, Lp),
        'distinct_c0': lambda: distinct_election(NBF, R, K, Lp, c0=60),
        'relay': lambda: relay_election(NBF, R, K, 70),
        'clipped': lambda: clipped_election(NBF, R, K, Lp, 5),
        'chain': lambda: chain_election(rows[2], NBF, 50)}[kind]()
    got, tasks = _k7_lazy_check(monkeypatch, b, rows, A, S, D, Lp,
                                (iters, 17, 4))
    f = np.arange(NBF)
    if kind == 'relay' and iters:           # pair (0, 0): the self pair
        assert (got[5][0, 0, 70 - iters:71 + iters] == 0).all()
        assert (got[5][0, 0, 71 + iters:] == 3 + f[71 + iters:] % 5).all()
    if kind == 'clipped':
        start = f * FINE + D.numpy()
        assert (start == -33).any() and (start == Lp).any()
        assert (start == -32).any() and (start == Lp - 1).any()
    if kind != 'chain':
        assert tasks > 0


def test_k7_lazy_collinear_needs_no_tasks(monkeypatch):
    """Where every block of a pair is assigned at one state, no mask
    beyond the own ones is evaluated and the steps stop after two."""
    Lp = 4096
    b, rows = _crafted_rows(Lp)
    shape = tuple(rows[2].shape) + (Lp // FINE,)
    A = torch.ones(shape, dtype=torch.bool)
    S = torch.zeros(shape, dtype=torch.bool)
    D = torch.zeros(shape, dtype=torch.int32)
    got, tasks = _k7_lazy_check(monkeypatch, b, rows, A, S, D, Lp,
                                (3, 17, 4))
    assert tasks == 0 and not got[2].any()
