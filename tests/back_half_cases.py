"""Inputs of the shared back half (`_blocks_to_measures`, kernel K4) and of
v3 stages 5-6 (kernel K5), made with numpy from a seed. Used by
tests/test_torch_back_half.py (the port's plain versions against the JAX
package) and tests/test_torch_kernels.py (the kernels against the plain
versions on the card)."""

import numpy as np

FINE = 32
# (mqd, mrd, reg) of each parameter set; 'cap' makes more accepted segments
# than the record cap (MAXSEG = 264 at Lq = 4,096) holds.
PARAMS = {'default': (40, 40, 35), 'tight': (5, 2, 12), 'cap': (0, 40, 11)}
CASES = ('random', 'switchable', 'breaks', 'empty_full', 'borders')


def _stretches(rng, Lq):
    """Match flags: stretches of 20-900 positions at 80-97% identity with
    gaps of 0-300 between them, 25% elsewhere."""
    p = np.full(Lq, 0.25)
    pos = 0
    while pos < Lq:
        ln = int(rng.integers(20, 900))
        p[pos:pos + ln] = rng.choice([0.97, 0.92, 0.8])
        pos += ln + int(rng.integers(0, 300))
    return rng.random(Lq) < p


def back_half_case(case, Lq, seed, pairs=3):
    """(m1, m0, switchable, A, S, D, Ap, Sp, Dp, rlen) for `pairs` directed
    pairs over Lq positions; the previous-block arrays are the blocks'
    shifted by one, as the front ends make them.

    random: flags of aligned stretches, 80% of the blocks assigned, the
    diagonal a walk with a jump at a fifth of the blocks (some beyond mrd),
    a third on the reverse strand. switchable: the same with every block
    switchable. breaks: every block assigned 100 diagonals past the one
    before (a break at every block). empty_full: no match at all, then all
    matches. borders: matches only in stretches across fine-block and
    1,024-position borders. cap: runs of 11 matches parted by one mismatch
    (one accepted segment each at mqd 0)."""
    rng = np.random.default_rng(seed)
    NBF = Lq // FINE
    m1 = np.stack([_stretches(rng, Lq) for _ in range(pairs)])
    m0 = np.stack([_stretches(rng, Lq) for _ in range(pairs)])
    A = rng.random((pairs, NBF)) < 0.8
    S = rng.random((pairs, NBF)) < 0.3
    step = rng.integers(-60, 60, (pairs, NBF))
    D = np.cumsum(np.where(rng.random((pairs, NBF)) < 0.8, 0, step),
                  axis=1).astype(np.int32)
    if case == 'breaks':
        A[:] = True
        D = np.tile(np.arange(NBF, dtype=np.int32) * 100 - 5000, (pairs, 1))
    elif case == 'empty_full':
        m1[0] = m0[0] = False
        m1[1:] = m0[1:] = True
    elif case in ('borders', 'cap'):
        A[:] = True
        S[:] = False
        D[:] = 7
        m1[:] = m0[:] = False
        if case == 'borders':
            for lo, hi in ((1000, 1100), (2040, 2061), (3067, 3105),
                           (1023, 1025)):
                if hi <= Lq:
                    m1[:, lo:hi] = True
            m0[:, 2030:2050] = True
        else:
            m1[:, np.arange(Lq) % 12 != 11] = True
    Ap = np.zeros_like(A)
    Sp = np.zeros_like(S)
    Dp = np.zeros_like(D)
    Ap[:, 1:], Sp[:, 1:], Dp[:, 1:] = A[:, :-1], S[:, :-1], D[:, :-1]
    sw = A & Ap & ((D != Dp) | (S != Sp))
    if case == 'switchable':
        sw[:] = True
    rlen = rng.integers(Lq // 2, Lq + 1, pairs).astype(np.int32)
    return [np.ascontiguousarray(x) for x in
            (m1, m0, sw, A, S, D, Ap, Sp, Dp, rlen)]


def propagate_case(seed, R, K, NBF, band, ties=False):
    """A `_bands_v3` dict of numpy arrays for v3 stages 5-6: per block a
    diagonal walk that every band's range holds at a random offset, the
    elected (A, S, D) on it or off it by a little, counts near EXT_MIN and
    windows of codes 0-4 whose query bases copy the window at the
    diagonal with substitutions. ties: the four bands hold the same counts
    and windows, so every count ties across bands."""
    rng = np.random.default_rng(seed)
    win_w = band + FINE
    shape = (R, K, NBF)
    walk = np.cumsum(np.where(rng.random(shape) < 0.85, 0,
                              rng.integers(-40, 40, shape)), axis=-1)
    base = (walk[None] - rng.integers(0, band, (4,) + shape)).astype(np.int32)
    cnt = rng.choice(np.array([0, 12, 16, 17, 19, 21, 22, 26, 32], np.int8),
                     (4,) + shape + (band,))
    win = rng.integers(0, 4, (4,) + shape + (win_w,)).astype(np.int8)
    win[..., 50:53] = 4
    if ties:
        cnt[1:] = cnt[0]
        win[1:] = win[0]
    S = rng.random(shape) < 0.4
    D = (walk + np.where(rng.random(shape) < 0.3,
                         rng.integers(-3, 4, shape), 0)).astype(np.int32)
    A = rng.random(shape) < 0.75
    cnt_best = rng.choice(np.array([10, 17, 20, 24, 30], np.int32), shape)
    band_of = rng.integers(0, 2, shape) * 2 + S          # one of its strand
    t = np.clip(D - np.take_along_axis(base, band_of[None], 0)[0], 0,
                band - 1)
    at = t[..., None] + np.arange(FINE)
    qb = np.take_along_axis(
        np.take_along_axis(win, band_of[None, ..., None], 0)[0], at, -1)
    sub = rng.random(qb.shape) < 0.1
    qb[sub] = rng.integers(0, 5, sub.sum())
    return dict(cnt=cnt, win=win, base=base, qb=np.ascontiguousarray(qb),
                qok=qb < 4, cnt_best=cnt_best, A=A, S=S, D=D)


def chain_case(seed, R, K, NBF, band, c0, iters):
    """A `propagate_case` dict in which block c0 alone is assigned and every
    other block reads a high count (25) at c0's (strand, diagonal) and sits
    off it by 7: each step hands c0's state one block on, so after the
    EXT_ITERS rounds blocks c0 - iters .. c0 + iters hold it (a chain that
    crosses any tile edge within iters of c0)."""
    el = propagate_case(seed, R, K, NBF, band)
    S0 = bool(el['S'][..., c0].flat[0])
    d0 = int(el['D'][..., c0].flat[0])
    el['S'][:] = S0
    el['D'][:] = d0 + 7
    el['D'][..., c0] = d0
    el['A'][:] = False
    el['A'][..., c0] = True
    el['cnt_best'][..., c0] = 30
    el['base'][:] = d0 - 5
    for b in (1, 3) if S0 else (0, 2):
        el['cnt'][b, ..., 5] = 25
    lo, hi = max(c0 - iters, 0), min(c0 + iters + 1, NBF)
    el['chain'] = (lo, hi)
    return el


def long_segment_case(Lq, pairs, at=(100, 20000, 40000)):
    """Back-half inputs of one long segment: runs of 8 matches parted by one
    mismatch from at[0] to at[2] (every match anchored, no MAL run of 11)
    with one run of 12 matches at at[1] (its MAL run): with the default
    `at`, the start, the MAL run and the end lie in chunks 0, 1 and 2 of
    16,384 positions. Blocks assigned on one diagonal, nothing
    switchable."""
    NBF = Lq // FINE
    m1 = np.zeros((pairs, Lq), bool)
    pos = np.arange(at[0], at[2])
    m1[:, pos[(pos - at[0]) % 9 != 8]] = True
    m1[:, at[1]:at[1] + 12] = True
    A = np.ones((pairs, NBF), bool)
    S = np.zeros((pairs, NBF), bool)
    D = np.full((pairs, NBF), 3, np.int32)
    Ap, Sp, Dp = A.copy(), S.copy(), D.copy()
    Ap[:, 0] = False
    Dp[:, 0] = 0
    sw = np.zeros((pairs, NBF), bool)
    rlen = np.full(pairs, Lq, np.int32)
    return [np.ascontiguousarray(x) for x in
            (m1, m1.copy(), sw, A, S, D, Ap, Sp, Dp, rlen)]


def last_chunk_case(Lq, pairs):
    """Back-half inputs whose only matches lie in the last 60 positions:
    the pair's only anchored matches, its only segment and its record
    all sit in its last chunk."""
    return long_segment_case(Lq, pairs, at=(Lq - 60, Lq - 40, Lq))


def sparse_cap_case(Lq, pairs, period=48):
    """Back-half inputs with a run of 11 matches every `period` positions
    and nothing else: one accepted segment a run at mqd 0 and reg 11 (the
    'cap' parameters), so at Lq = 262,144 the record cap (2,048) is
    reached near position 98,000."""
    x = long_segment_case(Lq, pairs, at=(0, 0, 0))
    x[0][:] = (np.arange(Lq) % period < 11)[None]
    x[1][:] = x[0]
    return x
