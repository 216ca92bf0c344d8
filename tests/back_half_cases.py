"""Inputs of the shared back half (`_blocks_to_measures`, kernel K4) and of
v3 stages 2-4 (kernel K3) and 5-6 (kernel K5), made with numpy from a
seed: K3 and K5 read crafted arenas of wide rows and query codes in place.
Used by tests/test_torch_back_half.py (the port's plain versions against
the JAX package), tests/test_torch_split_model.py (numpy models of the
kernels against the plain versions) and tests/test_torch_kernels.py (the
kernels against the plain versions on the card)."""

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


# The arguments of `_bands_v3` after the arena and of `_propagate_v3` after
# the election and the arena, as the case dicts below name them.
K3_ARGS = ('r_rows', 'rlens', 'q_rows', 'cnt1', 'g1', 'cnt2', 'g2')
K5_ARGS = ('r_rows', 'rlens', 'q_rows', 'g1', 'g2')


def torch_args(torch, case, keys, device='cpu'):
    """A case's arena dict and its arrays `keys`, as torch tensors on
    `device`."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return ({k: put(v) for k, v in case['b'].items()},
            [put(case[k]) for k in keys])


def mirror_block(rlen, g, NRB):
    """The reverse strand's block of reference block g (the JAX package's
    `mirror`): (rlen - 32 g - 32) >> 5, an arithmetic shift, clamped."""
    return np.clip((np.asarray(rlen, np.int64) - 32 * np.asarray(g) - 32)
                   >> 5, 0, NRB - 1)


def band_rows(case):
    """Each band's reference block of every coarse block, (4, R, K, NQB):
    candidates 1 and 2 forward, their mirrors on the reverse strand."""
    NRB = case['g3']['NRB']
    rl = case['rlens'][:, None, None]
    g1, g2 = case['g1'], case['g2']
    return np.stack([g1, mirror_block(rl, g1, NRB), g2,
                     mirror_block(rl, g2, NRB)])


def band_windows(case):
    """Stage 2 in numpy (ops/align_gpu.py:_band_windows): the windows of
    the four bands, (4, R, K, NBF, WIN), and their first diagonals, (4, R,
    K, NBF)."""
    g3 = case['g3']
    WQ, WIN, FPB = g3['WQ'], g3['WIN'], g3['FPB']
    R, K, NQB = case['g1'].shape
    NBF = NQB * FPB
    gs = band_rows(case)
    fc = np.arange(NBF) // FPB
    k = np.arange(NBF) % FPB
    at = 16 + 32 * k[:, None] + np.arange(WIN)               # (NBF, WIN)
    rr = case['r_rows'][:, None, None]
    wins = np.stack([
        case['b']['roww_r' if i & 1 else 'roww_f'][
            rr[..., None], gs[i][..., fc][..., None], at]
        for i in range(4)])
    base = (32 * gs[..., fc] - (fc + 1) * WQ - 16).astype(np.int32)
    return wins, base


def _geometry(wq, NQB, NRB, band=None):
    """The v3 geometry (ops/align_gpu.py:_v3_geom's keys) of query blocks of
    wq bases; band: another number of shifts (K5 takes any multiple of
    4), with rows wide enough for every window."""
    FPB = wq // FINE
    BAND = wq + 96 if band is None else band
    WIN = BAND + FINE
    return dict(WQ=wq, BAND=BAND, WIN=WIN, ROWW=-(-(wq - 16 + WIN) // 32) * 32,
                NQB=NQB, NRB=NRB, FPB=FPB)


def bands_case(seed, R, K, NQB, wq, ties=False, clean=False, nrb=None):
    """Inputs of v3 stages 2-4 (`_bands_v3`) as numpy arrays: {'b': the
    arena (roww_f, roww_r: (R + 1, NRB, ROWW) wide rows of codes 0-4;
    fwd: (R K + 1, NQB wq) query codes), r_rows, rlens (R,), q_rows (R,
    K), cnt1, g1, cnt2, g2 (R, K, NQB), 'g3': the geometry}. Rows of
    random bases with N runs of 7 in a third of them (one in 16 if clean)
    and pads of 4 at the end of the last two rows; each query block copies
    one band's window at a random shift with 15% substitutions and an N
    run in every 7th block (16th). g1 holds blocks 0 and NRB - 1, g2 equals
    g1 in 30% of the blocks, and the rows' lengths are 32 NRB, 32 NRB - 7,
    and others, multiples of 32 or not, some short enough that most
    mirrors clamp to 0. ties: every row the same bases of period 4, so
    every band and every 4th shift tie."""
    rng = np.random.default_rng(seed)
    FPB = wq // FINE
    NRB = NQB * FPB + 3 if nrb is None else nrb
    g3 = _geometry(wq, NQB, NRB)
    ROWW, NBF, BAND = g3['ROWW'], NQB * FPB, g3['BAND']
    Gr, Gq = R + 1, R * K + 1
    rows = rng.integers(0, 4, (2, Gr, NRB, ROWW)).astype(np.int8)
    if ties:
        rows[:] = np.tile(rng.integers(0, 4, 4), ROWW // 4).astype(np.int8)
    else:
        hit = rng.random((2, Gr, NRB)) < (1 / 16 if clean else 1 / 3)
        at = rng.integers(0, ROWW - 7, hit.sum())
        rows[hit] = np.where((np.arange(ROWW) >= at[:, None])
                             & (np.arange(ROWW) < at[:, None] + 7), 4,
                             rows[hit]).astype(np.int8)
        rows[:, :, -2:, ROWW - 40:] = 4
    r_rows = rng.permutation(Gr)[:R].astype(np.int32)
    rlens = rng.integers(1, 32 * NRB + 1, R).astype(np.int32)
    for i, v in enumerate((32 * NRB, 32 * NRB - 7, 32 * (NRB // 3),
                           32 * (NRB // 3) + 13, 100)):
        if i < R:
            rlens[i] = v
    q_rows = rng.permutation(Gq)[:R * K].reshape(R, K).astype(np.int32)
    g1 = rng.integers(0, NRB, (R, K, NQB)).astype(np.int32)
    flat = g1.reshape(-1)
    flat[::7] = 0
    flat[3::7] = NRB - 1
    g2 = np.where(rng.random(g1.shape) < 0.3, g1,
                  rng.integers(0, NRB, g1.shape)).astype(np.int32)
    cnt1 = rng.integers(0, 12, g1.shape).astype(np.int32)
    cnt2 = rng.integers(0, 8, g1.shape).astype(np.int32)
    case = dict(b=dict(roww_f=rows[0], roww_r=rows[1]), r_rows=r_rows,
                rlens=rlens, q_rows=q_rows, cnt1=cnt1, g1=g1, cnt2=cnt2,
                g2=g2, g3=g3)
    wins, _ = band_windows(case)
    band_of = rng.integers(0, 4, (R, K, NBF))
    t = rng.integers(0, BAND, (R, K, NBF))
    qb = np.take_along_axis(
        np.take_along_axis(wins, band_of[None, ..., None], 0)[0],
        t[..., None] + np.arange(FINE), -1)
    sub = rng.random(qb.shape) < 0.15
    qb[sub] = rng.integers(0, 4 if clean else 5, sub.sum())
    qb[:, :, ::16 if clean else 7, 3:9] = 4
    fwd = rng.integers(0, 4, (Gq, NBF * FINE)).astype(np.int8)
    fwd[q_rows] = qb.reshape(R, K, NBF * FINE)
    case['b']['fwd'] = fwd
    return case


def propagate_case(seed, R, K, NBF, band, ties=False):
    """Inputs of v3 stages 5-6 (`_propagate_v3`) as numpy arrays: the
    arguments of `bands_case` (the arena's rows and query codes, r_rows,
    rlens, q_rows, g1, g2, 'g3') and 'el', a `_bands_v3` dict (cnt,
    cnt_best, A, S, D). The geometry has BAND = band shifts and coarse
    blocks of (band - 96) / 32 fine blocks where that divides NBF, else of
    one. Per block a diagonal walk that both bands of its strand hold at
    most blocks: g1 follows the query (block fc FPB + c), off by one block
    at a fifth of the coarse blocks, g2 within two blocks of g1; the
    elected (A, S, D) on the walk or off it by a little, counts near
    EXT_MIN, and query bases that copy a band's window at the diagonal
    with substitutions. ties: g2 = g1 and the four bands hold the same
    counts, so every count and window ties across the two bands of a
    strand."""
    rng = np.random.default_rng(seed)
    fpb = (band - 96) // FINE
    fpb = fpb if fpb >= 1 and NBF % fpb == 0 else 1
    NQB = NBF // fpb
    NRB = NBF + 8
    g3 = _geometry(FINE * fpb, NQB, NRB, band)
    ROWW = g3['ROWW']
    Gr, Gq = R + 1, R * K + 2
    rows = rng.integers(0, 4, (2, Gr, NRB, ROWW)).astype(np.int8)
    rows[..., 50:53] = 4
    r_rows = rng.permutation(Gr)[:R].astype(np.int32)
    rlens = rng.integers(16 * NRB, 32 * NRB + 1, R).astype(np.int32)
    q_rows = rng.permutation(Gq)[:R * K].reshape(R, K).astype(np.int32)
    shape = (R, K, NQB)
    c = rng.integers(1, 4, (R, K, 1))
    g1 = np.clip(np.arange(NQB) * fpb + c + np.where(
        rng.random(shape) < 0.2, rng.integers(-1, 2, shape), 0), 0,
        NRB - 1).astype(np.int32)
    g2 = g1 if ties else np.clip(g1 + rng.integers(-2, 3, shape), 0,
                                 NRB - 1).astype(np.int32)
    case = dict(b=dict(roww_f=rows[0], roww_r=rows[1]), r_rows=r_rows,
                rlens=rlens, q_rows=q_rows, g1=g1, g2=np.ascontiguousarray(
                    g2), g3=g3)
    wins, base = band_windows(case)
    shape = (R, K, NBF)
    S = rng.random(shape) < 0.4
    band_of = rng.integers(0, 2, shape) * 2 + S          # one of its strand
    walk = np.cumsum(np.where(rng.random(shape) < 0.85, 0,
                              rng.integers(-40, 40, shape)), axis=-1)
    t = np.clip(band // 2 + walk, 0, band - 1)
    on = np.take_along_axis(base, band_of[None], 0)[0] + t
    D = (on + np.where(rng.random(shape) < 0.3, rng.integers(-3, 4, shape),
                       0)).astype(np.int32)
    cnt = rng.choice(np.array([0, 12, 16, 17, 19, 21, 22, 26, 32], np.int8),
                     (4,) + shape + (band,))
    if ties:
        cnt[1:] = cnt[0]
    A = rng.random(shape) < 0.75
    cnt_best = rng.choice(np.array([10, 17, 20, 24, 30], np.int32), shape)
    tq = np.clip(D - np.take_along_axis(base, band_of[None], 0)[0], 0,
                 band - 1)
    qb = np.take_along_axis(
        np.take_along_axis(wins, band_of[None, ..., None], 0)[0],
        tq[..., None] + np.arange(FINE), -1)
    sub = rng.random(qb.shape) < 0.1
    qb[sub] = rng.integers(0, 5, sub.sum())
    fwd = rng.integers(0, 5, (Gq, NBF * FINE)).astype(np.int8)
    fwd[q_rows] = qb.reshape(R, K, NBF * FINE)
    case['b']['fwd'] = fwd
    case['el'] = dict(cnt=cnt, cnt_best=cnt_best, A=A, S=S, D=D)
    return case


def chain_case(seed, R, K, NBF, band, c0, iters):
    """A `propagate_case` in which block c0 alone is assigned and every
    other block reads a high count (25) at c0's (strand, diagonal) and sits
    off it by 7: the two bands of c0's strand have one first diagonal at
    every block (their rows follow the query: g1 = g2 = fc FPB + 2, or
    their mirrors do, on a reference of 32 NRB bases), so each step hands
    c0's state one block on, and after the EXT_ITERS rounds blocks
    c0 - iters .. c0 + iters hold it (a chain that crosses any tile edge
    within iters of c0)."""
    case = propagate_case(seed, R, K, NBF, band)
    el, g3 = case['el'], case['g3']
    NQB, NRB, FPB, WQ = g3['NQB'], g3['NRB'], g3['FPB'], g3['WQ']
    S0 = bool(el['S'][..., c0].flat[0])
    blk = np.arange(NQB) * FPB + 2
    case['rlens'][:] = 32 * NRB
    # The mirror of NRB - 1 - b is b on a reference of 32 NRB bases.
    g = (NRB - 1 - blk) if S0 else blk
    case['g1'][:] = case['g2'][:] = g.astype(np.int32)
    d0 = 32 * 2 - WQ - 16 + 5
    el['S'][:] = S0
    el['D'][:] = d0 + 7
    el['D'][..., c0] = d0
    el['A'][:] = False
    el['A'][..., c0] = True
    el['cnt_best'][..., c0] = 30
    for b in (1, 3) if S0 else (0, 2):
        el['cnt'][b, ..., 5] = 25
    lo, hi = max(c0 - iters, 0), min(c0 + iters + 1, NBF)
    case['chain'] = (lo, hi)
    return case


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
