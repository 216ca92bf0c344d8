"""The plain reference of the align benchmark: the port's device align
engine (`all2all_gpu` with its defaults) as plain torch operations, on any
device.

A frozen copy of the plain versions of the port's kernels (the index builds
K9 and K10, the v3 stages K2, K3 and K5, the v2 stages K6 and K7, the back
half K4) with the engine's default constants, and a driver of its own
(`align_pairs`) that aligns each candidate pair on its own rows: the v3
pipe at the pair's bucket up to 131,072 and the v2 pipe above, then the
hybrid's rule, which aligns the pairs v3 leaves hard again on v2. It builds
its own arenas from the codes it is given and imports nothing of the
program. Results do not depend on how the pairs are batched.
"""

import numpy as np
import torch

SEED_K = 8
SEEDS_PER_BLOCK = 16
CANDS = 2
BLOCK = 128
FINE = 32
GAP_DIAG = 16
SMAX = 15
MIN_VOTES_F = 2
MIN_VOTES_C = 3
EXT_ITERS = 3
EXT_MIN = 17
EXT_MARGIN = 4
MSL = 7
MAL = 11
AW = 39
AW_WIN = 15
AM = 7
BIG = 2 ** 30
MAX_TPU_LEN = 1 << 20
_BUCKETS = sorted({4096 << i for i in range(8)}
                  | {6144 << i for i in range(8)})
V3_H = 2048
V3_WQ = 128
V3_SMIN = 5
V3_TBAND = 17
V3_MAX_BUCKET = 131072
V3_CONT = 6
V3_RERUN_COV = 0.997
_RB_BITS = 13
_T_BITS = 9
BAND_TAGS = (3072, 2048, 1024, 0)
_BAND_IS_RC = (False, True, False, True)
_STAGE1_CHUNK = 512
# The align parameters' defaults (mqd, mrd, reg).
MQD, MRD, REG = 40, 40, 35


def _maxseg(Lq: int, reg: int) -> int:
    return min(Lq // max(reg, 16) + 8, 2048)


def _pad_bucket(n: int) -> int:
    n = int(n)      # a NumPy int32 length would make the bucket int32
    for b in _BUCKETS:
        if n <= b:
            return b
    return -(-n // 131072) * 131072


def _v3_geom(Lq, Lr):
    """Shapes of the v3 pipe at buckets (Lq, Lr). Raises ValueError where
    the packed maxes would truncate: BAND above 512 shifts (V3_WQ > 416;
    the election keeps 9 bits of shift) or more than 2^13 reference blocks
    (the stage-1 pack keeps 13 bits of block)."""
    WQ = V3_WQ
    if WQ > 416:
        raise ValueError(
            f'VCLUST_ALIGN_V3_WQ={WQ}: the band election packs the shift in '
            f'9 bits, so V3_WQ + 96 shifts must stay <= 512 (V3_WQ <= 416)')
    if WQ % FINE or Lq % WQ:
        raise ValueError(f'VCLUST_ALIGN_V3_WQ={WQ} must be a multiple of '
                         f'{FINE} that divides the bucket ({Lq})')
    if Lr // FINE > 1 << _RB_BITS:
        raise ValueError(
            f'bucket {Lr} has {Lr // FINE} reference blocks: stage 1 packs '
            f'the block in 13 bits (<= {(1 << _RB_BITS) * FINE} bases); '
            f'lower VCLUST_ALIGN_V3_MAXB')
    BAND = WQ + 96          # diagonal shifts evaluated per fine block
    WIN = BAND + FINE       # per-fine-block window width
    ROWW = -(-(WQ - 16 + WIN) // 32) * 32   # wide window row width
    return dict(WQ=WQ, BAND=BAND, WIN=WIN, ROWW=ROWW,
                NQB=Lq // WQ, NRB=Lr // FINE, FPB=WQ // FINE)


def kmer_vals(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Packed k-mer value at every position along the last axis (int32);
    -1 where the window contains a non-ACGT code or runs past the end."""
    L = codes.shape[-1]
    c = codes.to(torch.int32)
    cp = torch.cat([c, torch.full(c.shape[:-1] + (k,), 4, dtype=torch.int32,
                                  device=c.device)], dim=-1)
    vals = torch.zeros_like(c)
    bad = torch.zeros(c.shape, dtype=torch.bool, device=c.device)
    for j in range(k):
        cj = cp[..., j:j + L]
        bad = bad | (cj >= 4)
        vals = (vals << 2) | torch.where(bad, 0, cj)
    return torch.where(bad, -1, vals)


def _canon_hash(vals: torch.Tensor) -> torch.Tensor:
    """Hash bucket of the canonical 8-mer for packed values (int32, -1 =
    invalid): min(v, revcomp(v)) through a Knuth multiplicative hash,
    the uint32 multiply-shift done in int64 with an explicit 32-bit mask.
    Returns -1 for invalid positions."""
    rc = torch.zeros_like(vals)
    t = vals
    for _ in range(SEED_K):
        rc = (rc << 2) | ((t & 3) ^ 3)
        t = t >> 2
    vc = torch.minimum(vals, rc).to(torch.int64) & 0xFFFFFFFF
    shift = 32 - int(np.log2(V3_H))
    h = ((vc * 2654435761) & 0xFFFFFFFF) >> shift
    return torch.where(vals >= 0, h.to(torch.int32), -1)


def index_block_v3_plain(fwd, rc, k: int, Lp: int):
    """Per-genome v3 device index for one bucket chunk, in torch ops (K9's
    plain version): canonical occupancies (query half-blocks of WQ/2,
    reference blocks of FINE) and the wide window rows of both strands.
    fwd/rc: (G, Lp) int8 codes. Returns qocc (G, 2*NQB, H), rocc (G, NRB,
    H), roww_f and roww_r (G, NRB, ROWW), all int8."""
    g3 = _v3_geom(Lp, Lp)
    WQ, NQB, NRB, ROWW = g3['WQ'], g3['NQB'], g3['NRB'], g3['ROWW']
    G = fwd.shape[0]
    dev = fwd.device
    h = _canon_hash(kmer_vals(fwd, k)).to(torch.int64)     # (G, Lp)
    gi = torch.arange(G, device=dev)[:, None]
    pos = torch.arange(Lp, device=dev)[None, :]

    # The JAX package's scatter normalizes indices NumPy-style, so the -1
    # of an invalid position (an N, or the padding past a genome's end)
    # marks bucket H - 1; kept for parity (ROADMAP section 3, R8).
    h = torch.where(h >= 0, h, h + V3_H)

    def occupancy(blocks, width):
        # Index-put of ones; blocks past the end land in one spare slot
        # that is cut off (the scatter's mode='drop').
        blk = pos // width
        size = G * blocks * V3_H
        flat = torch.where(blk < blocks, (gi * blocks + blk) * V3_H + h,
                           size)
        occ = torch.zeros(size + 1, dtype=torch.int8, device=dev)
        occ[flat.reshape(-1)] = 1
        return occ[:size].view(G, blocks, V3_H)

    qocc = occupancy(2 * NQB, WQ // 2)
    rocc = occupancy(NRB, FINE)

    def rows(codes):
        lead = torch.full((G, WQ + 32), 4, dtype=torch.int8, device=dev)
        tail = torch.full((G, ROWW), 4, dtype=torch.int8, device=dev)
        P = torch.cat([lead, codes, tail], dim=1)
        # row r holds P[32 r : 32 r + ROWW]
        return P.unfold(1, ROWW, 32)[:, :NRB].contiguous()

    return qocc, rocc, rows(fwd), rows(rc)


def _pack_bits(Lp: int) -> int:
    """Width of the v2 seed packs at bucket Lp: (value, position) fits 32
    bits while positions + 1 fit 16 bits."""
    return 32 if Lp <= 65536 else 64


def index_block_plain(fwd, rc, k: int, pack_bits: int, C: int):
    """Per-genome v2 device index for one bucket chunk, in torch ops (K10's
    plain version). fwd/rc: (G, Lp)
    int8 codes. Sampling by VALUE keeps the two join sides consistent: a
    matching seed is kept or dropped on both sides together; ties inside a
    block resolve by position (stable sorts).

    Returns qsv, qoff (G, NQ) int32, NQ = Lp/32*C: the C seeds of each
    fine block with the smallest value hash (-1 where a block has fewer
    valid seeds) and their offsets in the block; per strand (forward,
    reverse) sv (G, NQ) int32, the same seeds' values sorted (BIG where
    invalid), and the int64 packs pk1, pk2 aligned to sv: value << 16 |
    position + 1 and value << 16 | previous position of the value + 1
    (pack_bits 32; 0 where invalid or, in pk2, without a previous), or
    pk1 = pk2 = value << 40 | position + 1 << 20 | previous + 1 (64);
    and r2dov (G, 2*(Lp/32+1), 64) int8, the 64-wide window rows every 32
    bases of both strands, each strand led by one all-pad row."""
    G, Lp = fwd.shape
    NBF = Lp // FINE
    NQ = NBF * C
    dev = fwd.device

    def select(qv_s):
        v = qv_s.view(G, NBF, FINE)
        # The uint32 multiply-shift hash, in int64 with a 32-bit mask; -1
        # (invalid) hashes as 2^32 - 1 before it is replaced by BIG.
        h = (((v.to(torch.int64) & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF) >> 16
        h = torch.where(v < 0, BIG, h.to(torch.int32))
        hs, offs = torch.sort(h, dim=2, stable=True)
        vals = torch.gather(v, 2, offs[..., :C])
        sel_v = torch.where(hs[..., :C] < BIG, vals, -1).reshape(G, NQ)
        return sel_v, offs[..., :C].to(torch.int32).reshape(G, NQ)

    qv_f = kmer_vals(fwd, k)
    qv_r = kmer_vals(rc, k)
    qsv, qoff = select(qv_f)
    blk = (torch.arange(NQ, dtype=torch.int32, device=dev) // C) * FINE

    def strand(qv_s):
        sel_v, sel_off = select(qv_s)
        vs = torch.where(sel_v < 0, BIG, sel_v)
        sv, perm = torch.sort(vs, dim=1, stable=True)
        spos = torch.gather(blk + sel_off, 1, perm).to(torch.int64)
        prev_same = torch.zeros_like(sv, dtype=torch.bool)
        prev_same[:, 1:] = sv[:, 1:] == sv[:, :-1]
        spred = torch.where(prev_same, _sh_r(spos, 1, 0), -1)
        valid = sv < BIG
        v64 = torch.where(valid, sv, 0).to(torch.int64)
        if pack_bits == 32:
            pk1 = torch.where(valid, (v64 << 16) | (spos + 1), 0)
            pk2 = torch.where(valid & (spred >= 0), (v64 << 16) | (spred + 1),
                              0)
            return sv, pk1, pk2
        p64 = (v64 << 40) | ((spos + 1) << 20) | torch.where(
            spred >= 0, spred + 1, 0)
        pk1 = torch.where(valid, p64, 0)
        return sv, pk1, pk1

    sv_f, pk1_f, pk2_f = strand(qv_f)
    sv_r, pk1_r, pk2_r = strand(qv_r)

    def rows(codes):
        a = torch.cat([codes, torch.full((G, FINE), 4, dtype=torch.int8,
                                         device=dev)], dim=1).view(G, -1, FINE)
        ov = torch.cat([a[:, :-1], a[:, 1:]], dim=-1)
        lead = torch.full((G, 1, 2 * FINE), 4, dtype=torch.int8, device=dev)
        return torch.cat([lead, ov], dim=1)

    r2dov = torch.cat([rows(fwd), rows(rc)], dim=1)
    return qsv, qoff, sv_f, pk1_f, pk2_f, sv_r, pk1_r, pk2_r, r2dov


def _sh_r(x, k, fill):
    """x shifted right by k along the last axis (out[i] = x[i-k])."""
    if k == 0:
        return x
    pad = torch.full(x.shape[:-1] + (k,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :-k]], dim=-1)


def _sh_l(x, k, fill):
    if k == 0:
        return x
    pad = torch.full(x.shape[:-1] + (k,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x[..., k:], pad], dim=-1)


def _dilate_back(x, n):
    """OR of x shifted right by 0..n (bool): any true in [i-n, i]."""
    y = x
    p = 1
    while p * 2 <= n + 1:
        y = y | _sh_r(y, p, False)
        p *= 2
    if p <= n:
        y = y | _sh_r(y, n + 1 - p, False)
    return y


def _dilate_fwd(x, n):
    y = x
    p = 1
    while p * 2 <= n + 1:
        y = y | _sh_l(y, p, False)
        p *= 2
    if p <= n:
        y = y | _sh_l(y, n + 1 - p, False)
    return y


def _run_positions(m, run_len):
    """Positions inside a run of >= run_len consecutive matches."""
    start = m
    for j in range(1, run_len):
        start = start & _sh_l(m, j, False)
    return _dilate_back(start, run_len - 1)


def _win_sum(m_i32, n):
    """Trailing-window sum over the last n positions: out[i] =
    sum(m[i-n+1 .. i]), from log-decomposed shifted partial sums."""
    sums = {1: m_i32}
    p = 1
    while p * 2 <= n:
        sums[p * 2] = sums[p] + _sh_r(sums[p], p, 0)
        p *= 2
    out = None
    off = 0
    while n:
        q = 1 << (n.bit_length() - 1)
        part = _sh_r(sums[q], off, 0)
        out = part if out is None else out + part
        off += q
        n -= q
    return out


def _hcummax(x, reverse=False):
    """Cummax along the last axis (the JAX package's blocked scan, which
    exists for the TPU, computes the same)."""
    if reverse:
        return torch.cummax(x.flip(-1), dim=-1).values.flip(-1)
    return torch.cummax(x, dim=-1).values


def _ffill_idx(flag, iota):
    """Index of the most recent True at or before each position (-1 if
    none), along the last axis."""
    return _hcummax(torch.where(flag, iota, -1))


def _rev_next_idx(flag, iota, none_val):
    """Smallest index >= i with flag (none_val if none)."""
    neg = _hcummax(torch.where(flag, -iota, -BIG), reverse=True)
    return torch.where(neg > -BIG, -neg, none_val)


def _tree_slice(w, t, out_width):
    """w[..., t:t+out_width] for per-element t (the JAX package's
    where-tree of static slices, as a gather). t: w.shape[:-1]."""
    idx = t.to(torch.int64)[..., None] + torch.arange(
        out_width, device=w.device)
    return torch.gather(w, -1, idx)


def blocks_to_measures_plain(m1, m0, switchable, A, S, D, Ap, Sp, Dp, rlen,
                             *, Lq, mqd, mrd, reg, with_alns=False,
                             debug=False, debug_extra=None):
    """Plain torch version of K4 on any device: the shared back half of the
    per-row core, over N directed pairs: single-switch refinement of the
    per-position flags, region breaks, anchored-match chaining,
    segmentation and aggregates (and per-segment records with with_alns).

    m1, m0: (N, Lq) bool; switchable, A, S, Ap, Sp: (N, NBF) bool; D, Dp:
    (N, NBF) int32; rlen: (N,) int32. Returns agg (N, 3) int32 =
    (n_alns, sum_match, sum_alnlen); with_alns also recs (N, MAXSEG, 6)
    int32 (-1 rows past the last record) and the number of records each
    pair had before the MAXSEG cap, (N,) int32."""
    N = m1.shape[0]
    NBF = Lq // FINE
    dev = m1.device
    i32 = torch.int32
    iota = torch.arange(Lq, dtype=i32, device=dev)[None, :]
    # --- 3. per-position match flags with single-switch refinement ------
    m0b = m0.reshape(N * NBF, FINE).to(i32)
    m1b = m1.reshape(N * NBF, FINE).to(i32)
    g = torch.cumsum(m0b - m1b, dim=-1, dtype=i32)
    gpad = torch.cat([torch.zeros((N * NBF, 1), dtype=i32, device=dev), g],
                     dim=-1)
    # Max-pack argmax: first position of the maximum prefix gain.
    tpack = ((gpad + FINE) << 8) | (
        255 - torch.arange(FINE + 1, dtype=i32, device=dev))
    tstar = 255 - (tpack.amax(dim=-1) & 255)
    tstar = torch.where(switchable.reshape(-1), tstar, 0)
    posb = torch.arange(FINE, dtype=i32, device=dev)[None, :]
    mb = torch.where(posb < tstar[:, None], m0b, m1b)
    m = mb.reshape(N, Lq).to(torch.bool)

    # --- 4. region breaks ------------------------------------------------
    linked = A & Ap & (S == Sp) & ((D - Dp).abs() <= mrd)
    first_blk = torch.zeros((N, NBF), dtype=torch.bool, device=dev)
    first_blk[:, 0] = True
    brk_blk = (A & Ap & ~linked & ~first_blk).reshape(-1)
    Bb = brk_blk[:, None] & (posb == tstar.clamp(max=FINE - 1)[:, None])
    Bbrk = Bb.reshape(N, Lq)

    # --- 5. anchored matches (bit-dilation chains) -----------------------
    in_run = _run_positions(m, MSL)
    in_anchor = _run_positions(m, MAL)   # long enough to OPEN a region
    near_run = _dilate_back(in_run, AW) | _dilate_fwd(in_run, AW)
    w15 = _win_sum(m.to(i32), AW_WIN)
    dense_end = w15 >= (AW_WIN - AM)
    covered_by_dense = _dilate_fwd(dense_end, AW_WIN - 1)
    ma = m & near_run & (covered_by_dense | in_run)

    # --- 6. segmentation + aggregates (8 scans) --------------------------
    pm_excl = _sh_r(_ffill_idx(ma, iota), 1, -1)
    any_prev = _dilate_back(_sh_r(ma, 1, False), mqd)  # ma in [i-mqd-1,i-1]
    lastB = _ffill_idx(Bbrk, iota)
    crossed = (lastB >= 0) & (lastB > pm_excl)
    seg_start = ma & (~any_prev | crossed)
    lastS = _ffill_idx(seg_start, iota)
    ns_after = _rev_next_idx(_sh_l(seg_start, 1, False), iota, Lq)
    nma_strict = _rev_next_idx(_sh_l(ma, 1, False), iota, BIG)
    e_flag = ma & (nma_strict >= ns_after)
    lastAnchor = _ffill_idx(in_anchor, iota)
    accept_e = e_flag & (iota - lastS + 1 >= reg) & (lastAnchor >= lastS)
    rv = _hcummax(torch.where(e_flag, (Lq - 1 - iota) * 2 + accept_e.to(i32),
                              -1), reverse=True)
    accE = (rv & 1) == 1
    lastE_excl = _sh_r(_ffill_idx(e_flag, iota), 1, -2)
    covered = (lastS >= 0) & (lastS > lastE_excl) & (rv >= 0)
    acc_cov = covered & accE
    n_alns = (seg_start & acc_cov).sum(dim=-1, dtype=i32)
    sum_match = (m & acc_cov).sum(dim=-1, dtype=i32)
    sum_alnlen = acc_cov.sum(dim=-1, dtype=i32)
    if debug:
        return dict(m=m, ma=ma, acc_cov=acc_cov, A=A, S=S, D=D,
                    seg_start=seg_start, e_flag=e_flag,
                    n_alns=n_alns, sum_match=sum_match,
                    sum_alnlen=sum_alnlen, **(debug_extra or {}))
    agg = torch.stack([n_alns, sum_match, sum_alnlen], dim=-1)  # (N, 3)
    if not with_alns:
        return agg

    # --- 7. per-segment records: each accepted segment has exactly one
    # accepted e_flag; compact those positions with one stable sort, then
    # decode (qstart, qend, rstart, rend, nt_match, nt_mismatch).
    macc = (m & acc_cov).to(i32)
    cm = torch.cumsum(macc, dim=-1, dtype=i32)     # inclusive prefix
    cm_excl = cm - macc
    # Per-position effective diagonal/strand (switch-point refined).
    tq = torch.repeat_interleave(tstar.reshape(N, NBF).clamp(max=FINE),
                                 FINE, dim=-1)
    in_pre = (iota % FINE) < tq
    D_eff = torch.where(in_pre, torch.repeat_interleave(Dp, FINE, dim=-1),
                        torch.repeat_interleave(D, FINE, dim=-1))
    S_eff = torch.where(in_pre, torch.repeat_interleave(Sp, FINE, dim=-1),
                        torch.repeat_interleave(S, FINE, dim=-1))
    rec = e_flag & acc_cov
    key = torch.where(rec, iota, BIG)
    p_start = torch.where(rec, lastS, -1)
    k_s, perm = torch.sort(key, dim=1, stable=True)
    MAXSEG = _maxseg(Lq, reg)
    r_end = torch.where(k_s[:, :MAXSEG] < BIG, perm[:, :MAXSEG].to(i32), -1)
    r_start = torch.where(r_end >= 0,
                          torch.gather(p_start, 1, perm[:, :MAXSEG]), -1)

    def g_(a, idx):
        return torch.gather(a, 1, idx.clamp(min=0).to(torch.int64))

    nt = g_(cm, r_end) - g_(cm_excl, r_start)
    d_s = g_(D_eff, r_start)
    d_e = g_(D_eff, r_end)
    strand = g_(S_eff, r_start)
    rj_s = r_start + d_s
    rj_e = r_end + d_e
    rl = rlen[:, None]
    rstart = torch.where(strand, rl - 1 - rj_s, rj_s)
    rend = torch.where(strand, rl - 1 - rj_e, rj_e)
    alnlen = r_end - r_start + 1
    recs = torch.stack([r_start, r_end, rstart, rend, nt, alnlen - nt],
                       dim=-1)
    recs = torch.where((r_start >= 0)[..., None], recs, -1)
    return agg, recs, rec.sum(dim=-1, dtype=i32)


def stage1_pack_plain(qocc, rocc, r_rows, q_rows):
    """Plain torch version of K2 on any device. qocc: (Gq, 2*NQB, H) int8
    arena; rocc: (Gr, NRB, H) int8 arena; r_rows: (R,) int32 arena rows of
    the references; q_rows: (R, K) int32 arena rows of the queries.

    Per query block and over all reference blocks rr, the maxima of
    ((Ma + Mb) << 13) | rr, (Ma << 13) | rr and (Mb << 13) | rr, where Ma
    and Mb are the shared-bucket counts of the block's two halves with
    reference block rr (ties go to the larger block). Returns three
    (R, K, NQB) int32 tensors. The products are float32 over chunks of
    512 reference blocks: sums of 0/1 below 2^24 are exact."""
    R, K = q_rows.shape
    M2 = qocc.shape[1]
    NRB = rocc.shape[1]
    qf = qocc[q_rows.to(torch.int64)].to(torch.float32)   # (R, K, M2, H)
    rows = r_rows.to(torch.int64)
    outs = None
    for lo in range(0, NRB, _STAGE1_CHUNK):
        hi = min(lo + _STAGE1_CHUNK, NRB)
        rf = rocc[rows, lo:hi].to(torch.float32)          # (R, CH, H)
        Mc = torch.matmul(qf, rf.transpose(1, 2)[:, None]).to(torch.int32)
        Ma, Mb = Mc[:, :, 0::2], Mc[:, :, 1::2]
        rr = torch.arange(lo, hi, dtype=torch.int32, device=qocc.device)
        part = [(((Ma + Mb) << _RB_BITS) | rr).amax(dim=-1),
                ((Ma << _RB_BITS) | rr).amax(dim=-1),
                ((Mb << _RB_BITS) | rr).amax(dim=-1)]
        outs = part if outs is None else [torch.maximum(a, b)
                                          for a, b in zip(outs, part)]
    return tuple(outs)


def band_counts_plain(wins, qb):
    """Stage 3 of `bands_v3_plain` on any device: the 32-step
    shift-compare-accumulate. wins: (4, N, WIN) int8 windows of the four
    bands (tags BAND_TAGS); qb: (N, FINE) int8 query bases. Returns the
    band counts (4, N, BAND) int8 of valid query bases (code < 4) equal
    to the window base at each shift, BAND = WIN - FINE, and the election
    (N,) int32: the max of (count << 12) | tag | shift over bands and
    shifts (ties: candidate 1, then forward, then the larger shift)."""
    BAND = wins.shape[2] - FINE
    qok = qb < 4
    acc = torch.zeros(wins.shape[:2] + (BAND,), dtype=torch.int8,
                      device=wins.device)
    for p in range(FINE):
        acc += ((wins[..., p:p + BAND] == qb[None, :, p:p + 1])
                & qok[None, :, p:p + 1]).to(torch.int8)
    tvec = torch.arange(BAND, dtype=torch.int32, device=wins.device)
    tags = torch.tensor(BAND_TAGS, dtype=torch.int32,
                        device=wins.device)[:, None, None]
    bb = ((acc.to(torch.int32) << 12) | tags | tvec).amax(dim=-1)
    return acc, bb.amax(dim=0)


def _band_windows(b, r_rows, rlens, g1, g2, g3):
    """Stage 2, for the plain versions only (K3 and K5 read the wide rows
    in place): the windows of the four bands (candidate 1 and 2, each
    forward at its block and reverse at its mirror block) for every fine
    block, (4, R, K, NBF, WIN) int8, and each band's first diagonal,
    (4, R, K, NBF) int32."""
    WQ, WIN, NRB, FPB = g3['WQ'], g3['WIN'], g3['NRB'], g3['FPB']
    R, K, NQB = g1.shape
    NBF = NQB * FPB
    dev = g1.device
    rlen = rlens.view(R, 1, 1)
    rr = r_rows.to(torch.int64).view(R, 1, 1)
    fc = torch.arange(NBF, device=dev) // FPB      # coarse block of fb
    Qs = (fc * WQ).to(torch.int32)

    def mirror(g):
        return ((rlen - 32 * g - 32) >> 5).clamp(0, NRB - 1)

    wins, bases = [], []
    for g, strand_rows in ((g1, b['roww_f']), (mirror(g1), b['roww_r']),
                           (g2, b['roww_f']), (mirror(g2), b['roww_r'])):
        row = strand_rows[rr, g.to(torch.int64)]             # (R,K,NQB,ROWW)
        w = row[..., 16:].unfold(-1, WIN, 32)[..., :FPB, :]
        wins.append(w.reshape(R, K, NBF, WIN))
        bases.append((32 * g)[..., fc] - Qs - WQ - 16)
    return torch.stack(wins), torch.stack(bases)


def _query_bases(b, q_rows, NBF):
    """The queries' codes a fine block, (R, K, NBF, FINE) int8."""
    R, K = q_rows.shape
    return b['fwd'][q_rows.to(torch.int64)].view(R, K, NBF, FINE)


def bands_v3_plain(b, r_rows, rlens, q_rows, cnt1, g1, cnt2, g2, tband,
                   smin, g3, windows=None):
    """Plain torch version of K3 on any device, stages 2-4: the windows
    (`_band_windows`), the band counts (`band_counts_plain`) and the
    election. b: the bucket dict (roww_f, roww_r, fwd); r_rows, rlens:
    (R,) int32; q_rows: (R, K) int32; cnt1, g1, cnt2, g2: stage 1's (R, K,
    NQB) int32; tband, smin: the thresholds (ints); windows: what
    `_band_windows` returns on these arguments, if the caller built it.
    Returns a dict: cnt (4, R, K, NBF, BAND) int8 and the elected
    cnt_best, A, S (True = reverse strand) and D, each (R, K, NBF)."""
    BAND, FPB = g3['BAND'], g3['FPB']
    R, K, NQB = g1.shape
    NBF = NQB * FPB
    dev = g1.device
    win, base = windows or _band_windows(b, r_rows, rlens, g1, g2, g3)
    qb = _query_bases(b, q_rows, NBF)
    qok = qb < 4
    cnt, bb = band_counts_plain(win.view(len(BAND_TAGS), -1, g3['WIN']),
                                qb.reshape(-1, FINE))
    del win
    cnt = cnt.view(len(BAND_TAGS), R, K, NBF, BAND)
    bb = bb.view(R, K, NBF)
    cnt_best = bb >> 12
    C1 = (bb & 2048) > 0
    S = (bb & 1024) == 0                           # True = reverse strand
    t_el = bb & ((1 << _T_BITS) - 1)
    base1 = torch.where(S, base[1], base[0])
    base_sel = torch.where(C1, base1, torch.where(S, base[3], base[2]))
    fc = torch.arange(NBF, device=dev) // FPB
    # cand2 carries HALF-block counts; gate it against smin/2 (>= 3).
    gate_ok = torch.where(C1, cnt1[..., fc] >= smin,
                          cnt2[..., fc] >= max(smin // 2, 3))
    D = base_sel + t_el
    # Election thresholds scale down on partial tail blocks.
    vq = qok.sum(dim=-1, dtype=torch.int32)
    tband_b = torch.clamp((vq * tband) // FINE, min=4).clamp(max=tband)
    A = (cnt_best >= tband_b) & gate_ok
    return dict(cnt=cnt, cnt_best=cnt_best, A=A, S=S, D=D)


def propagate_v3_plain(el, b, r_rows, rlens, q_rows, g1, g2, g3,
                       windows=None):
    """Plain torch version of K5 on any device, stages 5-6: neighbour
    propagation read from the band counts, then the final flags from the
    windows (bands holding the same (strand, diagonal) show the same
    reference bases, so OR-ing across containing bands is exact). el: the
    dict of `_bands_v3`; the windows and query bases come from the bucket
    dict b through r_rows, rlens, q_rows and stage 1's g1, g2, as
    `bands_v3_plain` builds them (or `windows`, as there). Returns m1, m0
    (R, K, Lq) bool and switchable, A, S, D, Ap, Sp, Dp (R, K, NBF)."""
    BAND = g3['BAND']
    cnt = el['cnt']
    A, S, D = el['A'], el['S'], el['D']
    win, base = windows or _band_windows(b, r_rows, rlens, g1, g2, g3)
    qb = _query_bases(b, q_rows, A.shape[-1])
    qok = qb < 4

    def count_at(Sx, Dx):
        out = None
        for i, is_rc in enumerate(_BAND_IS_RC):
            tn = Dx - base[i]
            ok = (Sx if is_rc else ~Sx) & (tn >= 0) & (tn < BAND)
            cv = torch.gather(cnt[i], -1, tn.clamp(0, BAND - 1).to(
                torch.int64)[..., None])[..., 0].to(torch.int32)
            cv = torch.where(ok, cv, -1)
            out = cv if out is None else torch.maximum(out, cv)
        return out

    cnt_cur = torch.where(A, el['cnt_best'], -1)
    for _ in range(EXT_ITERS):
        for shf in (_sh_r, _sh_l):
            Dn = shf(D, 1, 0)
            Sn = shf(S, 1, False)
            An = shf(A, 1, False)
            diff = (Dn != D) | (Sn != S)
            cn = torch.where(An & diff, count_at(Sn, Dn), -1)
            # Tier 1: rescue; tier 2: continuity (see the JAX package).
            better = (cn >= EXT_MIN) & (cn > cnt_cur + EXT_MARGIN)
            cont = A & (cn >= EXT_MIN) & (cn + V3_CONT >= cnt_cur) \
                & (cn <= cnt_cur)
            adopt = better | cont
            D = torch.where(adopt, Dn, D)
            S = torch.where(adopt, Sn, S)
            A = A | better
            cnt_cur = torch.where(adopt, cn, cnt_cur)

    def flags_at(Sx, Dx, okx):
        m = None
        for i, is_rc in enumerate(_BAND_IS_RC):
            tn = Dx - base[i]
            ok = okx & (Sx if is_rc else ~Sx) & (tn >= 0) & (tn < BAND)
            seg = _tree_slice(win[i], tn.clamp(0, BAND - 1), FINE)
            mx = (qb == seg) & qok & ok[..., None]
            m = mx if m is None else m | mx
        return m.flatten(-2)

    m1 = flags_at(S, D, A)
    Ap = _sh_r(A, 1, False)
    Sp = _sh_r(S, 1, False)
    Dp = _sh_r(D, 1, 0)
    switchable = A & Ap & ((D != Dp) | (S != Sp))
    m0 = flags_at(Sp, Dp, switchable)
    return m1, m0, switchable, A, S, D, Ap, Sp, Dp


def _strand_votes(sv, pk1, pk2, key_q, *, NQ, K, Lq, C, offset, pack_bits):
    """Candidate diagonals of all K queries of each row against one
    reference strand.

    sv: (R, NR) value-sorted reference seed values (BIG where invalid);
    pk1/pk2: (R, NR) int64 packs aligned to sv; key_q: (R, K*NQ) int32
    query sort keys (value << 6 | in-block offset << 1 | 1; an odd
    sentinel where invalid, so every query slot stays a query slot).
    One stable sort of the reference and query keys puts each query seed
    after every reference seed of its value; a running max of the packs
    then holds the last two reference occurrences of the largest value up
    to it. Returns (R, K, NQ, 2) int32 diagonal codes (BIG where none),
    offset added for the strand."""
    R, NR = sv.shape
    dev = sv.device
    KQ = K * NQ
    keys = torch.cat([torch.where(sv < BIG, sv << 6, BIG), key_q], dim=1)
    sk, perm = torch.sort(keys, dim=1, stable=True)
    # Sorted position of each query slot: the inverse permutation.
    inv = torch.empty_like(perm)
    inv.scatter_(1, perm, torch.arange(NR + KQ, device=dev).expand(R, -1))
    at_q = inv[:, NR:]
    s_k = torch.gather(sk, 1, at_q)                  # the query keys
    slot = torch.arange(KQ, dtype=torch.int32, device=dev)
    qpos = ((slot % NQ) // C) * FINE + ((s_k >> 1) & 31)
    base = Lq + offset - qpos                       # diagonal = pos + base
    val = (s_k >> 6).to(torch.int64)
    zq = torch.zeros((R, KQ), dtype=torch.int64, device=dev)

    def running_max(pk):
        c = _hcummax(torch.gather(torch.cat([pk, zq], dim=1), 1, perm))
        return torch.gather(c, 1, at_q)

    def diag(ok, p):                                # p: position + 1
        return torch.where(ok, (p - 1 + base).to(torch.int32), BIG)

    if pack_bits == 32:
        c1, c2 = running_max(pk1), running_max(pk2)
        d1 = diag((c1 >> 16 == val) & (c1 > 0), c1 & 0xFFFF)
        d2 = diag((c2 >> 16 == val) & (c2 > 0), c2 & 0xFFFF)
    else:
        c = running_max(pk1)
        ok = (c >> 40 == val) & (c > 0)
        cq = c & 0xFFFFF
        d1 = diag(ok, (c >> 20) & 0xFFFFF)
        d2 = diag(ok & (cq > 0), cq)
    return torch.stack([d1, d2], dim=-1).view(R, K, NQ, 2)


def _elect(sd, cstride, min_votes, *, DSPAN, Lq):
    """Densest-cluster election on per-block sorted votes sd (rows, vpb)
    int32: count the votes within GAP_DIAG above each (saturating at
    SMAX, on a cstride-subsample of the row), elect the largest count with
    ties to the smallest start (a packed max), then the cluster's mode.
    Returns (assigned, strand, diag, exact votes, mode) per row."""
    sds = sd[:, ::cstride]
    w = sds.shape[1]
    smax = min(SMAX, w - 1)
    sdp = torch.cat([sds, torch.full((sds.shape[0], smax), BIG,
                                     dtype=sds.dtype, device=sds.device)],
                    dim=-1)
    cnt = torch.ones_like(sds)
    cnt_eq = torch.ones_like(sds)
    for s in range(1, smax + 1):
        cnt += sdp[:, s:w + s] - sds <= GAP_DIAG
        cnt_eq += sdp[:, s:w + s] == sds
    ok = sds < BIG
    cnt = torch.where(ok, cnt, 0)
    cnt_eq = torch.where(ok, cnt_eq, 0)
    # Vote codes reach 2*DSPAN + 64; the pack widens to int64 when they
    # need more than 22 bits (counts <= 256 take 9). The clamp runs in the
    # pack's type: a 32-bit mask does not fit int32 (ROADMAP R9).
    if 2 * DSPAN + 64 < 1 << 22:
        VBITS, pdt = 22, torch.int32
    else:
        VBITS, pdt = 32, torch.int64
    VMASK = (1 << VBITS) - 1
    inv = VMASK - sds.to(pdt).clamp(max=VMASK)
    best = ((cnt.to(pdt) << VBITS) | inv).amax(dim=-1)
    vb = (best >> VBITS).to(torch.int32)
    start = (VMASK - (best & VMASK)).to(torch.int32)[:, None]
    inb = (sds >= start) & (sds <= start + GAP_DIAG)
    bestm = torch.where(inb, (cnt_eq.to(pdt) << VBITS) | inv, -1).amax(dim=-1)
    medv = torch.where(vb > 0, (VMASK - (bestm & VMASK)).to(torch.int32), BIG)
    vb_x = ((sd - medv[:, None]).abs() <= GAP_DIAG).sum(dim=-1,
                                                         dtype=torch.int32)
    vb_x = torch.where(medv < BIG, vb_x, 0)
    strand = medv >= DSPAN
    diag = torch.where(strand, medv - DSPAN, medv) - Lq
    return vb_x >= min_votes, strand, diag, vb_x, medv


def _eval_on(q_fwd, r2dov, r_rows, D, S, okb, rlen, qlens, *, Lr):
    """Per-position match flags of each query against the reference bases
    on its fine block's elected diagonal: a 32-base window of the 64-wide
    row at each block's start, clipped to [-FINE, Lr-1] (the lead pad row
    makes slightly negative starts read bases that never match).

    q_fwd: (R, K, Lq) int8; r2dov: (G, 2*NRT, 64) int8 arena, r_rows (R,)
    its rows; D, S, okb: (R, K, NBF); rlen: (R,); qlens: (R, K). Returns
    (R, K, Lq) bool."""
    R, K, NBF = D.shape
    Lq = NBF * FINE
    dev = D.device
    NRT = r2dov.shape[1] // 2
    starts = torch.arange(NBF, dtype=torch.int32, device=dev) * FINE + D
    starts_c = starts.clamp(-FINE, Lr - 1)
    row = (starts_c + FINE) >> 5
    phase = starts_c + FINE - (row << 5)
    row = row + torch.where(S, NRT, 0)
    at = ((r_rows.to(torch.int64).view(R, 1, 1) * (2 * NRT) + row) * 64
          + phase)[..., None] + torch.arange(FINE, device=dev)
    rb = r2dov.view(-1)[at].view(R, K, Lq)
    okq = (okb & (starts == starts_c)).repeat_interleave(FINE, dim=-1)
    iota = torch.arange(Lq, dtype=torch.int32, device=dev)
    rj = iota + D.repeat_interleave(FINE, dim=-1)
    ok = okq & (rj >= 0) & (rj < rlen.view(R, 1, 1)) & (iota < qlens[..., None])
    return ok & (q_fwd == rb) & (q_fwd < 4)


def votes_v2_plain(b, r_rows, q_rows, *, Lq, Lr, C):
    """Plain torch version of K6's search (K8, fused into K6) on any
    device, stage 1: the seed votes of R rows (one reference, K queries
    each) on both strands, (R, K, NQ, 4) int32: the two candidates
    forward, then the two reverse (offset DSPAN)."""
    R, K = q_rows.shape
    NQ = (Lq // FINE) * C
    rr = r_rows.to(torch.int64)
    qr = q_rows.to(torch.int64)
    qsv = b['qsv'][qr]
    key_q = torch.where(qsv >= 0, (qsv << 6) | (b['qoff'][qr] << 1) | 1,
                        BIG + 1).view(R, K * NQ)
    sv_args = dict(NQ=NQ, K=K, Lq=Lq, C=C, pack_bits=b['pack_bits'])
    return torch.cat(
        [_strand_votes(b['sv_f'][rr], b['pk1_f'][rr], b['pk2_f'][rr], key_q,
                       offset=0, **sv_args),
         _strand_votes(b['sv_r'][rr], b['pk1_r'][rr], b['pk2_r'][rr], key_q,
                       offset=Lq + Lr + 64, **sv_args)], dim=-1)


def elect_v2_plain(votes, *, Lq, Lr):
    """Plain torch version of K6's election on any device, stage 2: the
    two-scale block election on the votes (R, K, NQ, 4): per fine block
    the fine election, overridden by the coarse block's unless the fine
    one strictly beats the fine block's support for the coarse diagonal
    (repeats support two clusters equally). Returns A, S (True = reverse
    strand), D and the winner's votes vb, (R, K, NBF)."""
    R, K, NQ, _ = votes.shape
    N = R * K
    NBF = Lq // FINE
    NBC = Lq // BLOCK
    RATIO = BLOCK // FINE
    DSPAN = Lq + Lr + 64
    vpb_f = NQ // NBF * 2 * CANDS
    sd_f = torch.sort(votes.reshape(N * NBF, vpb_f), dim=-1).values
    A_f, S_f, D_f, vb_f, _ = _elect(sd_f, 1, MIN_VOTES_F, DSPAN=DSPAN, Lq=Lq)
    sd_c = torch.sort(votes.reshape(N * NBC, vpb_f * RATIO), dim=-1).values
    A_c, S_c, D_c, vb_c, medv_c = _elect(sd_c, 4, MIN_VOTES_C, DSPAN=DSPAN,
                                         Lq=Lq)

    def fine(x):                    # coarse-block values at each fine block
        return x.view(N, NBC).repeat_interleave(RATIO, dim=-1).view(-1)

    sup_c = ((sd_f - fine(medv_c)[:, None]).abs() <= GAP_DIAG).sum(
        dim=-1, dtype=torch.int32)
    A_cf = fine(A_c)
    use_f = A_f & (~A_cf | (vb_f > sup_c))
    shape = (R, K, NBF)
    return ((use_f | A_cf).view(shape),
            torch.where(use_f, S_f, fine(S_c)).view(shape),
            torch.where(use_f, D_f, fine(D_c)).view(shape),
            torch.where(use_f, vb_f, fine(vb_c)).view(shape))


def propagate_v2_plain(b, r_rows, rlens, q_rows, qlens, A, S, D, *, Lr):
    """Plain torch version of K7 on any device, stage 3: neighbour-
    diagonal propagation: a block adopts an adjacent block's diagonal when
    evaluating it (`_eval_on`) beats its own election by a clear margin
    (EXT_MIN, EXT_MARGIN), EXT_ITERS times each way; then the final flags.
    F holds the current winner's flags, so m1 needs no re-evaluation.
    Returns what `_propagate_v3` returns."""
    R, K, NBF = A.shape
    q_fwd = b['fwd'][q_rows.to(torch.int64)]
    rlen = rlens.view(R)

    def block_flags(Db, Sb, Ab):
        mm = _eval_on(q_fwd, b['r2dov'], r_rows, Db, Sb, Ab, rlen, qlens,
                      Lr=Lr)
        return mm, mm.view(R, K, NBF, FINE).sum(dim=-1, dtype=torch.int32)

    F, cnt0 = block_flags(D, S, A)
    cnt_cur = torch.where(A, cnt0, -1)
    for _ in range(EXT_ITERS):
        for shf in (_sh_r, _sh_l):
            Dc = shf(D, 1, 0)
            Sc = shf(S, 1, False)
            Ac = shf(A, 1, False)
            mmc, cntc = block_flags(Dc, Sc, Ac)
            better = Ac & (cntc >= EXT_MIN) & (cntc > cnt_cur + EXT_MARGIN)
            D = torch.where(better, Dc, D)
            S = torch.where(better, Sc, S)
            A = A | better
            cnt_cur = torch.where(better, cntc, cnt_cur)
            F = torch.where(better.repeat_interleave(FINE, dim=-1), mmc, F)

    Ap = _sh_r(A, 1, False)
    Sp = _sh_r(S, 1, False)
    Dp = _sh_r(D, 1, 0)
    switchable = A & Ap & ((D != Dp) | (S != Sp))
    m0 = _eval_on(q_fwd, b['r2dov'], r_rows, Dp, Sp, switchable, rlen, qlens,
                  Lr=Lr)
    return F, m0, switchable, A, S, D, Ap, Sp, Dp


# --------------------------------------------------------------------------
# the driver: each directed pair on a row of its own
# --------------------------------------------------------------------------

def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of codes 0-4 (4 stays 4)."""
    return np.array([3, 2, 1, 0, 4], dtype=np.int8)[codes][::-1]


def _stage1_v3(qocc, rocc, r_rows, q_rows):
    p_sum, p_a, p_b = stage1_pack_plain(qocc, rocc, r_rows, q_rows)
    mask = (1 << _RB_BITS) - 1
    cnt1 = p_sum >> _RB_BITS
    g1 = p_sum & mask
    ga, gb = p_a & mask, p_b & mask
    use_a = (ga - g1).abs() >= (gb - g1).abs()
    g2 = torch.where(use_a, ga, gb)
    cnt2 = torch.where(use_a, p_a, p_b) >> _RB_BITS
    return cnt1, g1, cnt2, g2


def _flat(x, N):
    return x.reshape((N,) + x.shape[2:])


def row_core_v3(b, r_rows, rlens, q_rows, Lq):
    """v3 aggregates (R, K, 3) of R rows of K queries, each row one
    reference."""
    g3 = _v3_geom(Lq, Lq)
    R, K = q_rows.shape
    cnt1, g1, cnt2, g2 = _stage1_v3(b['qocc'], b['rocc'], r_rows, q_rows)
    args = (b, r_rows, rlens, q_rows)
    wb = _band_windows(b, r_rows, rlens, g1, g2, g3)
    el = bands_v3_plain(*args, cnt1, g1, cnt2, g2, V3_TBAND, V3_SMIN, g3,
                        windows=wb)
    props = propagate_v3_plain(el, *args, g1, g2, g3, windows=wb)
    del wb, el
    N = R * K
    agg = blocks_to_measures_plain(
        *(_flat(x, N) for x in props), rlens[:, None].expand(R, K).reshape(N),
        Lq=Lq, mqd=MQD, mrd=MRD, reg=REG)
    return agg.view(R, K, 3)


def row_core_v2(b, r_rows, rlens, q_rows, qlens, Lq, C):
    """v2 aggregates (R, K, 3) at C seeds a block."""
    R, K = q_rows.shape
    A, S, D, _vb = elect_v2_plain(
        votes_v2_plain(b, r_rows, q_rows, Lq=Lq, Lr=Lq, C=C), Lq=Lq, Lr=Lq)
    flags = propagate_v2_plain(b, r_rows, rlens, q_rows, qlens, A, S, D,
                               Lr=Lq)
    N = R * K
    agg = blocks_to_measures_plain(
        *(_flat(x, N) for x in flags), rlens[:, None].expand(R, K).reshape(N),
        Lq=Lq, mqd=MQD, mrd=MRD, reg=REG)
    return agg.view(R, K, 3)


# Genomes a chunk of an arena build, and bytes a query position of a row
# that a plain row core holds live (the float32 stage-1 operand, the
# windows, the band counts, their election and the back half's scans, with
# room), which sets the rows a chunk.
_ARENA_CHUNK = 64
_ROW_BYTES_PER_POS = 640


def build_arena(codes_list, gids, Lp, pipe, device, C=SEEDS_PER_BLOCK):
    """The bucket-Lp arena of genomes `gids` (sorted) on `device`: the
    padded codes (4 past a genome's end; the reverse complement led by the
    genome's own bases) and the v3 or the v2 arrays, with 'rows' mapping a
    genome to its row."""
    G = len(gids)
    fwd = np.full((G, Lp), 4, dtype=np.int8)
    rc = np.full((G, Lp), 4, dtype=np.int8)
    for row, g in enumerate(gids):
        c = np.asarray(codes_list[g], dtype=np.int8)
        fwd[row, :len(c)] = c
        rc[row, :len(c)] = revcomp(c)
    fwd_d = torch.from_numpy(fwd).to(device)
    rc_d = torch.from_numpy(rc).to(device)
    parts = []
    for lo in range(0, G, _ARENA_CHUNK):
        f, r = fwd_d[lo:lo + _ARENA_CHUNK], rc_d[lo:lo + _ARENA_CHUNK]
        parts.append(index_block_v3_plain(f, r, SEED_K, Lp) if pipe == 'v3'
                     else index_block_plain(f, r, SEED_K, _pack_bits(Lp), C))
    keys = (('qocc', 'rocc', 'roww_f', 'roww_r') if pipe == 'v3' else
            ('qsv', 'qoff', 'sv_f', 'pk1_f', 'pk2_f', 'sv_r', 'pk1_r',
             'pk2_r', 'r2dov'))
    b = {k: torch.cat([p[i] for p in parts]) for i, k in enumerate(keys)}
    b['fwd'] = fwd_d
    b['pack_bits'] = _pack_bits(Lp)
    b['rows'] = {int(g): row for row, g in enumerate(gids)}
    return b


def _run(codes_list, lens, pairs, kb, pipe, device, C=SEEDS_PER_BLOCK):
    """(len(pairs), 6) int64 aggregates of `pairs` at their buckets `kb` on
    one pipe: columns 0-2 the direction (query j, reference i), 3-5 the
    direction (query i, reference j)."""
    out = np.zeros((len(pairs), 6), dtype=np.int64)
    for L in sorted(set(kb.tolist())):
        at = np.flatnonzero(kb == L)
        gids = sorted(set(pairs[at].reshape(-1).tolist()))
        b = build_arena(codes_list, gids, L, pipe, device, C)
        rowmap = b['rows']
        # Directed tasks: (query, reference, pair, first column).
        q = np.concatenate([pairs[at, 1], pairs[at, 0]])
        r = np.concatenate([pairs[at, 0], pairs[at, 1]])
        where = np.concatenate([at, at])
        col = np.repeat([0, 3], len(at))
        step = max(1, (2 << 30) // (_ROW_BYTES_PER_POS * L))
        for lo in range(0, len(q), step):
            sl = slice(lo, lo + step)

            def t(x):
                return torch.from_numpy(np.ascontiguousarray(
                    x, dtype=np.int32)).to(device)
            r_rows = t([rowmap[g] for g in r[sl]])
            rlens = t(lens[r[sl]])
            q_rows = t([[rowmap[g]] for g in q[sl]])
            if pipe == 'v3':
                agg = row_core_v3(b, r_rows, rlens, q_rows, L)
            else:
                agg = row_core_v2(b, r_rows, rlens, q_rows,
                                  t(lens[q[sl]][:, None]), L, C)
            agg = agg[:, 0].cpu().numpy().astype(np.int64)
            for c in range(3):
                out[where[sl], col[sl] + c] = agg[:, c]
        del b
    return out


def align_pairs(codes_list, pairs, device='cpu'):
    """(len(pairs), 6) int64 aggregates of candidate `pairs` (i, j) over
    `codes_list` (int8 codes 0-4), as the port's `all2all_gpu` gives them
    with its defaults, and the (len(pairs),) bool of the pairs the hybrid
    aligned again on v2."""
    lens = np.array([len(c) for c in codes_list], dtype=np.int64)
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    kb = np.array([max(_pad_bucket(lens[i]), _pad_bucket(lens[j]))
                   for i, j in pairs], dtype=np.int64)
    if (lens > MAX_TPU_LEN).any():
        raise ValueError(f'a genome is longer than {MAX_TPU_LEN} bases')
    # The float32 products of stage 1 are exact only outside TF32.
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = np.zeros((len(pairs), 6), dtype=np.int64)
        v3 = kb <= V3_MAX_BUCKET
        for sel, pipe in ((v3, 'v3'), (~v3, 'v2')):
            if sel.any():
                out[sel] = _run(codes_list, lens, pairs[sel], kb[sel], pipe,
                                device)
        lj = np.maximum(lens[pairs[:, 1]], 1)
        li = np.maximum(lens[pairs[:, 0]], 1)
        tani = (out[:, 1] + out[:, 4]) / (lj + li)
        hard = (tani > 0.05) & ((out[:, 2] / lj < V3_RERUN_COV)
                                | (out[:, 5] / li < V3_RERUN_COV))
        # Pairs above V3_MAX_BUCKET ran on v2 at this density already.
        again = hard & v3
        if again.any():
            out[again] = _run(codes_list, lens, pairs[again], kb[again],
                              'v2', device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out, hard
