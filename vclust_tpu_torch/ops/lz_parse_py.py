"""Reference (host, Python) implementation of the LZ-style greedy aligner.

Re-derivation of lz-ani's algorithm from its observable contract
(reference vclust.py:363-418 parameter surface; golden outputs
example/output/ani.aln.tsv — alignments never overlap on the
query, i.e. the parse is a true left-to-right LZ factorization of the query
against the reference).

Algorithm (one directed pair, query q vs reference r):

1. Index both strands of r: hash tables anchor(mal)-mer -> positions and
   seed(msl)-mer -> positions.
2. Scan q left to right.
   - OPEN state: look up the anchor at position i; among candidate reference
     positions pick the one with the longest exact match; if none, i += 1.
   - EXTEND state (inside a region): within a window of mqd query positions
     after the previous factor, look up seed matches constrained to land
     within mrd of the expected reference continuation (same strand,
     monotone); pick the best; otherwise close the region.
   - Each factor is extended exactly, then approximately: keep consuming
     bases while the trailing window of `aw` positions has <= `am`
     mismatches; afterwards trim so the factor ends with a run of >= `ar`
     matches.
3. Factors chained in EXTEND state form a region; query gaps between factors
   count as mismatches. Regions shorter than `reg` are discarded.

This module is the correctness oracle for the C++ host engine and the CUDA
extension kernel (ops/extend.py); it is intentionally simple, not fast.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.seq import encode, revcomp_codes


@dataclass
class AlignParams:
    mal: int = 11   # min anchor length (opens a region)
    msl: int = 7    # min seed length (continues a region)
    mrd: int = 40   # max reference-side distance between linked matches
    mqd: int = 40   # max query-side distance between linked matches
    reg: int = 35   # min region (alignment) length
    aw: int = 15    # approximate-extension window length
    am: int = 7     # max mismatches tolerated inside the window
    ar: int = 3     # match-run length that must terminate approx extension
    # --- policy knobs (tuned empirically against the golden outputs; the
    # reference C++ internals are unobservable, SURVEY.md section 7.3) ---
    gap_policy: str = 'prev'   # inter-factor gap accounting:
    #   'mismatch' - all gap positions count as mismatches
    #   'prev'     - compare gap on the previous factor's diagonal
    #   'next'     - compare gap on the next factor's diagonal
    #   'split'    - optimal single split between both diagonals
    seed_back: int = 0         # how far a seed may land before the previous
    #                            factor's reference end (duplication reuse)
    region_back_ext: bool = True   # approx-extend a region's first factor
    #                                backward (left of the opening anchor)
    anchor_in_region: bool = True   # may a far anchor preempt (close) an
    #                                 active region before the mqd timeout?
    anchor_preempt_len: int = 0     # with anchor_in_region: min extended
    #   factor length a far anchor needs to preempt an active region
    #   (0 = any anchor preempts)
    seed_window_qscale: bool = True  # widen the seed window by the query gap


@dataclass
class Alignment:
    qstart: int     # 0-based inclusive
    qend: int
    rstart: int     # 0-based; on reverse strand rstart > rend
    rend: int
    nt_match: int
    nt_mismatch: int
    strand: int     # +1 forward, -1 reverse

    @property
    def alnlen(self) -> int:
        return self.qend - self.qstart + 1


def _window_values(codes: np.ndarray, k: int) -> np.ndarray:
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64)
    vals = np.zeros(n, dtype=np.int64)
    c = codes.astype(np.int64)
    for j in range(k):
        vals = (vals << 2) | c[j:j + n]
    return vals


def _index(codes: np.ndarray, k: int, valid: np.ndarray) -> Dict[int, np.ndarray]:
    vals = _window_values(np.where(codes >= 4, 0, codes), k)
    vals = np.where(valid[:len(vals)], vals, -1)
    order = np.argsort(vals, kind='stable')
    sv = vals[order]
    idx: Dict[int, np.ndarray] = {}
    bounds = np.flatnonzero(np.diff(sv)) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(sv)]])
    for s, e in zip(starts, ends):
        v = sv[s]
        if v >= 0:
            idx[int(v)] = np.sort(order[s:e])
    return idx


def _valid_windows(codes: np.ndarray, k: int) -> np.ndarray:
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=bool)
    invalid = (codes >= 4).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(invalid)])
    return (cs[k:] - cs[:-k]) == 0


class ReferenceIndex:
    """Anchor/seed hash index over both strands of one reference genome."""

    def __init__(self, codes: np.ndarray, params: AlignParams):
        self.params = params
        self.fwd = codes
        self.rc = revcomp_codes(codes)
        self.n = len(codes)
        self.anchors = []
        self.seeds = []
        for strand_codes in (self.fwd, self.rc):
            va = _valid_windows(strand_codes, params.mal)
            vs = _valid_windows(strand_codes, params.msl)
            self.anchors.append(_index(strand_codes, params.mal, va))
            self.seeds.append(_index(strand_codes, params.msl, vs))


def _extend(q: np.ndarray, r: np.ndarray, qs: int, rs: int, klen: int,
            params: AlignParams) -> Tuple[int, int]:
    """Extend a factor starting with an exact match of length klen at
    (qs, rs). Returns (total_len, nt_match) of the factor."""
    nq, nr = len(q), len(r)
    i, j = qs + klen, rs + klen
    # Exact extension.
    while i < nq and j < nr and q[i] == r[j] and q[i] < 4:
        i += 1
        j += 1
    exact_len = i - qs
    # Approximate extension with a sliding mismatch window.
    aw, am, ar = params.aw, params.am, params.ar
    window = []          # 1 = mismatch flags for last aw positions
    mism_in_window = 0
    history = []         # per-position match flags of the approx part
    while i < nq and j < nr:
        is_match = (q[i] == r[j]) and q[i] < 4
        flag = 0 if is_match else 1
        window.append(flag)
        mism_in_window += flag
        if len(window) > aw:
            mism_in_window -= window.pop(0)
        if mism_in_window > am:
            break
        history.append(1 if is_match else 0)
        i += 1
        j += 1
    # Trim the approx part so it ends with a run of >= ar matches.
    run = 0
    cut = 0
    for pos in range(len(history) - 1, -1, -1):
        if history[pos]:
            run += 1
            if run >= ar:
                cut = pos + run
                break
        else:
            run = 0
    else:
        cut = 0
    approx = history[:cut]
    total_len = exact_len + len(approx)
    nt_match = exact_len + sum(approx)
    return total_len, nt_match


def _best_candidate(q: np.ndarray, r: np.ndarray, i: int, positions,
                    klen: int, params: AlignParams,
                    expected: Optional[int] = None):
    """Pick the candidate position with the longest factor; ties broken by
    proximity to the expected continuation (if any) then by position."""
    best = None
    for j in positions:
        total_len, nt_match = _extend(q, r, i, int(j), klen, params)
        if expected is not None:
            tie = abs(int(j) - expected)
        else:
            tie = int(j)
        key = (-total_len, tie)
        if best is None or key < best[0]:
            best = (key, int(j), total_len, nt_match)
    if best is None:
        return None
    return best[1], best[2], best[3]


def parse_pair(q_codes: np.ndarray, ref_index: ReferenceIndex,
               params: AlignParams = None,
               record_factors: Optional[list] = None) -> List[Alignment]:
    """LZ-parse query against reference; return accepted alignments.

    If ``record_factors`` is a list, the per-alignment factor chains
    (strand-local coordinates) are appended to it — used by tests and by the
    golden-parity tuning harness."""
    params = params or ref_index.params
    p = params
    nq = len(q_codes)
    nr = ref_index.n
    anchor_vals = _window_values(np.where(q_codes >= 4, 0, q_codes), p.mal)
    seed_vals = _window_values(np.where(q_codes >= 4, 0, q_codes), p.msl)
    va = _valid_windows(q_codes, p.mal)
    vs = _valid_windows(q_codes, p.msl)

    strands = [(0, ref_index.fwd), (1, ref_index.rc)]
    alignments: List[Alignment] = []

    # Active region state.
    region = None   # dict(strand, factors=[(qs,qe,rs,re)], nt_match)
    prev_factor_end = -1   # qend of the last factor of the previous region

    def _gap_matches(rseq, qe1, re1, qs2, rs2) -> int:
        """Matches credited to the query gap between two linked factors."""
        gap = qs2 - qe1 - 1
        if gap <= 0 or p.gap_policy == 'mismatch':
            return 0
        gq = q_codes[qe1 + 1:qs2]
        prev_cmp = np.zeros(gap, dtype=bool)
        seg = rseq[re1 + 1:re1 + 1 + gap]
        prev_cmp[:len(seg)] = (gq[:len(seg)] == seg) & (gq[:len(seg)] < 4)
        if p.gap_policy == 'prev':
            return int(prev_cmp.sum())
        nxt_cmp = np.zeros(gap, dtype=bool)
        seg2 = rseq[max(0, rs2 - gap):rs2]
        nxt_cmp[gap - len(seg2):] = (gq[gap - len(seg2):] == seg2) & \
            (gq[gap - len(seg2):] < 4)
        if p.gap_policy == 'next':
            return int(nxt_cmp.sum())
        # 'split': best prefix on the previous diagonal + suffix on the next.
        pc = np.concatenate([[0], np.cumsum(prev_cmp)])
        nc = np.concatenate([[0], np.cumsum(nxt_cmp[::-1])])[::-1]
        return int((pc + nc).max())

    def _back_extend(qs: int, rs: int, qlimit: int):
        """Approx-extend backward from (qs-1, rs-1); mirror of the forward
        rule: sliding aw-window with <= am mismatches, trimmed so the
        extension's far (left) end is a run of >= ar matches.
        Returns (ext_len, ext_match)."""
        strand_len = qs - qlimit - 1
        window = []
        mism = 0
        history = []
        i_, j_ = qs - 1, rs - 1
        while i_ > qlimit and j_ >= 0:
            is_match = (q_codes[i_] == rseq_active[j_]) and q_codes[i_] < 4
            flag = 0 if is_match else 1
            window.append(flag)
            mism += flag
            if len(window) > p.aw:
                mism -= window.pop(0)
            if mism > p.am:
                break
            history.append(1 if is_match else 0)
            i_ -= 1
            j_ -= 1
        run = 0
        cut = 0
        for pos in range(len(history) - 1, -1, -1):
            if history[pos]:
                run += 1
                if run >= p.ar:
                    cut = pos + run
                    break
            else:
                run = 0
        history = history[:cut]
        return len(history), sum(history)

    rseq_active = None

    def close_region():
        nonlocal region, prev_factor_end, rseq_active
        if region is None:
            return
        factors = region['factors']
        strand = region['strand']
        rseq = strands[strand][1]
        rseq_active = rseq
        qs = factors[0][0]
        rs = factors[0][2]
        nt_match = region['nt_match']
        # Gap accounting between consecutive factors.
        for a, b in zip(factors, factors[1:]):
            nt_match += _gap_matches(rseq, a[1], a[3], b[0], b[2])
        # Backward approximate extension of the first factor.
        if p.region_back_ext:
            ext_len, ext_match = _back_extend(qs, rs, region['qlimit'])
            qs -= ext_len
            rs -= ext_len
            nt_match += ext_match
        qe = factors[-1][1]
        re_ = factors[-1][3]
        alnlen = qe - qs + 1
        accepted = alnlen >= p.reg
        if accepted:
            if strand == 0:
                rstart, rend = rs, re_
            else:
                # Map reverse-strand coordinates back to forward coords.
                rstart, rend = nr - 1 - rs, nr - 1 - re_
            if record_factors is not None:
                record_factors.append((strand, list(factors)))
            alignments.append(Alignment(
                qstart=qs, qend=qe, rstart=rstart, rend=rend,
                nt_match=nt_match, nt_mismatch=alnlen - nt_match,
                strand=+1 if strand == 0 else -1))
        if accepted:
            # Only accepted alignments claim query territory; the span of a
            # discarded (< reg) region stays reclaimable by the backward
            # extension of a later region.
            prev_factor_end = factors[-1][1]
        region = None

    i = 0
    while i < nq:
        factor = None
        if region is not None:
            # Try seed continuation within the query gap window.
            strand = region['strand']
            rseq = strands[strand][1]
            last_qe = region['factors'][-1][1]
            last_re = region['factors'][-1][3]
            if i - last_qe - 1 > p.mqd:
                close_region()
            else:
                if i < len(vs) and vs[i]:
                    positions = ref_index.seeds[strand].get(int(seed_vals[i]))
                    if positions is not None:
                        expected = last_re + (i - last_qe)
                        lo = np.searchsorted(positions,
                                             last_re + 1 - p.seed_back)
                        width = p.mrd + ((i - last_qe)
                                         if p.seed_window_qscale else 0)
                        hi = np.searchsorted(positions,
                                             last_re + 1 + width)
                        cands = positions[lo:hi]
                        if len(cands):
                            got = _best_candidate(
                                q_codes, rseq, i, cands, p.msl, p,
                                expected=expected)
                            if got is not None:
                                j, total_len, nt_match = got
                                factor = (strand, j, total_len, nt_match)
        if (factor is None and i < len(va) and va[i]
                and (region is None or p.anchor_in_region)):
            # Anchor: open (or re-open) a region; consider both strands.
            best = None
            for strand, rseq in strands:
                positions = ref_index.anchors[strand].get(int(anchor_vals[i]))
                if positions is None:
                    continue
                got = _best_candidate(q_codes, rseq, i, positions, p.mal, p)
                if got is not None:
                    j, total_len, nt_match = got
                    if best is None or total_len > best[2]:
                        best = (strand, j, total_len, nt_match)
            if best is not None:
                if region is None:
                    factor = best
                else:
                    reachable = False
                    if best[0] == region['strand']:
                        last_qe = region['factors'][-1][1]
                        last_re = region['factors'][-1][3]
                        gap_r = best[1] - last_re - 1
                        width = p.mrd + ((i - last_qe)
                                         if p.seed_window_qscale else 0)
                        reachable = -p.seed_back <= gap_r <= width
                    if reachable:
                        factor = best
                    elif best[2] >= p.anchor_preempt_len:
                        # A strong far anchor preempts the active region.
                        close_region()
                        factor = best
                    # else: weak far anchor ignored; keep scanning.

        if factor is None:
            if region is not None:
                last_qe = region['factors'][-1][1]
                if i - last_qe - 1 >= p.mqd:
                    close_region()
            i += 1
            continue

        strand, j, total_len, nt_match = factor
        qs, qe = i, i + total_len - 1
        rs, re_ = j, j + total_len - 1
        if region is None:
            region = {'strand': strand, 'factors': [], 'nt_match': 0,
                      'qlimit': prev_factor_end}
        region['factors'].append((qs, qe, rs, re_))
        region['nt_match'] += nt_match
        i = qe + 1

    close_region()
    return alignments
