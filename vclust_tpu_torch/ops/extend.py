"""Batched approximate-match extension: kernel KX (csrc/extend.cu).

The port of the JAX package's Pallas kernel `_extend_kernel`
(ops/extend_pallas.py there), with the same public functions
`pad_codes` and `batched_extend`. Each job starts at query/reference
offsets (qi, ri) and extends forward while every trailing window of `aw`
bases has <= `am` mismatches, then cuts so the result ends with a run of
>= `ar` matches -- the semantics of ops/lz_parse_py._extend, as one forward
scan capped at CAP bases. Returns (total_len, nt_match) per job.

Like the JAX kernel, this is a library entry point: no stage of the
pipeline calls it (the host engines extend inline, one pair at a time).

`extend` is the wrapper: CPU tensors take `extend_plain` (a scan over the
job batch in blocks of SPAN positions, the TPU kernel's own formulation),
CUDA tensors launch the kernel or raise. The kernel is two launches a call
(csrc/extend.cu: A scans each job's first FIRST positions, B the rest of
the jobs left in rounds), so `extend.launches` grows by 2 a call.
`extend_chunked_plain` models how the kernel cuts a job into ranges that
are summarised apart and combined in order; only tests use it.
"""

import ctypes

import numpy as np
import torch

from . import cuda
from ..utils.device import resolve_device

SPAN = 1024            # positions per block step of the plain scan
MAX_BLOCKS = 256
CAP = SPAN * MAX_BLOCKS  # longest extension scanned (262,144 bases)
# How csrc/extend.cu cuts a job (its constants of the same names): launch A
# scans [0, FIRST); launch B's round k gives each of WARPS warps SUB0 <<
# min(k, DOUBLINGS) positions.
FIRST, WARPS, SUB0, DOUBLINGS = 4096, 16, 256, 3
LAUNCHES_PER_CALL = 2

_SIGNATURES = {
    'kx_extend': [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_void_p] * 4,
}


def kernel_ranges(limit: int):
    """The ranges [s, e) the kernel summarises apart for a job of `limit`
    positions, round by round: [[(0, min(limit, FIRST))], [WARPS ranges of
    round 0 of launch B], ...]; ranges at or past the limit are left out."""
    rounds = [[(0, min(limit, FIRST))]] if limit > 0 else []
    pos, k = FIRST, 0
    while pos < limit:
        sub = SUB0 << min(k, DOUBLINGS)
        rounds.append([(s, min(s + sub, limit))
                       for s in range(pos, pos + WARPS * sub, sub)
                       if s < limit])
        pos += WARPS * sub
        k += 1
    return rounds


def pad_codes(codes: np.ndarray) -> np.ndarray:
    """Pad a code array with 4s (never matches) so any in-range extension
    slice stays in bounds; shaped (1, L) int32 as in the JAX package."""
    n = len(codes)
    L = ((n + SPAN - 1) // SPAN + 2) * SPAN
    out = np.full(L, 4, dtype=np.int32)
    out[:n] = codes
    return out.reshape(1, L)


def _check_params(aw: int, am: int, ar: int) -> None:
    if not (1 <= aw <= 32 and 1 <= ar <= 32):
        raise ValueError(f'extension needs 1 <= aw <= 32 and 1 <= ar <= 32 '
                         f'(got aw={aw}, ar={ar})')


def extend_plain(q, r, qi, ri, nq: int, nr: int, aw: int, am: int, ar: int,
                 return_scanned: bool = False):
    """Plain torch version of KX on any device. q, r: 1-D int32 padded
    codes; qi, ri: 1-D int32 starts. Returns int32 (total_len, nt_match)
    and, with return_scanned, the int64 count of positions each job had to
    read (up to and including its first violation, within its limit)."""
    n = qi.numel()
    dev = q.device
    qi64, ri64 = qi.long(), ri.long()
    limit = torch.clamp(torch.minimum(nq - qi64, nr - ri64), max=CAP)
    limit = torch.where((qi64 < 0) | (ri64 < 0), 0, limit)
    t = torch.arange(SPAN, device=dev)
    carry_f = torch.zeros((n, aw - 1), dtype=torch.int32, device=dev)
    carry_m = torch.ones((n, ar - 1), dtype=torch.int32, device=dev)
    match_carry = torch.zeros(n, dtype=torch.int64, device=dev)
    best_cut = torch.zeros(n, dtype=torch.int64, device=dev)
    best_match = torch.zeros(n, dtype=torch.int64, device=dev)
    scanned = torch.zeros(n, dtype=torch.int64, device=dev)
    active = limit > 0
    big = torch.tensor(1 << 30, device=dev)
    for off in range(0, CAP, SPAN):
        idx = torch.nonzero(active).reshape(-1)
        if idx.numel() == 0:
            break
        lim = limit[idx]
        pos = off + t
        valid = pos[None, :] < lim[:, None]
        qa = q[torch.clamp(qi64[idx, None] + pos, max=q.numel() - 1)]
        ra = r[torch.clamp(ri64[idx, None] + pos, max=r.numel() - 1)]
        m = (qa == ra) & (qa < 4) & valid
        f = (~m).to(torch.int32)
        # Window mismatch sums over the carry-extended flags.
        g_f = torch.cat([carry_f[idx], f], dim=1)
        cs = torch.nn.functional.pad(torch.cumsum(g_f, dim=1), (1, 0))
        w = cs[:, aw:] - cs[:, :SPAN]
        viol = w > am
        first_v = torch.where(viol.any(dim=1), viol.int().argmax(dim=1), big)
        # Positions ending a run of >= ar matches (history counts as matches).
        g_m = torch.cat([carry_m[idx], m.to(torch.int32)], dim=1)
        cz = torch.nn.functional.pad(torch.cumsum(1 - g_m, dim=1), (1, 0))
        run_ok = (cz[:, ar:] - cz[:, :SPAN]) == 0
        ok = run_ok & (t[None, :] < first_v[:, None]) & valid
        cut_t = (ok * (t + 1)[None, :]).amax(dim=1) - 1
        upto = (m & (t[None, :] <= cut_t[:, None])).sum(dim=1)
        has = cut_t >= 0
        best_cut[idx] = torch.where(has, off + cut_t + 1, best_cut[idx])
        best_match[idx] = torch.where(has, match_carry[idx] + upto,
                                      best_match[idx])
        stopped = first_v < big
        scanned[idx] = torch.where(
            stopped, torch.minimum(off + first_v + 1, lim),
            torch.minimum(torch.full_like(lim, off + SPAN), lim))
        stop_now = stopped | (lim <= off + SPAN)
        match_carry[idx] += m.sum(dim=1)
        carry_f[idx] = g_f[:, g_f.shape[1] - (aw - 1):]
        carry_m[idx] = g_m[:, g_m.shape[1] - (ar - 1):]
        active[idx[stop_now]] = False
    out = best_cut.to(torch.int32), best_match.to(torch.int32)
    return (*out, scanned) if return_scanned else out


def extend_chunked_plain(q, r, qi, ri, nq: int, nr: int, aw: int, am: int,
                         ar: int, chunk: int):
    """Plain model of the kernel's decomposition, for tests: each job's
    positions are cut into ranges of `chunk`, each range is summarised from
    the codes alone (its look-back read from the data, or the history
    before the start: matches) and the summaries are combined in order.
    A summary: the first violation, the last cut candidate before it, the
    matches up to that cut and the range's total matches. The job stops at
    the first range with a violation or holding its limit; its cut is the
    last cut up to there. Equals extend_plain for any chunk >= 1."""
    dev = q.device
    qi64, ri64 = qi.long(), ri.long()
    limit = torch.clamp(torch.minimum(nq - qi64, nr - ri64), max=CAP)
    limit = torch.where((qi64 < 0) | (ri64 < 0), 0, limit)
    back = max(aw, ar) - 1
    per = max(1, 4096 // chunk)           # ranges summarised a pass
    loc = torch.arange(chunk, device=dev)
    j = torch.arange(-back, chunk, device=dev)
    ranges = torch.arange(per, device=dev)
    n = qi.numel()
    best_cut = torch.zeros(n, dtype=torch.int64, device=dev)
    best_match = torch.zeros(n, dtype=torch.int64, device=dev)
    carry = torch.zeros(n, dtype=torch.int64, device=dev)
    active = limit > 0
    for k0 in range(0, -(-CAP // chunk), per):
        idx = torch.nonzero(active).reshape(-1)
        if idx.numel() == 0:
            break
        lim = limit[idx, None, None]
        start = (k0 + ranges) * chunk                       # (per,)
        pos = start[:, None] + j                            # (per, back+chunk)
        qa = q[torch.clamp(qi64[idx, None, None] + pos, 0, q.numel() - 1)]
        ra = r[torch.clamp(ri64[idx, None, None] + pos, 0, r.numel() - 1)]
        m = torch.where(pos < 0, True, (qa == ra) & (qa < 4) & (pos < lim))
        cz = torch.nn.functional.pad(torch.cumsum((~m).int(), -1), (1, 0))
        end = cz[..., back + 1:]
        viol = end - cz[..., back + 1 - aw:cz.shape[-1] - aw] > am
        run = end - cz[..., back + 1 - ar:cz.shape[-1] - ar] == 0
        mm = m[..., back:]                                  # the range's own
        v = torch.where(viol.any(-1), viol.int().argmax(-1), chunk)
        cand = run & (loc < v[..., None])
        cut = (cand * (loc + 1)).amax(-1) - 1               # -1: none
        mcut = (mm & (loc <= cut[..., None])).sum(-1)
        mtot = mm.sum(-1)
        # Combine in order: stop at the first range with a violation or
        # holding the limit; the last cut up to there wins.
        last = (v < chunk) | (start + chunk >= lim[:, :, 0])
        stop = torch.where(last.any(-1), last.int().argmax(-1), per)
        has = (cut >= 0) & (ranges <= stop[:, None])
        kc = ((has * (ranges + 1)).amax(-1) - 1).clamp(min=0)[:, None]
        before = torch.nn.functional.pad(torch.cumsum(mtot, -1), (1, 0))
        any_cut = has.any(-1)
        best_cut[idx] = torch.where(
            any_cut, start[kc[:, 0]] + cut.gather(1, kc)[:, 0] + 1,
            best_cut[idx])
        best_match[idx] = torch.where(
            any_cut, carry[idx] + before.gather(1, kc)[:, 0]
            + mcut.gather(1, kc)[:, 0], best_match[idx])
        carry[idx] += before[:, -1]
        active[idx[stop < per]] = False
    return best_cut.to(torch.int32), best_match.to(torch.int32)


def extend(q, r, qi, ri, nq: int, nr: int, aw: int = 15, am: int = 7,
           ar: int = 3):
    """KX wrapper on tensors: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (or raise): launches A and B, counted 2 in
    `extend.launches`. Returns int32 (total_len, nt_match)."""
    _check_params(aw, am, ar)
    dev = q.device
    for name, x in (('q', q), ('r', r), ('qi', qi), ('ri', ri)):
        cuda.require(x, name, torch.int32, 1, dev)
    if qi.numel() != ri.numel():
        raise ValueError('qi and ri must have the same length')
    if not (0 <= nq <= q.numel() and 0 <= nr <= r.numel()):
        raise ValueError('nq/nr exceed the code arrays')
    if dev.type == 'cpu':
        return extend_plain(q, r, qi, ri, nq, nr, aw, am, ar)
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    n = qi.numel()
    out_len = torch.empty(n, dtype=torch.int32, device=dev)
    out_match = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out_len, out_match
    # Launch A's list of jobs left for B, and two counters.
    scratch = torch.empty(2 * n + 2, dtype=torch.int32, device=dev)
    lib = cuda.library('extend', _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.kx_extend(cuda.ptr(q), cuda.ptr(r), cuda.ptr(qi),
                           cuda.ptr(ri), n, nq, nr, aw, am, ar,
                           cuda.ptr(out_len), cuda.ptr(out_match),
                           cuda.ptr(scratch), cuda.stream(q))
    cuda.check(lib, rc, 'kx_extend')
    extend.launches += LAUNCHES_PER_CALL
    return out_len, out_match


extend.launches = 0


def batched_extend(q2d, r2d, qi, ri, nq: int, nr: int,
                   aw: int = 15, am: int = 7, ar: int = 3, device=None):
    """Run forward extension jobs; returns numpy int32 (total_len,
    nt_match) arrays. q2d/r2d: pad_codes() outputs. qi/ri: int32 job start
    offsets (>= 0). Runs on `device` (default cuda, see utils/device)."""
    dev = resolve_device(device)
    _check_params(aw, am, ar)
    qi = np.ascontiguousarray(qi, dtype=np.int32)
    ri = np.ascontiguousarray(ri, dtype=np.int32)
    if len(qi) == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    if qi.min() < 0 or ri.min() < 0:
        raise ValueError('job starts must be >= 0')

    def put(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int32).reshape(-1)).to(dev)

    lens, matches = extend(put(q2d), put(r2d), put(qi), put(ri), nq, nr,
                           aw, am, ar)
    return lens.cpu().numpy(), matches.cpu().numpy()
