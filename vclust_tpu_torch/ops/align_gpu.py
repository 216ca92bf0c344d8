"""Batched device aligner: the port of the JAX package's ops/align_tpu.py.

The device align engine (`--engine gpu`, the JAX package's `--engine tpu`)
runs two front ends that share one back half, as the JAX package's
`all2all_tpu` and `_all2all_single(..., pipe='v3' | 'v2')` compute them,
bit for bit. The default front end, v3:

1. **Index** (`GenomeIndex.ensure_v3`, `_index_block_v3`, kernel K9 in
   csrc/index.cu): per genome and length bucket, {0,1} occupancies of
   hashed canonical 8-mers over query half-blocks of V3_WQ/2 bases
   (`qocc`) and reference blocks of 32 (`rocc`), and wide window rows of
   both strands (`roww_f`, `roww_r`).
2. **Stage 1** (`_stage1_v3`, kernel K2 in csrc/align_v3.cu): the product
   qocc . rocc^T with a packed max over reference blocks for the half-sum
   and each half, then the dissenting-half rule: two candidate reference
   blocks per query block.
3. **Stages 2-4** (`_bands_v3`, kernel K3): around each candidate, on both
   strands, the match counts of every fine block of 32 query bases at
   BAND diagonal shifts against windows read from the wide rows in place,
   and the election of the best (count, candidate, strand, shift) per fine
   block.
4. **Stages 5-6** (`_propagate_v3`, kernel K5 in csrc/align_v3.cu):
   neighbour propagation read from the band counts, then the final match
   flags from the windows, read from the same rows.
5. **Back half** (`_blocks_to_measures`, kernel K4 in csrc/back_half.cu,
   shared by both front ends): single-switch refinement, breaks,
   anchored-match chaining, segmentation, aggregates and, with_alns, the
   per-segment records.

The v2 front end, for buckets above V3_MAX_BUCKET, for the pairs v3
leaves hard, and with VCLUST_ALIGN_PIPE=v2:

1. **Index** (`GenomeIndex.ensure`, `_index_block`, kernel K10 in
   csrc/index.cu): per genome, the C seeds of each fine block with the
   smallest value hash, and per strand their value-sorted packs (value,
   position) / (value, previous position), plus 64-wide overlapped
   window rows.
2. **Votes and election** (`_votes_elect_v2`, kernel K6 in
   csrc/align_v2.cu, K8 fused in): the plain version's stable sort join
   joins the K queries' seeds with the reference's and a running max
   carries the last two reference occurrences of each value to the query
   seeds (`votes_v2_plain`); then the densest diagonal cluster per fine
   and per coarse block is elected, with the fine override
   (`elect_v2_plain`). The kernel finds the votes by a search of each
   seed's value in the reference's sorted values and elects on them in
   registers: the votes never reach device memory.
3. **Propagation** (`_propagate_v2`, kernel K7) over re-evaluated windows
   (`_eval_on`) and the final flags, then the same back half.

A dispatch is R rows of one reference and K queries each (the JAX
package's vmap over rows is the leading dimension here). Its TPU-only
mechanisms are kept in semantics only: the hierarchical cummax is
`torch.cummax`, the where-tree slices are gathers, the sort join's second
sort is an inverse permutation, and the dispatch size comes from a bound
on live device bytes (`_dispatch_rows`, `_dispatch_rows_v2`).

`_index_block_v3` (K9), `_index_block` (K10), `stage1_pack` (K2),
`_bands_v3` (K3), `_propagate_v3` (K5), `_blocks_to_measures` (K4),
`_votes_elect_v2` (K6, K8 fused in) and `_propagate_v2` (K7) are the
kernel wrappers: CPU tensors take `index_block_v3_plain`,
`index_block_plain`, `stage1_pack_plain`, `bands_v3_plain`,
`propagate_v3_plain`, `blocks_to_measures_plain`,
`votes_elect_v2_plain` and `propagate_v2_plain`, CUDA tensors launch the
kernel or raise. Each
wrapper's `launches` counts its kernel launches. Entry points:
`all2all_gpu` and `_all2all_single`, on `cuda`
unless the caller asks for the CPU (utils/device.py), or over a mesh
(parallel/mesh.py): the dispatches are dealt to the shards in turn, each
runs on its shard's device against a copy of the arena there, and the
results are joined in row order (over the processes too). The JAX
package cuts each dispatch into one slice a shard instead: its sharded
group run is one program across the devices, where here each slice
would be launches of its own, so a cut multiplies the launches that
bound small dispatches by the shard count.
"""

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import cuda
from .lz_parse_py import AlignParams
from ..core.seq import revcomp_codes
from ..parallel.distributed import gather, replicate
from ..parallel.mesh import local_shards, make_mesh
from ..utils.device import resolve_device
from ..utils.logging import get_logger


def _env_num(name, default, lo, hi, cast=int):
    """Tuning-knob parser with validation: malformed or out-of-range
    values raise a clear error at import (the JAX package's names and
    ranges, so a user's settings carry over)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        v = cast(raw)
    except ValueError:
        raise ValueError(f'{name}={raw!r} is not a valid {cast.__name__}')
    if not (lo <= v <= hi):
        raise ValueError(f'{name}={v} out of range [{lo}, {hi}]')
    return v


SEED_K = _env_num('VCLUST_ALIGN_SEEDK', 8, 4, 8)
SEEDS_PER_BLOCK = _env_num('VCLUST_ALIGN_C', 16, 1, 32)
#                     v2 sampling: seeds kept per fine block, on both join
#                     sides, by smallest value hash
CANDS = 2           # v2 candidate reference positions kept per seed
K_QUERIES = 8       # queries sharing one reference per dispatch row
BLOCK = 128         # v2 coarse block width
FINE = 32           # fine block width (rearrangement-boundary resolution)
GAP_DIAG = 16       # v2: max diagonal spread within one vote cluster
SMAX = 15           # v2: cluster-count saturation
MIN_VOTES_F = _env_num('VCLUST_ALIGN_MVF', 2, 1, 64)
#                     v2 votes a fine block needs to elect a diagonal
MIN_VOTES_C = _env_num('VCLUST_ALIGN_MVC', 3, 1, 256)
#                     v2 votes a coarse block needs to elect a diagonal
EXT_ITERS = _env_num('VCLUST_ALIGN_EXTI', 3, 0, 16)
#                     neighbor-diagonal propagation passes
EXT_MIN = _env_num('VCLUST_ALIGN_EXTMIN', 17, 1, 32)
#                     matches (of FINE) a propagated diagonal must reach
EXT_MARGIN = _env_num('VCLUST_ALIGN_EXTMARGIN', 4, 0, 32)
#                     propagated diagonal must beat an elected one by this
MSL = 7             # consecutive matches forming a seed run (chains)
MAL = 11            # consecutive matches able to OPEN a region
AW = 39             # max distance from a seed run for a match to chain
AW_WIN = 15         # approximate-extension window length (density rule)
AM = 7              # max mismatches tolerated inside the window

BIG = 2 ** 30

# Longest genome the device engine indexes (the JAX package's bound, from
# its v2 seed pack); pairs touching a longer genome raise.
MAX_TPU_LEN = 1 << 20

_BUCKETS = sorted({4096 << i for i in range(8)}
                  | {6144 << i for i in range(8)})

V3_H = _env_num('VCLUST_ALIGN_V3_H', 2048, 256, 16384)
#                    hashed canonical-seed buckets of the occupancies
V3_WQ = _env_num('VCLUST_ALIGN_V3_WQ', 128, 64, 512)
#                    stage-1 query block width (multiple of 32)
V3_SMIN = _env_num('VCLUST_ALIGN_V3_SMIN', 5, 1, 512)
#                    stage-1 shared-seed count a coarse candidate needs
V3_TBAND = _env_num('VCLUST_ALIGN_V3_TBAND', 17, 1, 32)
#                    base matches (of FINE) the band winner needs to elect
V3_MAX_BUCKET = _env_num('VCLUST_ALIGN_V3_MAXB', 131072, 4096, 1 << 20)
#                    largest bucket of the v3 pipe (larger ones run on v2)
V3_CONT = _env_num('VCLUST_ALIGN_V3_CONT', 6, 0, 32)
#                    continuity slack of neighbour adoption
V3_RERUN_COV = _env_num('VCLUST_ALIGN_V3_COV', 0.997, 0.0, 1.0, cast=float)
#                    hybrid: pairs v3 leaves with query or reference
#                    coverage below this (at tANI > 0.05) re-align on v2
#                    at full density; 0 disables
MAX_ARENA = _env_num('VCLUST_ALIGN_MAX_ARENA', 0, 0, 1 << 30)
#                    bound on genomes resident per bucket arena (0 = none);
#                    larger groups split over disposable sub-arenas
# The v2 two-phase screen (VCLUST_ALIGN_PIPE=v2): every pair from the
# bucket TWO_PHASE_MIN_BUCKET up first at PHASE1_C seeds a block, then
# those with RERUN_LO < tANI < RERUN_HI again at SEEDS_PER_BLOCK.
PHASE1_C = _env_num('VCLUST_ALIGN_P1C', 8, 1, 32)
RERUN_LO = _env_num('VCLUST_ALIGN_RERUN_LO', 0.10, 0.0, 1.0, cast=float)
RERUN_HI = _env_num('VCLUST_ALIGN_RERUN_HI', 0.97, 0.0, 1.0, cast=float)
TWO_PHASE_MIN_BUCKET = _env_num('VCLUST_ALIGN_TP_MIN', 16384, 0, 1 << 30)

# The packed maxes: stage 1 packs (count << 13) | reference block, the
# band election (count << 12) | 2048 (candidate 1) | 1024 (forward) | shift.
_RB_BITS = 13
_T_BITS = 9
# Election tags of the four bands, in the order of `_bands_v3`: candidate
# 1 forward, candidate 1 reverse, candidate 2 forward, candidate 2 reverse.
BAND_TAGS = (3072, 2048, 1024, 0)
_BAND_IS_RC = (False, True, False, True)

# Live device bytes one dispatch may hold (`_dispatch_rows`). On an H100
# the 48-genome corpus aligns 2.26x the pairs/s of 0.5 GiB at 2 GiB, and
# 8 GiB adds 19% more (tools/v3_dispatch_probe.py).
_LIVE_BYTES = 2 << 30
# Bytes a query position of a row holds live in stages 5-6 and the back
# half, without and with records (the int64 sort of the keys): the peak
# of one dispatch at bucket 65,536 less the bands' windows and counts was
# 91.6 and 143.8 bytes a position on an H100 (tools/v3_dispatch_probe.py),
# measured while both stages ran as torch ops; kernels K5 and K4 hold
# less, so these bounds now leave room.
_BYTES_PER_POS = 92
_BYTES_PER_POS_RECORDS = 144
# The v2 pipe's peak live bytes a query position of a row, without and
# with records: 88.2-89.7 and 153.4-154.4 on an H100 at buckets 65,536
# and 262,144, the same at C = 8 and 16 (the sort join and the election
# peak below the flags and the back half; chip_smoke.py phases
# align_hybrid and align_v2, one dispatch at 1 and 2 rows).
_V2_BYTES_PER_POS = 90
_V2_BYTES_PER_POS_RECORDS = 155


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


def index_v3_empty(G: int, Lp: int, device) -> tuple:
    """Uninitialised v3 arena arrays of G genomes at bucket Lp, in the
    order of _V3_KEYS."""
    g3 = _v3_geom(Lp, Lp)
    NRB = g3['NRB']
    return tuple(torch.empty(shape, dtype=torch.int8, device=device)
                 for shape in ((G, 2 * g3['NQB'], V3_H), (G, NRB, V3_H),
                               (G, NRB, g3['ROWW']), (G, NRB, g3['ROWW'])))


def index_v2_empty(G: int, Lp: int, pack_bits: int, C: int,
                   device) -> tuple:
    """Uninitialised v2 arena arrays of G genomes at bucket Lp, in the
    order of _V2_KEYS; with 64-bit packs pk2 is pk1 (one tensor), as
    index_block_plain returns them. The arrays of one dtype share one
    allocation, each 16-byte aligned (three allocations and a few views,
    not nine allocations: K10's wrapper's host time is of the order of
    its kernels')."""
    NQ = Lp // FINE * C

    def new(dtype, n):
        if G * NQ % 4 == 0:
            return torch.empty((n, G, NQ), dtype=dtype,
                               device=device).unbind(0)
        S = -(-G * NQ // 4) * 4     # each array 16-byte aligned
        flat = torch.empty((n, S), dtype=dtype, device=device)
        return flat[:, :G * NQ].unflatten(1, (G, NQ)).unbind(0)

    qsv, qoff, sv_f, sv_r = new(torch.int32, 4)
    packs = new(torch.int64, 2 if pack_bits == 64 else 4)
    pk1_f, pk1_r = packs[:2]
    pk2_f, pk2_r = (pk1_f, pk1_r) if pack_bits == 64 else packs[2:]
    r2dov = torch.empty((G, 2 * (Lp // FINE + 1), 2 * FINE),
                        dtype=torch.int8, device=device)
    return qsv, qoff, sv_f, pk1_f, pk2_f, sv_r, pk1_r, pk2_r, r2dov


def _index_codes(fwd, rc, what):
    """The codes both index builds take, checked for their kernels:
    (G, Lp) int8 on one card, contiguous, 16-byte aligned. Returns (G,
    Lp)."""
    dev = fwd.device
    cuda.require(fwd, 'fwd', torch.int8, 2, dev)
    _check(rc, 'rc', torch.int8, tuple(fwd.shape), dev)
    if fwd.data_ptr() % 16 or rc.data_ptr() % 16:
        raise ValueError(f'{what} reads the codes 16 bytes at a time: fwd '
                         f'and rc must be 16-byte aligned')
    return tuple(fwd.shape)


def _index_out(out, empty, dev, what):
    """The arrays a kernel writes: empty(dev), or `out` checked against
    empty('meta') (dtype, shape, contiguity, on dev, 16-byte aligned)."""
    if out is None:
        return empty(dev)
    want = empty('meta')
    if len(out) != len(want):
        raise ValueError(f'{what}: out must hold {len(want)} arrays')
    for i, (o, w) in enumerate(zip(out, want)):
        _check(o, f'out[{i}]', w.dtype, tuple(w.shape), dev)
        if o.data_ptr() % 16:
            raise ValueError(f'{what} writes 16 bytes at a time: out[{i}] '
                             f'must be 16-byte aligned')
    return tuple(out)


def _into(res, out):
    """The plain version's arrays, copied into `out` where one is given."""
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return tuple(out)


def _index_block_v3(fwd, rc, k: int, Lp: int, out=None):
    """K9 wrapper (see index_block_v3_plain): the plain version for CPU
    tensors, the CUDA kernel (csrc/index.cu) for CUDA tensors (or raise).
    With `out` (arrays as index_v3_empty gives them, or slices of them)
    the arena is written there and `out` returned. The kernel takes codes
    0-4, k 1-8, V3_H a multiple of 16 (it writes the rows 16 bytes at a
    time from a row of H bytes a warp in shared memory) and the geometry
    of `_v3_geom` (1-13 fine blocks a coarse block)."""
    dev = fwd.device
    if dev.type == 'cpu':
        return _into(index_block_v3_plain(fwd, rc, k, Lp), out)
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    G, L = _index_codes(fwd, rc, 'K9')
    g3 = _v3_geom(Lp, Lp)
    if L != Lp or not 1 <= k <= 8:
        raise ValueError(f'K9 takes (G, {Lp}) codes and k 1-8; got {L}, '
                         f'k={k}')
    if V3_H % 16:
        raise ValueError(f'K9 takes V3_H a multiple of 16; got {V3_H}')
    out = _index_out(out, lambda d: index_v3_empty(G, Lp, d), dev, 'K9')
    if G:
        lib = cuda.library('index', cuda.INDEX_SIGNATURES)
        with torch.cuda.device(dev):
            rc_ = lib.k9_index_v3(
                cuda.ptr(fwd), cuda.ptr(rc), G, Lp, k, SEED_K, V3_H,
                32 - int(np.log2(V3_H)), g3['WQ'], g3['ROWW'],
                *(cuda.ptr(t) for t in out), cuda.stream(fwd))
        cuda.check(lib, rc_, 'k9_index_v3')
        _index_block_v3.launches += 1
    return out


_index_block_v3.launches = 0


def _index_block(fwd, rc, k: int, pack_bits: int, C: int, out=None):
    """K10 wrapper (see index_block_plain): the plain version for CPU
    tensors, the CUDA kernel (csrc/index.cu) for CUDA tensors (or raise).
    With `out` (arrays as index_v2_empty gives them, or slices of them)
    the arena is written there and `out` returned. The kernel takes codes
    0-4, k 1-8, C 1-32, packs of 32 or 64 bits and buckets that are
    multiples of 32 up to 2^20. It sorts the chunk's (genome, strand) rows
    a group of k10_group_rows(G, Lp, C) at a time (at most 128 MiB of
    items) through two buffers kept per device and stream: the state
    (`_K10_STATE`: the digit totals, the counts and the look-back words,
    which an epoch tells apart from an earlier launch's; zeroed once) and
    the items (`_K10_ITEMS`, the largest group's need so far)."""
    dev = fwd.device
    if dev.type == 'cpu':
        return _into(index_block_plain(fwd, rc, k, pack_bits, C), out)
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    G, Lp = _index_codes(fwd, rc, 'K10')
    if not (1 <= k <= 8 and 1 <= C <= 32 and pack_bits in (32, 64)
            and Lp % FINE == 0 and 0 < Lp <= MAX_TPU_LEN):
        raise ValueError(f'K10 takes k 1-8, C 1-32, packs of 32 or 64 bits '
                         f'and buckets that are multiples of {FINE} up to '
                         f'{MAX_TPU_LEN}; got k={k}, C={C}, '
                         f'pack_bits={pack_bits}, Lp={Lp}')
    out = _index_out(out, lambda d: index_v2_empty(G, Lp, pack_bits, C, d),
                     dev, 'K10')
    if G:
        lib = cuda.library('index', cuda.INDEX_SIGNATURES)
        with torch.cuda.device(dev):
            key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
            state = _stream_scratch(_K10_STATE, key, dev,
                                    -(-lib.k10_state_bytes(G, Lp, C) // 4))
            items = _stream_scratch(_K10_ITEMS, key, dev,
                                    -(-lib.k10_items_bytes(G, Lp, C) // 4),
                                    zeroed=False)
            rc_ = lib.k10_index_v2(
                cuda.ptr(fwd), cuda.ptr(rc), G, Lp, k, C, pack_bits,
                *(cuda.ptr(t) for t in out), cuda.ptr(state),
                4 * state.numel(), cuda.ptr(items), 4 * items.numel(),
                cuda.stream(fwd))
        cuda.check(lib, rc_, 'k10_index_v2')
        _index_block.launches += 1
    return out


_index_block.launches = 0
# K10's state and items, an int32 buffer each a (device, stream)
# (`_stream_scratch`). The items buffer stays for the process's life, up to
# 128 MiB a stream, outside `_dispatch_rows`' budget (ROADMAP P6).
_K10_STATE, _K10_ITEMS = {}, {}


# Genomes indexed at once (bounds the index build's temporaries).
_INDEX_ROWS_CHUNK = 512
_V2_KEYS = ('qsv', 'qoff', 'sv_f', 'pk1_f', 'pk2_f', 'sv_r', 'pk1_r', 'pk2_r',
            'r2dov')
_V3_KEYS = ('qocc', 'rocc', 'roww_f', 'roww_r')


class GenomeIndex:
    """Device-resident per-bucket genome arena: padded codes, and per
    bucket the v3 arrays (canonical occupancies and wide window rows, K9)
    or the v2 arrays at C seeds a block (sampled seeds, value-sorted packs
    and window rows, K10). Buckets build lazily, at exactly the bucket
    sizes the pairs need, and each (bucket, genome set) build is cached on
    the index. `prep_s` counts the host's seconds of the builds' padding,
    reverse complements and uploads."""

    def __init__(self, codes_list: Sequence[np.ndarray], device=None):
        self.device = resolve_device(device)
        self.codes = [np.asarray(c, dtype=np.int8) for c in codes_list]
        self.lens = np.array([len(c) for c in self.codes], dtype=np.int32)
        self.bucket = {}   # (Lp, 'v3' or C) -> dict of arrays + row map
        self.prep_s = 0.0
        # Genomes beyond the engine's position range are not indexed;
        # pairs touching them raise.
        self.oversized = {i for i, c in enumerate(self.codes)
                          if len(c) > MAX_TPU_LEN}

    def _build(self, key, gids, cache, names, index_fn, empty_fn) -> dict:
        """The arrays `names` for bucket key[0] covering at least genomes
        `gids` (cached under `key`): allocated once by empty_fn(G, device)
        and written by index_fn(fwd, rc, out) a chunk of genomes at a time
        into its slices. cache=False builds a disposable exact-member
        sub-arena (the MAX_ARENA path) that is neither stored nor
        merged."""
        Lp = key[0]
        cur = self.bucket.get(key) if cache else None
        need = set(int(g) for g in gids)
        if cur is not None and need <= cur['rows'].keys():
            return cur
        members = sorted(need | (set(cur['rows']) if cur else set()))
        G = len(members)
        t0 = time.perf_counter()
        fwd = np.full((G, Lp), 4, dtype=np.int8)
        rc = np.full((G, Lp), 4, dtype=np.int8)
        rows = {}
        for row, i in enumerate(members):
            fwd[row, :self.lens[i]] = self.codes[i]
            rc[row, :self.lens[i]] = revcomp_codes(self.codes[i])
            rows[i] = row
        fwd_d = torch.from_numpy(fwd).to(self.device)
        rc_d = torch.from_numpy(rc).to(self.device)
        self.prep_s += time.perf_counter() - t0
        arena = empty_fn(G, self.device)
        ch = _INDEX_ROWS_CHUNK
        for lo in range(0, G, ch):
            index_fn(fwd_d[lo:lo + ch], rc_d[lo:lo + ch],
                     tuple(x[lo:lo + ch] for x in arena))
        d = dict(zip(names, arena))
        d.update(fwd=fwd_d, rows=rows)
        if cache:
            self.bucket[key] = d
        return d

    def ensure_v3(self, Lp: int, gids, cache: bool = True) -> dict:
        """v3 arrays for bucket Lp covering at least genomes `gids`."""
        return self._build(
            (Lp, 'v3'), gids, cache, _V3_KEYS,
            lambda f, r, out: _index_block_v3(f, r, SEED_K, Lp, out=out),
            lambda G, dev: index_v3_empty(G, Lp, dev))

    def ensure(self, Lp: int, gids, C: Optional[int] = None,
               cache: bool = True) -> dict:
        """v2 arrays for bucket Lp covering at least genomes `gids`,
        sampled at C seeds per fine block (default SEEDS_PER_BLOCK)."""
        C = SEEDS_PER_BLOCK if C is None else C
        pack_bits = _pack_bits(Lp)
        d = self._build(
            (Lp, C), gids, cache, _V2_KEYS,
            lambda f, r, out: _index_block(f, r, SEED_K, pack_bits, C,
                                           out=out),
            lambda G, dev: index_v2_empty(G, Lp, pack_bits, C, dev))
        d['pack_bits'] = pack_bits
        return d


def index_v3_from_numpy(d: dict, device=None) -> dict:
    """The port's v3 bucket dict from the arrays of a JAX-package
    `ensure_v3` dict (each converted with np.asarray): the same arena,
    row for row, on `device` (default cuda, see utils/device)."""
    dev = resolve_device(device)
    out = {k: torch.from_numpy(np.array(d[k], dtype=np.int8)).to(dev)
           for k in ('fwd',) + _V3_KEYS}
    out['rows'] = {int(g): int(r) for g, r in d['rows'].items()}
    return out


def index_v2_from_numpy(d: dict, device=None) -> dict:
    """The port's v2 bucket dict from the arrays of a JAX-package `ensure`
    dict or `_index_block` output (each converted with np.asarray; the
    uint32 packs widen to int64), with 'pack_bits' and 'rows'."""
    dev = resolve_device(device)
    out = {}
    for k in ('fwd',) + _V2_KEYS:
        a = np.asarray(d[k])
        dt = (np.int8 if k in ('fwd', 'r2dov') else
              np.int64 if k.startswith('pk') else np.int32)
        out[k] = torch.from_numpy(a.astype(dt)).to(dev)
    out['pack_bits'] = int(d['pack_bits'])
    out['rows'] = {int(g): int(r) for g, r in d['rows'].items()}
    return out


# --------------------------------------------------------------------------
# elementwise helpers (static shifts / dilations along the last axis)
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# the shared back half
# --------------------------------------------------------------------------

def _maxseg(Lq: int, reg: int) -> int:
    """Records kept per directed pair (the JAX package's MAXSEG)."""
    return min(Lq // max(reg, 16) + 8, 2048)


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


def _blocks_to_measures(m1, m0, switchable, A, S, D, Ap, Sp, Dp, rlen,
                        *, Lq, mqd, mrd, reg, with_alns=False,
                        debug=False, debug_extra=None):
    """K4 wrapper (see blocks_to_measures_plain for the arguments and
    results): the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (or raise). debug asks for intermediates that only the plain
    version forms, so it runs the plain version on any device. On the card
    the flag arrays must be 16-byte aligned (the kernel reads them 16 bytes
    at a time); the kernel's chunks pass their carries through a scratch
    buffer kept per device and stream (`_k4_scratch`)."""
    dev = m1.device
    if debug or dev.type == 'cpu':
        return blocks_to_measures_plain(
            m1, m0, switchable, A, S, D, Ap, Sp, Dp, rlen, Lq=Lq, mqd=mqd,
            mrd=mrd, reg=reg, with_alns=with_alns, debug=debug,
            debug_extra=debug_extra)
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    N = m1.shape[0]
    NBF = Lq // FINE
    if Lq % FINE or not NBF:
        raise ValueError(f'back half: Lq={Lq} is not a positive multiple of '
                         f'{FINE}')
    if Lq > MAX_TPU_LEN:
        raise ValueError(f'K4 takes at most {MAX_TPU_LEN} positions a pair; '
                         f'got {Lq}')
    for name, t in (('m1', m1), ('m0', m0)):
        cuda.require(t, name, torch.bool, 2, dev)
        if t.shape != (N, Lq):
            raise ValueError(f'back half: {name} must be ({N}, {Lq})')
        if t.data_ptr() % 16:
            raise ValueError(f'K4 reads {name} 16 bytes at a time: its data '
                             f'must be 16-byte aligned')
    for name, t, dt in (('switchable', switchable, torch.bool),
                        ('A', A, torch.bool), ('S', S, torch.bool),
                        ('D', D, torch.int32), ('Ap', Ap, torch.bool),
                        ('Sp', Sp, torch.bool), ('Dp', Dp, torch.int32)):
        cuda.require(t, name, dt, 2, dev)
        if t.shape != (N, NBF):
            raise ValueError(f'back half: {name} must be ({N}, {NBF})')
    # The row cores broadcast rlen with expand, which leaves one row's
    # reference length at stride 0.
    rlen = rlen.contiguous()
    cuda.require(rlen, 'rlen', torch.int32, 1, dev)
    if rlen.shape != (N,):
        raise ValueError(f'back half: rlen must be ({N},)')
    agg = torch.empty((N, 3), dtype=torch.int32, device=dev)
    nrec = torch.empty(N, dtype=torch.int32, device=dev)
    # Records past the cap are dropped, as the plain version's sorted
    # prefix keeps at most Lq; the kernel sets the rows past a pair's last
    # record to -1.
    width = min(_maxseg(Lq, reg), Lq)
    recs = (torch.empty((N, width, 6), dtype=torch.int32, device=dev)
            if with_alns else None)
    if N:
        lib = cuda.library('back_half', cuda.BACK_HALF_SIGNATURES)
        scratch = _k4_scratch(lib, dev, N, Lq)
        # Values past these limits act as the limits do: mqd >= Lq reaches
        # back past position 0 (and a negative one acts as 0, the plain
        # dilation's), no |D - Dp| reaches 2^30 and no segment Lq + 1.
        with torch.cuda.device(dev):
            rc = lib.k4_back_half(
                *(cuda.ptr(t) for t in (m1, m0, switchable, A, S, D, Ap, Sp,
                                        Dp, rlen)),
                N, Lq, min(max(mqd, 0), Lq), min(mrd, 1 << 30),
                max(min(reg, Lq + 1), 0), width, cuda.ptr(agg),
                cuda.ptr(recs) if with_alns else None, cuda.ptr(nrec),
                cuda.ptr(scratch), scratch.numel(), cuda.stream(m1))
        cuda.check(lib, rc, 'k4_back_half')
        _blocks_to_measures.launches += 1
    if not with_alns:
        return agg
    return agg, recs, nrec


_blocks_to_measures.launches = 0
# K4's look-back state, one int32 buffer a (device, stream): its launches
# on one stream run in order, so they can share it.
_K4_SCRATCH = {}


def _k4_scratch(lib, dev, N, Lq):
    """K4's scratch buffer for N pairs of Lq positions on the current
    stream of `dev` (`_stream_scratch`)."""
    need = lib.k4_scratch_ints(N, Lq)
    if need < 0:
        raise ValueError(f'back half: {N} pairs of {Lq} positions are more '
                         f'chunks than one launch takes')
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    return _stream_scratch(_K4_SCRATCH, key, dev, need)


def _stream_scratch(cache, key, dev, ints, zeroed=True):
    """A kernel's int32 scratch of at least `ints` words on `dev`, kept in
    `cache` under key (device index, stream). `zeroed`: zeroed when made
    and grown to twice the need when too small (the kernel leaves it ready
    for its next launch); else uninitialised, made anew at the need."""
    buf = cache.get(key)
    if buf is None or buf.numel() < ints:
        cache[key] = buf = None         # the old buffer goes first
        buf = (torch.zeros(min(2 * ints, 2 ** 31 - 1), dtype=torch.int32,
                           device=dev) if zeroed else
               torch.empty(ints, dtype=torch.int32, device=dev))
        cache[key] = buf
    return buf


# --------------------------------------------------------------------------
# K2: stage 1
# --------------------------------------------------------------------------

_STAGE1_CHUNK = 512   # reference blocks per product of the plain version


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


def stage1_pack(qocc, rocc, r_rows, q_rows):
    """K2 wrapper (see stage1_pack_plain for the arguments): the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors (or raise).
    Arena rows must be in range. The kernel reads the arenas with TMA, so
    on the card they must be contiguous and 16-byte aligned, with H a
    multiple of 16, and the query arena in groups of 8 query blocks, so
    2*NQB must be a multiple of 16 (it is at every bucket and V3_WQ)."""
    dev = qocc.device
    cuda.require(qocc, 'qocc', torch.int8, 3, dev)
    cuda.require(rocc, 'rocc', torch.int8, 3, dev)
    cuda.require(r_rows, 'r_rows', torch.int32, 1, dev)
    cuda.require(q_rows, 'q_rows', torch.int32, 2, dev)
    R, K = q_rows.shape
    M2, H = qocc.shape[1:]
    NRB = rocc.shape[1]
    if r_rows.shape[0] != R or rocc.shape[2] != H or M2 % 2:
        raise ValueError('stage 1: qocc (G, 2*NQB, H), rocc (G, NRB, H), '
                         'r_rows (R,) and q_rows (R, K) do not fit')
    if NRB > 1 << _RB_BITS:
        raise ValueError(f'stage 1 packs the reference block in 13 bits; '
                         f'{NRB} blocks')
    if dev.type == 'cpu':
        return stage1_pack_plain(qocc, rocc, r_rows, q_rows)
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    if H % 16 or M2 % 16:
        raise ValueError(f'K2 needs H and 2*NQB multiples of 16 (got {H} '
                         f'and {M2})')
    for name, t in (('qocc', qocc), ('rocc', rocc)):
        if t.data_ptr() % 16:
            raise ValueError(f'K2 reads {name} with TMA: its data must be '
                             f'16-byte aligned')
    outs = torch.zeros((3, R, K, M2 // 2), dtype=torch.int32, device=dev)
    if R * K and M2 and NRB:
        lib = cuda.library('align_v3', cuda.ALIGN_V3_SIGNATURES)
        with torch.cuda.device(dev):
            rc = lib.k2_stage1(cuda.ptr(qocc), cuda.ptr(rocc),
                               cuda.ptr(r_rows), cuda.ptr(q_rows), R * K, K,
                               qocc.shape[0], rocc.shape[0], M2, NRB, H,
                               cuda.ptr(outs[0]), cuda.ptr(outs[1]),
                               cuda.ptr(outs[2]), cuda.stream(qocc))
        cuda.check(lib, rc, 'k2_stage1')
        stage1_pack.launches += 1
    return outs[0], outs[1], outs[2]


stage1_pack.launches = 0


def _stage1_v3(qocc, rocc, r_rows, q_rows):
    """Stage 1: (cnt1, g1, cnt2, g2), each (R, K, NQB) int32. Candidate 1
    is the argmax of the half-sum; candidate 2 the argmax of whichever
    half disagrees more with it (the positional mosaic rescue)."""
    p_sum, p_a, p_b = stage1_pack(qocc, rocc, r_rows, q_rows)
    mask = (1 << _RB_BITS) - 1
    cnt1 = p_sum >> _RB_BITS
    g1 = p_sum & mask
    ga, gb = p_a & mask, p_b & mask
    use_a = (ga - g1).abs() >= (gb - g1).abs()
    g2 = torch.where(use_a, ga, gb)
    cnt2 = torch.where(use_a, p_a, p_b) >> _RB_BITS   # half-block count
    return cnt1, g1, cnt2, g2


# --------------------------------------------------------------------------
# K3: stages 2-4, the windows, band counts and election
# --------------------------------------------------------------------------

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


def _check_rows(b, r_rows, rlens, q_rows, per_block, g3, what):
    """The arguments K3 and K5 read in place, checked: the wide rows
    roww_f, roww_r (Gr, NRB, ROWW) int8 with ROWW a multiple of 32 that
    holds every window of a coarse block (WQ - 16 + WIN bytes), the query
    codes fwd (Gq, NBF * FINE) int8, r_rows and rlens (R,) and q_rows (R,
    K) int32, and per_block's (name, tensor) (R, K, NQB) int32. Returns
    (R, K, NQB, NBF)."""
    dev = r_rows.device
    cuda.require(q_rows, 'q_rows', torch.int32, 2, dev)
    R, K = q_rows.shape
    _check(r_rows, 'r_rows', torch.int32, (R,), dev)
    _check(rlens, 'rlens', torch.int32, (R,), dev)
    NQB = per_block[0][1].shape[-1]
    for name, t in per_block:
        _check(t, name, torch.int32, (R, K, NQB), dev)
    WQ, WIN, FPB = g3['WQ'], g3['WIN'], g3['FPB']
    NRB, ROWW = g3['NRB'], g3['ROWW']
    if WQ != FINE * FPB or ROWW % 32 or ROWW < WQ - 16 + WIN:
        raise ValueError(f'{what}: geometry {g3} puts a window outside its '
                         f'row')
    Gr = b['roww_f'].shape[0]
    for name in ('roww_f', 'roww_r'):
        _check(b[name], name, torch.int8, (Gr, NRB, ROWW), dev)
    NBF = NQB * FPB
    _check(b['fwd'], 'fwd', torch.int8, (b['fwd'].shape[0], NBF * FINE), dev)
    return R, K, NQB, NBF


def _bands_v3(b, r_rows, rlens, q_rows, cnt1, g1, cnt2, g2, tband, smin,
              g3):
    """K3 wrapper (see bands_v3_plain): the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (or raise). The kernel reads the wide
    rows (roww_f, roww_r) and the query codes (fwd) in place, so no window
    tensor exists on the card; it takes the geometry of `_v3_geom` with 2-13
    fine blocks a coarse block (V3_WQ 64-416), codes 0-4 (it counts a base
    only in 0-3, which equals the plain compare on such codes; the rows'
    pads are 4) and g1, g2 in [0, NRB), as stage 1 gives them."""
    dev = g1.device
    if dev.type == 'cpu':
        return bands_v3_plain(b, r_rows, rlens, q_rows, cnt1, g1, cnt2, g2,
                              tband, smin, g3)
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    R, K, NQB, NBF = _check_rows(b, r_rows, rlens, q_rows, (
        ('cnt1', cnt1), ('g1', g1), ('cnt2', cnt2), ('g2', g2)), g3, 'K3')
    FPB, BAND = g3['FPB'], g3['BAND']
    if not 2 <= FPB <= 13 or BAND != g3['WQ'] + 96 \
            or g3['ROWW'] != FINE * (2 * FPB + 4):
        raise ValueError(f'K3 takes the geometry of V3_WQ 64-416; got {g3}')
    cnt = torch.empty((len(BAND_TAGS), R, K, NBF, BAND), dtype=torch.int8,
                      device=dev)
    cnt_best, D = (torch.empty((R, K, NBF), dtype=torch.int32, device=dev)
                   for _ in range(2))
    A, S = (torch.empty((R, K, NBF), dtype=torch.bool, device=dev)
            for _ in range(2))
    if R and K:
        lib = cuda.library('align_v3', cuda.ALIGN_V3_SIGNATURES)
        with torch.cuda.device(dev):
            rc = lib.k3_row_bands(
                *(cuda.ptr(t) for t in (b['roww_f'], b['roww_r'], b['fwd'],
                                        r_rows, rlens, q_rows, cnt1, g1,
                                        cnt2, g2)),
                R * K, K, NQB, g3['NRB'], FPB, tband, smin,
                max(smin // 2, 3),
                *(cuda.ptr(t) for t in (cnt, cnt_best, A, S, D)),
                cuda.stream(g1))
        cuda.check(lib, rc, 'k3_row_bands')
        _bands_v3.launches += 1
    return dict(cnt=cnt, cnt_best=cnt_best, A=A, S=S, D=D)


_bands_v3.launches = 0


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


def _propagate_v3(el, b, r_rows, rlens, q_rows, g1, g2, g3):
    """K5 wrapper (see propagate_v3_plain): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (or raise). The kernel reads
    its flag windows from the wide rows and the query bases from fwd in
    place, as K3 does, and words of both, so roww_f, roww_r and fwd must
    be 4-byte aligned (a sliced or offset arena may not be: it raises).
    It takes EXT_ITERS (0-16), EXT_MIN (>= 1), EXT_MARGIN (>= 0) and
    V3_CONT as arguments, at most 2^13 blocks a pair (the stage-1 pack's
    bound, `_v3_geom`) and BAND a multiple of 4 (as `_v3_geom` makes
    it)."""
    A = el['A']
    dev = A.device
    if dev.type == 'cpu':
        return propagate_v3_plain(el, b, r_rows, rlens, q_rows, g1, g2, g3)
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    R, K, NQB, NBF = _check_rows(b, r_rows, rlens, q_rows,
                                 (('g1', g1), ('g2', g2)), g3, 'K5')
    BAND = g3['BAND']
    nb = len(BAND_TAGS)
    for name, dt, shape in (
            ('cnt', torch.int8, (nb, R, K, NBF, BAND)),
            ('A', torch.bool, (R, K, NBF)), ('S', torch.bool, (R, K, NBF)),
            ('D', torch.int32, (R, K, NBF)),
            ('cnt_best', torch.int32, (R, K, NBF))):
        _check(el[name], name, dt, shape, dev)
    if NBF > 1 << _RB_BITS:
        raise ValueError(f'K5 holds at most {1 << _RB_BITS} blocks a pair; '
                         f'got {NBF}')
    if not (0 <= EXT_ITERS <= 16 and EXT_MIN >= 1 and EXT_MARGIN >= 0):
        raise ValueError('K5 takes EXT_ITERS 0-16, EXT_MIN >= 1 and '
                         'EXT_MARGIN >= 0')
    if BAND % 4 or any(b[k].data_ptr() % 4 for k in ('roww_f', 'roww_r',
                                                     'fwd')):
        raise ValueError('K5 reads the rows and query codes as words: BAND '
                         'must be a multiple of 4 and roww_f, roww_r and fwd '
                         '4-byte aligned')
    m1, m0 = (torch.empty((R, K, NBF * FINE), dtype=torch.bool, device=dev)
              for _ in range(2))
    sw, A1, S1, Ap, Sp = (torch.empty((R, K, NBF), dtype=torch.bool,
                                      device=dev) for _ in range(5))
    D1, Dp = (torch.empty((R, K, NBF), dtype=torch.int32, device=dev)
              for _ in range(2))
    if R and K and NBF:
        lib = cuda.library('align_v3', cuda.ALIGN_V3_SIGNATURES)
        with torch.cuda.device(dev):
            rc = lib.k5_propagate(
                *(cuda.ptr(el[k]) for k in ('cnt', 'A', 'S', 'D',
                                            'cnt_best')),
                *(cuda.ptr(t) for t in (b['roww_f'], b['roww_r'], b['fwd'],
                                        r_rows, rlens, q_rows, g1, g2)),
                R * K, K, NBF, g3['FPB'], g3['NRB'], g3['ROWW'], BAND,
                EXT_ITERS, EXT_MIN, EXT_MARGIN, V3_CONT,
                *(cuda.ptr(t) for t in (m1, m0, sw, A1, S1, D1, Ap, Sp, Dp)),
                cuda.stream(A))
        cuda.check(lib, rc, 'k5_propagate')
        _propagate_v3.launches += 1
    return m1, m0, sw, A1, S1, D1, Ap, Sp, Dp


_propagate_v3.launches = 0


def _row_core_v3(b, r_rows, rlens, q_rows, tband, smin,
                 *, Lq, Lr, K, mqd, mrd, reg, with_alns=False, debug=False):
    """v3 aggregates for R dispatch rows of K directed pairs sharing one
    reference each.

    b: a bucket dict (GenomeIndex.ensure_v3 or index_v3_from_numpy);
    r_rows: (R,) int32 arena rows of the references, rlens: (R,) int32
    their lengths; q_rows: (R, K) int32 arena rows of the queries;
    tband/smin: the election thresholds (ints). Returns (R, K, 3) int32
    aggregates; with_alns also (R, K, MAXSEG, 6) records and (R, K)
    record counts before the cap; with debug the intermediates of the JAX
    package's debug dict, each with a leading R axis."""
    g3 = _v3_geom(Lq, Lr)
    R = r_rows.shape[0]
    if q_rows.shape != (R, K):
        raise ValueError(f'q_rows must be ({R}, {K})')
    cnt1, g1, cnt2, g2 = _stage1_v3(b['qocc'], b['rocc'], r_rows, q_rows)
    args = (b, r_rows, rlens, q_rows)
    if r_rows.device.type == 'cpu':
        # The plain versions of K3 and K5 share one build of the windows.
        wb = _band_windows(b, r_rows, rlens, g1, g2, g3)
        el = bands_v3_plain(*args, cnt1, g1, cnt2, g2, tband, smin, g3,
                            windows=wb)
        props = propagate_v3_plain(el, *args, g1, g2, g3, windows=wb)
        del wb
    else:
        el = _bands_v3(*args, cnt1, g1, cnt2, g2, tband, smin, g3)
        props = _propagate_v3(el, *args, g1, g2, g3)
    m1, m0, switchable, A, S, D, Ap, Sp, Dp = props
    N = R * K

    def flat(x):
        return x.reshape((N,) + x.shape[2:])

    rlen = rlens[:, None].expand(R, K).reshape(N)
    extra = None
    if debug:
        extra = dict(cnt1=flat(cnt1), g1=flat(g1), cnt2=flat(cnt2),
                     g2=flat(g2), cnt_best=flat(el['cnt_best']),
                     band_best=[flat(c.amax(dim=-1)) for c in el['cnt']])
    out = _blocks_to_measures(
        flat(m1), flat(m0), flat(switchable), flat(A), flat(S), flat(D),
        flat(Ap), flat(Sp), flat(Dp), rlen, Lq=Lq, mqd=mqd, mrd=mrd,
        reg=reg, with_alns=with_alns, debug=debug, debug_extra=extra)
    return _unflatten(out, R, K, with_alns, debug)


# --------------------------------------------------------------------------
# the v2 front end: sort join, two-scale vote election, windowed eval
# --------------------------------------------------------------------------

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


def _check(t, name, dtype, shape, dev):
    """A wrapper's argument check: cuda.require and the exact shape."""
    cuda.require(t, name, dtype, len(shape), dev)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} must be {tuple(shape)}, got '
                         f'{tuple(t.shape)}')


def votes_elect_v2_plain(b, r_rows, q_rows, *, Lq, Lr, C, want_votes=False):
    """Plain torch version of K6 (K8 fused in) on any device: the two-scale
    election of the seed votes, elect_v2_plain(votes_v2_plain(...)).
    Returns A, S, D, vb (R, K, NBF) and the votes (R, K, NQ, 4), or None
    unless want_votes."""
    votes = votes_v2_plain(b, r_rows, q_rows, Lq=Lq, Lr=Lr, C=C)
    return (*elect_v2_plain(votes, Lq=Lq, Lr=Lr),
            votes if want_votes else None)


def _votes_elect_v2(b, r_rows, q_rows, *, Lq, Lr, C, want_votes=False):
    """K6 wrapper, K8 fused in (see votes_elect_v2_plain): the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors (or raise).
    The kernel reads the arena's rows in place, as `_index_block` builds
    them: the queries' seeds, and a reference row's sorted sv (ascending,
    BIG last; 16-byte aligned, a multiple of 4 entries) and pk1 at the end
    of the run of equal values (positions ascend inside a run, and pk2
    holds the position of the entry before: the kernel reads it from pk1).
    It takes 1-32 seeds a block, Lq a multiple of BLOCK and fewer than
    2^31 query slots a row; with want_votes it also writes the votes."""
    dev = r_rows.device
    if dev.type == 'cpu':
        return votes_elect_v2_plain(b, r_rows, q_rows, Lq=Lq, Lr=Lr, C=C,
                                    want_votes=want_votes)
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    if not 1 <= C <= 32:
        raise ValueError(f'K6 takes 1-32 seeds a block; got C={C}')
    if Lq % BLOCK or Lq < BLOCK:
        raise ValueError(f'K6: Lq={Lq} is not a positive multiple of '
                         f'{BLOCK}')
    pack_bits = b['pack_bits']
    if pack_bits not in (32, 64):
        raise ValueError(f'K6 takes packs of 32 or 64 bits; got '
                         f'{pack_bits}')
    if not (MIN_VOTES_F >= 1 and MIN_VOTES_C >= 1):
        raise ValueError('K6 takes MIN_VOTES_F and MIN_VOTES_C >= 1')
    R, K = q_rows.shape
    NBF = Lq // FINE
    NQ = NBF * C
    if K * NQ >= 1 << 31:
        raise ValueError(f'K6 takes fewer than 2^31 query slots a row; got '
                         f'{K} x {NQ}')
    r_rows, q_rows = r_rows.contiguous(), q_rows.contiguous()
    _check(r_rows, 'r_rows', torch.int32, (R,), dev)
    _check(q_rows, 'q_rows', torch.int32, (R, K), dev)
    Gq = b['qsv'].shape[0]
    for name in ('qsv', 'qoff'):
        _check(b[name], name, torch.int32, (Gq, NQ), dev)
    Gr, NR = b['sv_f'].shape
    for name, dt in (('sv_f', torch.int32), ('pk1_f', torch.int64),
                     ('sv_r', torch.int32), ('pk1_r', torch.int64)):
        _check(b[name], name, dt, (Gr, NR), dev)
    if NR % 4 or any(b[k].data_ptr() % 16 for k in ('sv_f', 'sv_r', 'pk1_f',
                                                    'pk1_r')):
        raise ValueError('K6 reads sv and pk1 16 bytes at a time: their rows '
                         'must hold a multiple of 4 entries, 16-byte '
                         'aligned')
    A, S = (torch.empty((R, K, NBF), dtype=torch.bool, device=dev)
            for _ in range(2))
    D, vb = (torch.empty((R, K, NBF), dtype=torch.int32, device=dev)
             for _ in range(2))
    votes = (torch.empty((R, K, NQ, 4), dtype=torch.int32, device=dev)
             if want_votes else None)
    if R and K:
        lib = cuda.library('align_v2', cuda.ALIGN_V2_SIGNATURES)
        with torch.cuda.device(dev):
            rc = lib.k6_front(
                *(cuda.ptr(b[k]) for k in ('qsv', 'qoff', 'sv_f', 'pk1_f',
                                           'sv_r', 'pk1_r')),
                cuda.ptr(r_rows), cuda.ptr(q_rows), R, K, NBF, NR, C, Lq, Lr,
                pack_bits, MIN_VOTES_F, MIN_VOTES_C,
                *(cuda.ptr(t) for t in (A, S, D, vb)),
                None if votes is None else cuda.ptr(votes),
                cuda.stream(A))
        cuda.check(lib, rc, 'k6_front')
        _votes_elect_v2.launches += 1
    return A, S, D, vb, votes


_votes_elect_v2.launches = 0


def _propagate_v2(b, r_rows, rlens, q_rows, qlens, A, S, D, *, Lr):
    """K7 wrapper (see propagate_v2_plain): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (or raise). The kernel takes
    EXT_ITERS (0-16), EXT_MIN and EXT_MARGIN (>= 0) as arguments and codes
    0-4 (as `encode` gives them); it reads the query codes and the window
    rows 16 bytes at a time, so both arenas must be 16-byte aligned (the
    rows are 32 and 64 bytes long)."""
    dev = A.device
    if dev.type == 'cpu':
        return propagate_v2_plain(b, r_rows, rlens, q_rows, qlens, A, S, D,
                                  Lr=Lr)
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    if A.dim() != 3:
        raise ValueError('stage 3: A must be (R, K, NBF)')
    R, K, NBF = A.shape
    Lq = NBF * FINE
    r_rows, rlens = r_rows.contiguous(), rlens.contiguous().view(-1)
    q_rows, qlens = q_rows.contiguous(), qlens.contiguous()
    _check(r_rows, 'r_rows', torch.int32, (R,), dev)
    _check(rlens, 'rlens', torch.int32, (R,), dev)
    _check(q_rows, 'q_rows', torch.int32, (R, K), dev)
    _check(qlens, 'qlens', torch.int32, (R, K), dev)
    for name, t, dt in (('A', A, torch.bool), ('S', S, torch.bool),
                        ('D', D, torch.int32)):
        _check(t, name, dt, (R, K, NBF), dev)
    _check(b['fwd'], 'fwd', torch.int8, (b['fwd'].shape[0], Lq), dev)
    G2, rows2 = b['r2dov'].shape[:2]
    _check(b['r2dov'], 'r2dov', torch.int8, (G2, rows2, 2 * FINE), dev)
    NRT = rows2 // 2
    if rows2 % 2 or NRT < Lr // FINE + 1:
        raise ValueError(f'K7: r2dov holds {rows2} rows a genome, fewer '
                         f'than two strands of Lr / 32 + 1 ({Lr})')
    if b['fwd'].data_ptr() % 16 or b['r2dov'].data_ptr() % 16:
        raise ValueError('K7 reads the query codes and the window rows 16 '
                         'bytes at a time: their arenas must be 16-byte '
                         'aligned')
    if not (0 <= EXT_ITERS <= 16 and EXT_MARGIN >= 0):
        raise ValueError('K7 takes EXT_ITERS 0-16 and EXT_MARGIN >= 0')
    m1, m0 = (torch.empty((R, K, Lq), dtype=torch.bool, device=dev)
              for _ in range(2))
    sw, A1, S1, Ap, Sp = (torch.empty((R, K, NBF), dtype=torch.bool,
                                      device=dev) for _ in range(5))
    D1, Dp = (torch.empty((R, K, NBF), dtype=torch.int32, device=dev)
              for _ in range(2))
    if R and K and NBF:
        lib = cuda.library('align_v2', cuda.ALIGN_V2_SIGNATURES)
        with torch.cuda.device(dev):
            rc = lib.k7_propagate(
                *(cuda.ptr(t) for t in (b['fwd'], q_rows, qlens, b['r2dov'],
                                        r_rows, rlens, A, S, D)),
                R * K, K, NBF, Lr, NRT, EXT_ITERS, EXT_MIN, EXT_MARGIN,
                *(cuda.ptr(t) for t in (m1, m0, sw, A1, S1, D1, Ap, Sp, Dp)),
                cuda.stream(A))
        cuda.check(lib, rc, 'k7_propagate')
        _propagate_v2.launches += 1
    return m1, m0, sw, A1, S1, D1, Ap, Sp, Dp


_propagate_v2.launches = 0


def _row_core(b, r_rows, rlens, q_rows, qlens, *, Lq, Lr, K, mqd, mrd, reg,
              C=None, with_alns=False, debug=False):
    """v2 aggregates for R dispatch rows of K directed pairs sharing one
    reference each.

    b: a v2 bucket dict (GenomeIndex.ensure or index_v2_from_numpy) at C
    seeds a block; r_rows, rlens: (R,) int32 arena rows and lengths of the
    references; q_rows, qlens: (R, K) int32 of the queries. Returns what
    `_row_core_v3` returns; with debug the intermediates of the JAX
    package's debug dict, `votes` and `vb` included."""
    C = SEEDS_PER_BLOCK if C is None else C
    R = r_rows.shape[0]
    if q_rows.shape != (R, K):
        raise ValueError(f'q_rows must be ({R}, {K})')
    A, S, D, vb, votes = _votes_elect_v2(b, r_rows, q_rows, Lq=Lq, Lr=Lr,
                                         C=C, want_votes=debug)
    flags = _propagate_v2(b, r_rows, rlens, q_rows, qlens, A, S, D, Lr=Lr)
    N = R * K

    def flat(x):
        return x.reshape((N,) + x.shape[2:])

    extra = dict(vb=flat(vb), votes=flat(votes)) if debug else None
    del votes
    out = _blocks_to_measures(
        *(flat(x) for x in flags), rlens[:, None].expand(R, K).reshape(N),
        Lq=Lq, mqd=mqd, mrd=mrd, reg=reg, with_alns=with_alns, debug=debug,
        debug_extra=extra)
    return _unflatten(out, R, K, with_alns, debug)


def _unflatten(out, R, K, with_alns, debug):
    """The back half's (N, ...) results as (R, K, ...)."""
    if debug:
        return {k: ([x.view((R, K) + x.shape[1:]) for x in v]
                    if isinstance(v, list) else v.view((R, K) + v.shape[1:]))
                for k, v in out.items()}
    if with_alns:
        return tuple(x.view((R, K) + x.shape[1:]) for x in out)
    return out.view(R, K, 3)


def _dispatch_rows(L: int, K: int, device: torch.device,
                   with_alns: bool) -> int:
    """v3 dispatch rows B at bucket L with K queries a row: as many as keep
    the live bytes of one dispatch on `device` under _LIVE_BYTES. A query
    holds the counts of four bands (4*NBF*BAND bytes; K3 and K5 read the
    windows from the wide rows in place, so no window tensor is live) and
    _BYTES_PER_POS (_BYTES_PER_POS_RECORDS with records) a query position
    for stages 5-6 and the back half; on the CPU also what the plain
    versions hold: stage 1's float32 operand (2*NQB*H*4 bytes; K2 reads
    the int8 arena in place) and the windows of `_band_windows`
    (4*NBF*WIN bytes). Results do not depend on B."""
    g3 = _v3_geom(L, L)
    per_pos = _BYTES_PER_POS_RECORDS if with_alns else _BYTES_PER_POS
    per_query = 4 * (L // FINE) * g3['BAND'] + L * per_pos
    if device.type == 'cpu':
        per_query += 2 * g3['NQB'] * V3_H * 4 + 4 * (L // FINE) * g3['WIN']
    return max(1, _LIVE_BYTES // (K * per_query))


def _dispatch_rows_v2(L: int, K: int, with_alns: bool) -> int:
    """v2 dispatch rows B at bucket L with K queries a row: as many as keep
    the live bytes of one dispatch under _LIVE_BYTES, at _V2_BYTES_PER_POS
    (_V2_BYTES_PER_POS_RECORDS with records) a query position. Results do
    not depend on B."""
    per_pos = _V2_BYTES_PER_POS_RECORDS if with_alns else _V2_BYTES_PER_POS
    return max(1, _LIVE_BYTES // (K * L * per_pos))


def _group_gids(by_ref: dict) -> set:
    """Genomes of a {ref: [(query, pair row, column), ...]} group."""
    gids = set(by_ref)
    for ts in by_ref.values():
        gids.update(qi for (qi, _p, _c) in ts)
    return gids


def _split_group(by_ref: dict, cap: int) -> list:
    """Partition one bucket group's {ref: tasks} map into sub-groups whose
    genome footprint (refs + queries) stays <= cap. Greedy over refs in
    sorted order; a single ref whose own task list exceeds the cap is
    split across sub-groups by task chunks."""
    subs = []
    cur, cur_g = {}, set()
    for ri in sorted(by_ref):
        ts = by_ref[ri]
        lo = 0
        while lo < len(ts):
            room = cap - len(cur_g) - (0 if ri in cur_g else 1)
            picked = []
            for t in ts[lo:]:
                extra = 0 if t[0] in cur_g or t[0] == ri else 1
                if room - extra < 0:
                    break
                room -= extra
                picked.append(t)
                cur_g.add(t[0])
            if picked:
                cur_g.add(ri)
                cur.setdefault(ri, []).extend(picked)
                lo += len(picked)
            if lo < len(ts):            # ran out of room: flush
                if cur:
                    subs.append(cur)
                cur, cur_g = {}, set()
    if cur:
        subs.append(cur)
    return subs


def _all2all_single(codes_list: Sequence[np.ndarray], pairs: np.ndarray,
                    params: Optional[AlignParams] = None,
                    index: Optional[GenomeIndex] = None,
                    keep_alignments: bool = False,
                    seeds_per_block: Optional[int] = None, pipe: str = 'v2',
                    device=None, mesh=None):
    """All-vs-all aggregates on the device for unordered candidate `pairs`
    over ids-ordered genomes: the JAX package's `_all2all_single` on one
    device. pipe='v3' runs the v3 pipe on every bucket up to V3_MAX_BUCKET
    and v2 above; pipe='v2' runs v2 everywhere, at seeds_per_block seeds a
    fine block (default SEEDS_PER_BLOCK). Returns int64 (len(pairs), 6) =
    (n_ji, match_ji, alnlen_ji, n_ij, match_ij, alnlen_ij), as
    lz_native.all2all_native's aggregates.

    keep_alignments=True also returns (aln_rows, aln_counts): int32 (N, 6)
    (qstart, qend, rstart, rend, nt_match, nt_mismatch), 0-based, reverse
    strand as rstart > rend, and (2 * len(pairs),) rows per directed task,
    (q=j, r=i) first. Segments past the per-pair cap (MAXSEG) are dropped
    from the rows, with a warning (aggregates stay exact).

    Runs on `index.device`, else `device` (default cuda), or with `mesh`
    over its shards: the dispatches of B rows (from the budget of one
    device) are dealt to the shards in turn, counted over the groups, and
    each group's arena, built on the index's device, is copied once to
    each other device of the mesh. Results do not depend on B or on the
    deal. Raises for genomes longer than MAX_TPU_LEN."""
    if pipe not in ('v2', 'v3'):
        raise ValueError(f'pipe={pipe!r}: expected v2 or v3')
    params = params or AlignParams()
    C = SEEDS_PER_BLOCK if seeds_per_block is None else seeds_per_block
    mqd, mrd, reg = params.mqd, params.mrd, params.reg
    idx = index or GenomeIndex(
        codes_list, device=device if mesh is None else mesh.devices[0])
    mesh = mesh or make_mesh(device=idx.device)
    shards, n_shards = local_shards(mesh)
    local = dict(shards)
    lens = idx.lens
    pairs = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)

    # Directed tasks grouped by the PAIR's max bucket (both sides padded
    # to it), then by reference genome so each dispatch row shares its
    # reference K ways.
    groups: Dict[int, Dict[int, List]] = {}
    for prow, (i, j) in enumerate(pairs):
        i, j = int(i), int(j)
        if i in idx.oversized or j in idx.oversized:
            raise ValueError(
                f'pair ({i}, {j}) touches a genome longer than '
                f'{MAX_TPU_LEN} bases — beyond the device engine\'s '
                f'position range; align it with the native engine')
        kb = max(_pad_bucket(lens[i]), _pad_bucket(lens[j]))
        for (qi, ri, col) in ((j, i, 0), (i, j, 3)):
            groups.setdefault(kb, {}).setdefault(ri, []).append(
                (qi, prow, col))

    out = np.zeros((len(pairs), 6), dtype=np.int64)
    dealt = 0
    work = []      # (kb, by_ref_subset, cacheable)
    for kb, by_ref in sorted(groups.items()):
        if MAX_ARENA and len(_group_gids(by_ref)) > MAX_ARENA:
            work += [(kb, sub, False)
                     for sub in _split_group(by_ref, max(MAX_ARENA, 2))]
        else:
            work.append((kb, by_ref, True))
    pending = []   # (device results, task map, record cap)
    for kb, by_ref, cacheable in work:
        gids = _group_gids(by_ref)
        use_v3 = pipe == 'v3' and kb <= V3_MAX_BUCKET
        b = (idx.ensure_v3(kb, gids, cache=cacheable) if use_v3
             else idx.ensure(kb, gids, C, cache=cacheable))
        K = K_QUERIES
        max_tasks = max(len(ts) for ts in by_ref.values())
        if max_tasks < K:
            K = max(1, 1 << (max_tasks - 1).bit_length())
        rows = []        # (ref_idx, [task, ...] of length <= K)
        for ri in sorted(by_ref):
            ts = by_ref[ri]
            for lo in range(0, len(ts), K):
                rows.append((ri, ts[lo:lo + K]))
        n = len(rows)
        r_rows = np.zeros(n, np.int32)
        rlens = np.zeros(n, np.int32)
        q_rows = np.zeros((n, K), np.int32)
        qlens = np.zeros((n, K), np.int32)
        # Per-task placement arrays double as the vectorized scatter-back
        # map (task -> output row/direction).
        t_w, t_i_, t_prow, t_col = [], [], [], []
        for w, (ri, ts) in enumerate(rows):
            r_rows[w] = b['rows'][ri]
            rlens[w] = lens[ri]
            for t_i, (qi, prow_, col_) in enumerate(ts):
                q_rows[w, t_i] = b['rows'][qi]
                qlens[w, t_i] = lens[qi]
                t_w.append(w)
                t_i_.append(t_i)
                t_prow.append(prow_)
                t_col.append(col_)
        tmap = tuple(np.asarray(x, np.int64) for x in (t_w, t_i_, t_prow,
                                                        t_col))
        static = dict(Lq=kb, Lr=kb, K=K, mqd=mqd, mrd=mrd, reg=reg,
                      with_alns=keep_alignments)
        if use_v3:
            B = _dispatch_rows(kb, K, idx.device, keep_alignments)
        else:
            B = _dispatch_rows_v2(kb, K, keep_alignments)

        def run(b, rr, rl, qr, ql):
            if use_v3:
                return _row_core_v3(b, rr, rl, qr, V3_TBAND, V3_SMIN,
                                    **static)
            return _row_core(b, rr, rl, qr, ql, C=C, **static)

        # Dispatches are dealt to the shards in turn, counted over the
        # groups; a process runs those of its own shards.
        arena = replicate(mesh, b)
        results = []   # (first row, device results), in row order
        for lo in range(0, n, B):
            dev = local.get(dealt % n_shards)
            dealt += 1
            if dev is not None:
                results.append((lo, run(arena[dev], *(
                    torch.from_numpy(a[lo:lo + B]).to(dev)
                    for a in (r_rows, rlens, q_rows, qlens)))))
        pending.append((results, tmap, _maxseg(kb, reg)))
    # Host copies of this process's dispatches, joined with every other
    # process's in row order.
    host = [[(lo, _to_host(r)) for lo, r in results]
            for results, _, _ in pending]
    everyone = gather(mesh, host)
    pending = [(sorted((x for h in everyone for x in h[w]),
                       key=lambda x: x[0]), tmap, maxseg)
               for w, (_, tmap, maxseg) in enumerate(pending)]
    task_alns = {}   # (prow, col) -> (n, 6) int32 records
    saturated = []   # pairs whose records overflowed the cap (MAXSEG)
    for results, tmap, maxseg in pending:
        res = [r for _, r in results]
        if keep_alignments:
            flat, recs, nrec = (np.concatenate(x) for x in zip(*res))
        else:
            flat = np.concatenate(res)
        t_w, t_i_, t_prow, t_col = tmap
        out.reshape(-1, 2, 3)[t_prow, t_col // 3] = flat[t_w, t_i_]
        if keep_alignments:
            for w, ti, prow, col in zip(t_w, t_i_, t_prow, t_col):
                rr = recs[w, ti]
                task_alns[(int(prow), int(col))] = rr[rr[:, 0] >= 0]
                if nrec[w, ti] > maxseg:
                    saturated.append(tuple(pairs[prow]))
    if not keep_alignments:
        return out
    if saturated:
        # Aggregates (num_alns etc.) stay exact; only the emitted rows are
        # capped, so the row count disagrees with num_alns for these pairs.
        get_logger().warning(
            f'{len(saturated)} directed pair(s) overflowed the per-pair '
            f'alignment record cap; their --out-aln rows are truncated '
            f'(aggregates remain exact). Affected id pairs: '
            + ', '.join(f'({i},{j})' for i, j in saturated[:8])
            + ('...' if len(saturated) > 8 else ''))
    empty = np.empty((0, 6), np.int32)
    blocks = [task_alns.get((prow, col), empty)
              for prow in range(len(pairs)) for col in (0, 3)]
    counts = np.array([len(blk) for blk in blocks], dtype=np.int64)
    return out, (np.concatenate(blocks) if blocks else empty, counts)


def _to_host(r):
    """A dispatch's results (a tensor, or a tuple of them with records) as
    numpy arrays; host arrays pass through."""
    if isinstance(r, tuple):
        return tuple(_to_host(x) for x in r)
    return r.cpu().numpy() if torch.is_tensor(r) else r


def _merge_records(recs_all, recs_sub, rerun):
    """The records of every directed task, taking those of the pairs
    `rerun` (bool, one a pair) from recs_sub (their own run) and the rest
    from recs_all; both in _all2all_single's (rows, counts) layout."""
    (rows_a, counts_a), (rows_s, counts_s) = recs_all, recs_sub
    offs_a = np.concatenate([[0], np.cumsum(counts_a)])
    offs_s = np.concatenate([[0], np.cumsum(counts_s)])
    sub_of = np.cumsum(rerun) - 1       # rerun pair -> its row in recs_sub
    blocks, counts = [], np.zeros_like(counts_a)
    for t in range(len(counts_a)):      # directed task t of pair t // 2
        prow, d = divmod(t, 2)
        if rerun[prow]:
            s = 2 * sub_of[prow] + d
            blocks.append(rows_s[offs_s[s]:offs_s[s + 1]])
        else:
            blocks.append(rows_a[offs_a[t]:offs_a[t + 1]])
        counts[t] = len(blocks[-1])
    return (np.concatenate(blocks) if blocks
            else np.empty((0, 6), np.int32)), counts


def all2all_gpu(codes_list: Sequence[np.ndarray], pairs: np.ndarray,
                params: Optional[AlignParams] = None,
                index: Optional[GenomeIndex] = None,
                keep_alignments: bool = False, device=None, mesh=None):
    """The device align engine's all-vs-all, the JAX package's
    `all2all_tpu` on one device; output as `_all2all_single`'s.

    VCLUST_ALIGN_PIPE=v3 (the default): every pair on the v3 pipe (v2
    above V3_MAX_BUCKET), then the hybrid: the pairs v3 leaves hard (tANI
    > 0.05 and a query or reference coverage below V3_RERUN_COV) are
    aligned again on v2 at SEEDS_PER_BLOCK and take its aggregates and
    records. VCLUST_ALIGN_PIPE=v2: the v2 pipe; with neither records nor
    VCLUST_ALIGN_TWO_PHASE=0, pairs from the bucket TWO_PHASE_MIN_BUCKET
    up are screened at PHASE1_C seeds a block and those with RERUN_LO <
    tANI < RERUN_HI aligned again at SEEDS_PER_BLOCK (so aggregates
    outside that band can differ with and without records, as in the JAX
    package). A fixed sampling density is `_all2all_single`'s
    seeds_per_block. With `mesh`, every `_all2all_single` call runs over
    it."""
    idx = index or GenomeIndex(
        codes_list, device=device if mesh is None else mesh.devices[0])
    pairs = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)
    pipe = os.environ.get('VCLUST_ALIGN_PIPE', 'v3')
    if pipe not in ('v2', 'v3'):
        raise ValueError(f'VCLUST_ALIGN_PIPE={pipe!r}: expected v2 or v3')

    # `mesh` only when there is one: the calls keep _all2all_single's
    # positional form otherwise.
    over = {} if mesh is None else {'mesh': mesh}

    def run(p, C, keep, pipe_='v2'):
        return _all2all_single(codes_list, p, params, idx, keep, C, pipe_,
                               **over)

    if pipe == 'v3':
        res = run(pairs, SEEDS_PER_BLOCK, keep_alignments, 'v3')
        if V3_RERUN_COV <= 0 or not len(pairs):
            return res
        out = res[0] if keep_alignments else res
        lens = idx.lens.astype(np.int64)
        lj = np.maximum(lens[pairs[:, 1]], 1)   # the query of direction 1
        li = np.maximum(lens[pairs[:, 0]], 1)
        tani = (out[:, 1] + out[:, 4]) / (lj + li)
        hard = (tani > 0.05) & ((out[:, 2] / lj < V3_RERUN_COV)
                                | (out[:, 5] / li < V3_RERUN_COV))
        if not hard.any():
            return res
        sub = run(pairs[hard], SEEDS_PER_BLOCK, keep_alignments)
        if not keep_alignments:
            out[hard] = sub
            return out
        out[hard] = sub[0]
        return out, _merge_records(res[1], sub[1], hard)
    if (keep_alignments or not len(pairs)
            or os.environ.get('VCLUST_ALIGN_TWO_PHASE') == '0'):
        return run(pairs, SEEDS_PER_BLOCK, keep_alignments)
    lens = idx.lens.astype(np.int64)
    # Small buckets are bound by dispatch latency: the screen applies only
    # to pairs whose bucket reaches TWO_PHASE_MIN_BUCKET.
    kb = np.array([max(_pad_bucket(int(lens[i])), _pad_bucket(int(lens[j])))
                   for i, j in pairs], dtype=np.int64)
    big = kb >= TWO_PHASE_MIN_BUCKET
    out = np.zeros((len(pairs), 6), dtype=np.int64)
    if (~big).any():
        out[~big] = run(pairs[~big], SEEDS_PER_BLOCK, False)
    if big.any():
        pb = pairs[big]
        o1 = run(pb, PHASE1_C, False)
        pair_len = lens[pb[:, 0]] + lens[pb[:, 1]]
        tani1 = (o1[:, 1] + o1[:, 4]) / np.maximum(pair_len, 1)
        band = (tani1 > RERUN_LO) & (tani1 < RERUN_HI)
        if band.any():
            o1[band] = run(pb[band], SEEDS_PER_BLOCK, False)
        out[big] = o1
    return out
