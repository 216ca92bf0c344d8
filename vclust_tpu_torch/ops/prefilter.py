"""Shared-k-mer counting as an exact weighted occupancy count on the device.

The port of the JAX package's ops/prefilter.py. The host builds kmer-db's
pattern-compressed incidence index (reference contract
vclust.py:915-1055; SURVEY.md section 2.4): per distinct genome
set ("pattern") of the k-mers shared by >= 2 genomes, its genome ids and
its multiplicity weight. The device turns it into exact pair counts,
pass by pass, with kernel K1 (csrc/occupancy.cu):

    counts[i, j] += sum_r occ[r, i] * w[r] * occ[r, j]

over a {0,1} (patterns x genomes) occupancy, accumulated in int32. The
chunking is the JAX package's (`_adapt_chunks`, `_chunk_groups` and the
rows_chunk cap), so chunks match one to one, and the result equals its
rint(f32) counts bit for bit. Consecutive chunks whose occupancy fits at
once form one pass, one K1 launch, so counts are added once a pass.
Inside a chunk the patterns are put in the order of their weights' byte
counts, and the host plans the kernel's work (`device_chunks`): the limb
count of each k-block, the list of tiles on or above the diagonal, split
along k when they are fewer than the SMs, and whether the kernel builds
the occupancy from the COO.

The same kernel serves the unweighted counts (`shared_kmer_counts_device`:
every k-mer group of >= 2 genomes at weight 1, one limb), the row panels
(`shared_kmer_counts_panels`: an output window of (panel x n) rows, each
tile of the row band added once) and a mesh (`shared_kmer_counts_indexed`
with `mesh`: each pass's work list cut among the mesh's shards, a counts
on each device, the devices' counts added on the first device and across
processes on the host; parallel/mesh.py).

`occupancy_count` is K1's wrapper: CPU tensors take
`occupancy_count_plain` (the scatter and a float64 product, exact for
integers below 2^53), CUDA tensors launch the kernel or raise.
`occupancy_count.launches` counts kernel launches.
"""

import ctypes
import pathlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import cuda
from ..parallel.distributed import reduce_sum
from ..parallel.mesh import local_shards, make_mesh
from ..utils.device import resolve_device

# Corpora of at most this many genomes are counted on the host when the
# engine/backend is 'auto', as in the JAX package.
_HOST_MAX_GENOMES = 32

# K1's output tile edge and k-block (patterns), as in csrc/occupancy.cu,
# and the tile rows of one band of its work order.
K1_TILE = 128
K1_KBLOCK = 128
_K1_BAND = 8
# SMs of an H100 SXM: the work list made for CPU tensors is an H100's.
_H100_SMS = 132

# Limits of K1's occupancy build from the COO (`k1_from_coo`).
_K1_COO_KBLOCKS = 2
_K1_COO_READS = 1 << 20
# Occupancy bytes (genomes x patterns rounded up to k-blocks) of one K1
# pass: consecutive chunks are merged up to this size, so counts are added
# once a pass, not once a chunk (at 16,384 genomes on an H100, 17 chunks
# as 17 launches took ~8 ms more than as one pass; PERF.md). Below
# 2^31, so a pass's entries fit int32 offsets.
_K1_PASS_BYTES = 3 << 29

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'k1_count_chunk': [_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _P, _I,
                       _I, _I, _I, _P, _P],
}


def _group_coo(kmer_sets):
    """Host grouping of the (k-mer, genome) incidence by k-mer value.

    Returns (sg, shared_lens): entry genome ids sorted by k-mer (stable, so
    each group's entries stay in genome order) and per-group sizes, with
    singleton groups (k-mers in exactly one genome) dropped — they cannot
    contribute to off-diagonal shared counts.
    """
    nonempty = [s for s in kmer_sets if len(s)]
    if not nonempty:
        return (np.empty(0, np.int32), np.empty(0, np.int32))
    all_kmers = np.concatenate(nonempty)
    all_gids = np.concatenate(
        [np.full(len(s), g, dtype=np.int32) for g, s in enumerate(kmer_sets)
         if len(s)])
    order = np.argsort(all_kmers, kind='stable')
    sk = all_kmers[order]
    sg = all_gids[order]
    del order, all_kmers, all_gids
    starts = np.empty(len(sk), dtype=bool)
    starts[0] = True
    np.not_equal(sk[1:], sk[:-1], out=starts[1:])
    del sk
    start_idx = np.flatnonzero(starts)
    lens = np.diff(start_idx, append=len(sg))
    shared = lens >= 2
    sg = sg[np.repeat(shared, lens)]
    shared_lens = lens[shared].astype(np.int32)
    return sg, shared_lens


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def _dedup_patterns(sg, lens):
    """kmer-db's pattern compression (SURVEY.md section 2.4.1): many k-mer
    groups share the same genome-id set ("pattern"); counting each distinct
    pattern once with a multiplicity weight shrinks the device work by the
    dedup ratio. Patterns are keyed by two independent 64-bit position-mixed
    hashes + length (collision odds ~ n_groups^2 / 2^128).

    Returns (sg_d, lens_d, weights) with weights int64.
    """
    n_groups = len(lens)
    if n_groups == 0:
        return sg, lens, np.ones(0, np.int64)
    starts = np.zeros(n_groups, dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    pos = np.arange(len(sg), dtype=np.uint64) - np.repeat(
        starts.astype(np.uint64), lens)
    g64 = sg.astype(np.uint64)
    e1 = _mix64(g64 + (pos + np.uint64(1)) * np.uint64(0x9E3779B97F4A7C15))
    e2 = _mix64(g64 ^ ((pos + np.uint64(7)) * np.uint64(0xC2B2AE3D27D4EB4F)))
    h1 = np.add.reduceat(e1, starts)
    h2 = np.add.reduceat(e2, starts)
    order = np.lexsort((h2, h1, lens))
    l_s, h1_s, h2_s = lens[order], h1[order], h2[order]
    new = np.empty(n_groups, dtype=bool)
    new[0] = True
    new[1:] = ((l_s[1:] != l_s[:-1]) | (h1_s[1:] != h1_s[:-1])
               | (h2_s[1:] != h2_s[:-1]))
    pat_id_sorted = np.cumsum(new) - 1
    n_pat = int(pat_id_sorted[-1]) + 1
    weights = np.bincount(pat_id_sorted, minlength=n_pat).astype(np.int64)
    rep_group = order[new]            # first group of each distinct pattern
    lens_d = lens[rep_group]
    # Gather the representative groups' entries.
    rep_starts = starts[rep_group]
    out_starts = np.zeros(n_pat, dtype=np.int64)
    np.cumsum(lens_d[:-1], out=out_starts[1:])
    total = int(lens_d.sum())
    gather = (np.repeat(rep_starts, lens_d)
              + (np.arange(total, dtype=np.int64)
                 - np.repeat(out_starts, lens_d)))
    return sg[gather], lens_d, weights


class PrefilterIndex:
    """Pattern-compressed incidence index — the kmer-db `build` analog.

    Holds the deduplicated (pattern x genome) COO plus per-pattern
    multiplicities; `shared_kmer_counts_indexed` is the `all2all` analog
    that turns it into exact pair counts on the device.
    """

    def __init__(self, kmer_sets, dedup: bool = True, engine: str = 'auto'):
        self.n = len(kmer_sets)
        self.sizes = np.array([len(s) for s in kmer_sets], dtype=np.int64)
        if dedup and engine in ('auto', 'native'):
            from . import kmer_native
            native = kmer_native.build_index(kmer_sets)
            if native is not None:
                self.gids, self.lens, self.weights, self.n_groups = native
                return
            if engine == 'native':
                raise RuntimeError('native index engine unavailable')
        sg, lens = _group_coo(kmer_sets)
        self._finish(sg, lens, dedup)

    @classmethod
    def from_coo(cls, sorted_kmers, gids, sizes, dedup: bool = True):
        """Index from a k-mer-sorted (kmer, gid) COO — the path used by the
        out-of-core batch store, where the COO comes from merging persisted
        per-batch artifacts rather than from in-RAM k-mer sets."""
        self = cls.__new__(cls)
        self.n = len(sizes)
        self.sizes = np.asarray(sizes, dtype=np.int64)
        starts = np.empty(len(sorted_kmers), dtype=bool)
        if len(sorted_kmers):
            starts[0] = True
            np.not_equal(sorted_kmers[1:], sorted_kmers[:-1],
                         out=starts[1:])
            start_idx = np.flatnonzero(starts)
            lens = np.diff(start_idx, append=len(gids))
            shared = lens >= 2
            sg = gids[np.repeat(shared, lens)]
            lens = lens[shared].astype(np.int32)
        else:
            sg = np.empty(0, np.int32)
            lens = np.empty(0, np.int32)
        self._finish(sg, lens, dedup)
        return self

    def _finish(self, sg, lens, dedup):
        self.n_groups = len(lens)
        if dedup:
            sg, lens, weights = _dedup_patterns(sg, lens)
        else:
            weights = np.ones(len(lens), np.int64)
        self.gids = sg
        self.lens = lens
        self.weights = weights

    @property
    def dedup_ratio(self) -> float:
        return self.n_groups / max(len(self.lens), 1)


def index_from_numpy(n: int, sizes, gids, lens, weights,
                     n_groups: int = None) -> PrefilterIndex:
    """A PrefilterIndex from its arrays: n genomes, per-genome k-mer-set
    sizes, the pattern COO (gids, per-pattern lens) and per-pattern
    weights. Lets a caller hand the same index to another implementation
    (e.g. the arrays of the JAX package's PrefilterIndex) or build a
    synthetic one."""
    idx = PrefilterIndex.__new__(PrefilterIndex)
    idx.n = int(n)
    idx.sizes = np.asarray(sizes, dtype=np.int64)
    idx.gids = np.asarray(gids, dtype=np.int32)
    idx.lens = np.asarray(lens, dtype=np.int32)
    idx.weights = np.asarray(weights, dtype=np.int64)
    idx.n_groups = len(idx.lens) if n_groups is None else int(n_groups)
    if len(idx.sizes) != idx.n or int(idx.lens.sum()) != len(idx.gids) \
            or len(idx.weights) != len(idx.lens):
        raise ValueError('inconsistent index arrays')
    return idx


class BatchIndexStore:
    """Persisted per-batch incidence artifacts — the kmer-db `.kdb` analog
    (reference builds one reusable database per `--batch-size` part,
    vclust.py:1428-1442, and computes the all-vs-all blockwise via
    `all2all-parts`). Each batch stores its k-mer-sorted (kmer, gid) COO +
    per-genome set sizes as memmappable .npy files; the pair-count matrix
    is produced block-by-block by merging two batches' sorted streams, so
    host RAM holds at most two batches and each (i, j) block costs
    O(nnz_i + nnz_j) — no full-corpus COO is ever materialized.
    """

    def __init__(self, directory):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.batches = []     # list of (gid_offset, n_genomes)

    def add_batch(self, kmer_sets, gid_offset: int) -> int:
        """Persist one batch; genome ids are global (offset + local)."""
        b = len(self.batches)
        nonempty = [np.asarray(s, dtype=np.uint64) for s in kmer_sets]
        if any(len(s) for s in nonempty):
            ks = np.concatenate([s for s in nonempty if len(s)])
            gs = np.concatenate(
                [np.full(len(s), gid_offset + g, dtype=np.int32)
                 for g, s in enumerate(nonempty) if len(s)])
            order = np.argsort(ks, kind='stable')
            ks, gs = ks[order], gs[order]
        else:
            ks = np.empty(0, np.uint64)
            gs = np.empty(0, np.int32)
        np.save(self.dir / f'batch{b:05d}.kmers.npy', ks)
        np.save(self.dir / f'batch{b:05d}.gids.npy', gs)
        np.save(self.dir / f'batch{b:05d}.sizes.npy',
                np.array([len(s) for s in nonempty], dtype=np.int64))
        self.batches.append((gid_offset, len(kmer_sets)))
        return b

    def _load(self, b):
        mm = dict(mmap_mode='r')
        return (np.load(self.dir / f'batch{b:05d}.kmers.npy', **mm),
                np.load(self.dir / f'batch{b:05d}.gids.npy', **mm),
                np.load(self.dir / f'batch{b:05d}.sizes.npy'))

    def sizes(self):
        out = []
        for b in range(len(self.batches)):
            out.append(np.load(self.dir / f'batch{b:05d}.sizes.npy'))
        return np.concatenate(out) if out else np.empty(0, np.int64)

    def pair_block(self, i: int, j: int, device=None, mesh=None):
        """Exact shared-k-mer counts between batches i and j (i <= j), on
        `device` or over `mesh`.

        Returns (rows_offset, cols_offset, counts) where counts is the
        (n_i, n_j) int64 block (full square block for i == j).
        """
        ki, gi, szi = self._load(i)
        off_i, n_i = self.batches[i]
        if i == j:
            local = gi - off_i
            idx = PrefilterIndex.from_coo(np.asarray(ki), local, szi)
            counts = shared_kmer_counts_indexed(idx, device=device, mesh=mesh)
            return off_i, off_i, counts
        kj, gj, szj = self._load(j)
        off_j, n_j = self.batches[j]
        # Merge the two sorted streams (stable radix sort of the concat).
        ks = np.concatenate([np.asarray(ki), np.asarray(kj)])
        gs = np.concatenate([gi - off_i, gj - off_j + n_i])
        order = np.argsort(ks, kind='stable')
        ks, gs = ks[order], gs[order]
        sizes = np.concatenate([szi, szj])
        idx = PrefilterIndex.from_coo(ks, gs, sizes)
        counts = shared_kmer_counts_indexed(idx, device=device, mesh=mesh)
        return off_i, off_j, counts[:n_i, n_i:]


def occupancy_count_plain(counts, gids, offs, weights, n_limbs=None,
                          row0=0):
    """Plain torch version of K1 on any device: scatter the chunk's {0,1}
    (patterns x genomes) occupancy and add occ^T (w occ) in float64, which
    is exact for integer sums below 2^53. counts is the (rows, n) window of
    genome rows [row0, row0 + rows) (the whole n x n at row0 = 0). Updates
    counts in place."""
    rows, n = counts.shape
    occ, w_occ = _plain_operands(n, gids, offs, weights, counts.device)
    prod = occ[:, row0:row0 + rows].T @ w_occ
    counts += torch.round(prod).to(counts.dtype)
    return counts


def _plain_operands(n, gids, offs, weights, device):
    """The float64 occupancy (patterns x n) and its rows times the weights."""
    ng = offs.numel() - 1
    sizes = (offs[1:] - offs[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(ng, device=device), sizes)
    occ = torch.zeros((ng, n), dtype=torch.float64, device=device)
    occ[rows, gids.long()] = 1.0
    return occ, occ * weights.to(torch.float64)[:, None]


def _count_work_plain(counts, chunk: 'K1Chunk'):
    """The plain version of a pass whose work list holds only some of its
    tiles or k-blocks (a mesh shard's part): for each k range of the list,
    the product over its patterns, added on the tiles that take that range
    (and their transposes, mirrored). Updates counts in place."""
    rows, n = counts.shape
    row0 = chunk.window[0] if chunk.window else 0
    ng = chunk.weights.numel()
    occ, w_occ = _plain_operands(n, chunk.gids, chunk.offs, chunk.weights,
                                 counts.device)
    work = chunk.work.cpu().numpy()
    nt = -(-n // K1_TILE)
    for lo, hi in np.unique(work[:, 2:], axis=0):
        sel = work[(work[:, 2] == lo) & (work[:, 3] == hi)]
        tiles = torch.zeros((nt, nt), dtype=torch.bool)
        tiles[sel[:, 0], sel[:, 1]] = True
        if chunk.window is None:
            tiles[sel[:, 1], sel[:, 0]] = True
        mask = tiles.repeat_interleave(K1_TILE, 0).repeat_interleave(
            K1_TILE, 1)[row0:row0 + rows, :n].to(counts.device)
        p = slice(lo * K1_KBLOCK, min(hi * K1_KBLOCK, ng))
        prod = occ[p, row0:row0 + rows].T @ w_occ[p]
        counts += torch.round(prod * mask).to(counts.dtype)
    return counts


class K1Chunk(NamedTuple):
    """One K1 pass: the COO of a run of consecutive chunks, each chunk's
    patterns in weight-byte order, and the host's plan for it."""
    n: int                  # genomes: counts is n x n, or window[1] x n
    parts: tuple            # patterns of each chunk in the pass, in order
    gids: torch.Tensor      # int32 genome ids of the ng patterns
    offs: torch.Tensor      # int32 (ng + 1) offsets of the patterns in gids
    weights: torch.Tensor   # int32 (ng) pattern weights, below 2^24
    wbytes: torch.Tensor    # uint8 (nkb, 3, 128): byte l of each weight
    kb_limbs: torch.Tensor  # int32 (nkb): limb count of each k-block
    work: torch.Tensor      # int32 (items, 4): (ti, tj, kb_lo, kb_hi)
    n_limbs: int            # the largest of kb_limbs
    split: int              # most work items of one tile (1: no split-K)
    from_coo: bool          # occupancy built from the COO (`k1_from_coo`)
    # None: counts is n x n, tiles ti <= tj added at (i, j) and (j, i).
    # (row0, rows): counts is the rows x n window of genome rows [row0,
    # row0 + rows), row0 a multiple of 128, tiles of its row band added once.
    window: Optional[tuple] = None


def _work_is_whole(chunk: K1Chunk) -> bool:
    """Whether the work list covers every tile of its counts (the upper
    tiles, or the window's row band) at every k-block. Lists are valid (no
    (tile, k-block) twice), so the covered count tells."""
    work = chunk.work.cpu().numpy()
    nt = -(-chunk.n // K1_TILE)
    if chunk.window is None:
        tiles = nt * (nt + 1) // 2
    else:
        row0, rows = chunk.window
        tiles = (-(-(row0 + rows) // K1_TILE) - row0 // K1_TILE) * nt
    return int((work[:, 3] - work[:, 2]).sum()) == tiles * \
        chunk.kb_limbs.numel()


def occupancy_count(counts, chunk: K1Chunk):
    """K1 wrapper, one pass: counts (n, n) int32 += occ^T diag(w) occ for
    the pass's patterns r, whose genome ids are gids[offs[r]:offs[r+1]]
    (ids in [0, n); offs starting at 0), or the (rows, n) rows of it that
    the pass's window holds. The pass comes from `device_chunks` (or
    `k1_passes`), its work list whole or a mesh shard's part. CPU tensors
    take the plain version, one chunk at a time (as the JAX package bounds
    its memory), CUDA tensors the kernel (or raise). Updates counts in
    place."""
    dev = counts.device
    cuda.require(counts, 'counts', torch.int32, 2, dev)
    for name, dtype, ndim in (('gids', torch.int32, 1),
                              ('offs', torch.int32, 1),
                              ('weights', torch.int32, 1),
                              ('wbytes', torch.uint8, 3),
                              ('kb_limbs', torch.int32, 1),
                              ('work', torch.int32, 2)):
        cuda.require(getattr(chunk, name), name, dtype, ndim, dev)
    n = chunk.n
    row0, rows = chunk.window or (0, n)
    ng = chunk.offs.numel() - 1
    nkb = -(-ng // K1_KBLOCK)
    if counts.shape != (rows, n):
        raise ValueError(f'counts must be {rows} x {n}, got '
                         f'{tuple(counts.shape)}')
    if row0 % K1_TILE or row0 < 0 or rows < 1 or row0 + rows > n:
        raise ValueError(f'window rows [{row0}, {row0 + rows}) must start '
                         f'at a multiple of {K1_TILE} and lie in [0, {n})')
    if chunk.weights.numel() != ng or ng < 1:
        raise ValueError('weights must hold one entry per pattern (>= 1)')
    if (chunk.kb_limbs.numel() != nkb
            or tuple(chunk.wbytes.shape) != (nkb, 3, K1_KBLOCK)
            or chunk.work.shape[1] != 4 or chunk.work.shape[0] < 1
            or sum(chunk.parts) != ng):
        raise ValueError('the chunk plan does not fit its patterns')
    if not 1 <= chunk.n_limbs <= 3:
        raise ValueError(f'n_limbs must be 1..3, got {chunk.n_limbs}')
    if dev.type == 'cpu':
        if not _work_is_whole(chunk):
            return _count_work_plain(counts, chunk)
        lo = 0
        for part in chunk.parts:
            offs = chunk.offs[lo:lo + part + 1]
            occupancy_count_plain(counts, chunk.gids[offs[0]:offs[-1]],
                                  offs - offs[0],
                                  chunk.weights[lo:lo + part], row0=row0)
            lo += part
        return counts
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    # Scratch occupancy, n x k bytes, unless the kernel builds it.
    occ = (None if chunk.from_coo else
           torch.empty((n, nkb * K1_KBLOCK), dtype=torch.uint8, device=dev))
    lib = cuda.library('occupancy', _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.k1_count_chunk(
            cuda.ptr(chunk.gids), cuda.ptr(chunk.offs), ng,
            cuda.ptr(chunk.wbytes), cuda.ptr(chunk.kb_limbs), nkb,
            cuda.ptr(chunk.work), chunk.work.shape[0], int(chunk.split > 1),
            chunk.n_limbs, int(chunk.from_coo),
            None if occ is None else cuda.ptr(occ), n, row0, rows,
            int(chunk.window is None), cuda.ptr(counts), cuda.stream(counts))
    cuda.check(lib, rc, 'k1_count_chunk')
    occupancy_count.launches += 1
    return counts


occupancy_count.launches = 0


def _counts_from_index_host(index: 'PrefilterIndex') -> np.ndarray:
    """Host accumulation of pair counts from the pattern COO — exact, used
    for corpora too small to be worth a device pass."""
    n = index.n
    counts = np.zeros((n, n), dtype=np.int64)
    off = 0
    for ln, w in zip(index.lens, index.weights):
        g = index.gids[off:off + ln]
        counts[np.ix_(g, g)] += w
        off += ln
    np.fill_diagonal(counts, index.sizes)
    return counts


def _n_limbs(weights: np.ndarray) -> int:
    """Bytes of the largest weight. (The JAX package's rule,
    ceil(log2(w_max) / 8), is one byte short when w_max is exactly 2^8 or
    2^16, and then drops those patterns' top byte; this count is not.)"""
    return max(1, (int(weights.max(initial=1)).bit_length() + 7) // 8)


def _weight_bytes(weights) -> np.ndarray:
    """Byte count (1..3) of each weight below 2^24."""
    w = np.asarray(weights, np.int64)
    return (1 + (w > 0xFF) + (w > 0xFFFF)).astype(np.int32)


def k1_limb_plan(weights):
    """K1's limb arrays for one chunk whose patterns are in weight-byte
    order: wbytes (nkb, 3, 128) uint8, byte l of each pattern's weight by
    128-pattern k-block (0 past the chunk's end), and kb_limbs (nkb) int32,
    the largest byte count in each k-block: the limb products it issues."""
    ng = len(weights)
    nkb = -(-ng // K1_KBLOCK)
    w = np.zeros(nkb * K1_KBLOCK, np.int64)
    w[:ng] = weights
    nb = np.zeros(nkb * K1_KBLOCK, np.int32)
    nb[:ng] = _weight_bytes(weights)
    w = w.reshape(nkb, K1_KBLOCK)
    wbytes = np.stack([(w >> (8 * l)) & 0xFF for l in range(3)], axis=1)
    return (wbytes.astype(np.uint8),
            nb.reshape(nkb, K1_KBLOCK).max(axis=1).astype(np.int32))


def k1_tiles(n: int) -> np.ndarray:
    """K1's output tiles (ti, tj), ti <= tj, of an n x n count: the tiles on
    or above the diagonal, in bands of _K1_BAND tile rows, column by column
    within a band, so that the tiles in flight at once share operands."""
    nt = -(-n // K1_TILE)
    ti, tj = np.triu_indices(nt)
    return _band_order(ti, tj)


def k1_panel_tiles(row0: int, rows: int, n: int) -> np.ndarray:
    """K1's output tiles (ti, tj) of the (rows x n) window of genome rows
    [row0, row0 + rows), row0 a multiple of 128: every tile of its row band,
    in k1_tiles's band order."""
    nt = -(-n // K1_TILE)
    ti, tj = np.meshgrid(np.arange(row0 // K1_TILE,
                                   -(-(row0 + rows) // K1_TILE)),
                         np.arange(nt), indexing='ij')
    return _band_order(ti.ravel(), tj.ravel())


def _band_order(ti, tj) -> np.ndarray:
    order = np.lexsort((ti, tj, ti // _K1_BAND))
    return np.stack([ti[order], tj[order]], axis=1)


def k1_work(tiles: np.ndarray, kb_limbs: np.ndarray, n_sms: int):
    """K1's work list: (items, 4) int32 rows (ti, tj, kb_lo, kb_hi), one
    CTA each, and the split factor. When the tiles are fewer than the SMs,
    each tile's k-blocks are cut into contiguous ranges of about equal limb
    products (split-K), enough of them to give every SM a CTA, and the
    kernel adds with atomics."""
    nkb = len(kb_limbs)
    split = (1 if len(tiles) >= n_sms
             else min(nkb, -(-n_sms // len(tiles))))
    if split == nkb:
        bounds = np.arange(nkb + 1)
    else:
        cum = np.cumsum(kb_limbs)
        cuts = np.searchsorted(cum, cum[-1] * np.arange(1, split) / split) + 1
        bounds = np.unique(np.concatenate([[0], np.clip(cuts, 1, nkb - 1),
                                           [nkb]]))
    lo, hi = bounds[:-1], bounds[1:]
    work = np.column_stack([np.repeat(tiles, len(lo), axis=0),
                            np.tile(lo, len(tiles)), np.tile(hi, len(tiles))])
    return work.astype(np.int32), len(lo)


def k1_from_coo(work: np.ndarray, nnz: int) -> bool:
    """Whether K1 builds a chunk's occupancy in shared memory from the COO:
    when every CTA walks at most _K1_COO_KBLOCKS k-blocks (the build runs
    a k-block at a time on the producer warpgroup, latency-bound) and the
    COO, read once per tile, stays small. Else a memset and a scatter
    build it in device memory for TMA."""
    n_tiles = len(np.unique(work[:, :2], axis=0))
    return (int((work[:, 3] - work[:, 2]).max()) <= _K1_COO_KBLOCKS
            and n_tiles * nnz <= _K1_COO_READS)


def device_chunks(index: 'PrefilterIndex', device, rows_chunk: int = 131072,
                  nnz_chunk: int = 524288, shards: int = 1):
    """The index's chunks as K1 inputs on `device` (`k1_passes`), with the
    JAX package's rows_chunk cap of its indexed count. Returns (n_limbs,
    [K1Chunk, ...]), one K1Chunk a pass, n_limbs the index's largest weight
    byte count."""
    n = index.n
    rows_chunk = max(1024, min(rows_chunk, (1 << 28) // (4 * (n + 1))))
    rows_chunk, nnz_chunk = _adapt_chunks(index.gids, index.lens, n,
                                          rows_chunk, nnz_chunk)
    return _n_limbs(index.weights), k1_passes(
        n, index.gids, index.lens, index.weights, device, rows_chunk,
        nnz_chunk, shards=shards)


def k1_passes(n: int, sg, shared_lens, weights, device, rows_chunk: int,
              nnz_chunk: int, window=None, shards: int = 1):
    """K1 passes on `device` for the pattern COO (sg, shared_lens) of n
    genomes and the patterns' weights: chunked as the JAX package chunks it
    (`_chunk_groups`; rows_chunk and nnz_chunk already capped and fitted
    to the data as the caller's JAX function does), each chunk's patterns
    reordered by the byte count of their weight (integer sums do not
    depend on order),
    consecutive chunks merged into passes (`_k1_passes`), each pass with
    K1's plan (`k1_limb_plan`, and `k1_work` for this device's SMs times
    `shards`, the mesh shards that will share the list; for the CPU an
    H100's). window: None for the n x n count, or (row0, rows) for the
    rows x n window of genome rows [row0, row0 + rows) (`k1_panel_tiles`).
    Returns [K1Chunk, ...], one a pass."""
    device = torch.device(device)
    assert nnz_chunk >= n, 'nnz_chunk must be >= number of genomes'
    if not len(shared_lens):
        return []
    assert weights.max(initial=0) < (1 << 24), 'pattern weight overflow'
    cum, chunks = _chunk_groups(shared_lens, rows_chunk, nnz_chunk)
    # Weight-byte order inside each chunk (chunks are contiguous, in order).
    sizes = [g_hi - g_lo for g_lo, g_hi in chunks]
    order = np.lexsort((_weight_bytes(weights),
                        np.repeat(np.arange(len(chunks)), sizes)))
    lens = np.asarray(shared_lens, np.int64)[order]
    weights = np.asarray(weights)[order]
    starts = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    gather = np.repeat(cum[:-1][order] - starts, lens) + np.arange(cum[-1])
    sg = np.asarray(sg)[gather]
    cum = np.append(starts, cum[-1])   # chunk bounds stay where they were

    n_sms = (torch.cuda.get_device_properties(device).multi_processor_count
             if device.type == 'cuda' else _H100_SMS)
    tiles = k1_tiles(n) if window is None else k1_panel_tiles(*window, n)
    passes = [(p[0][0], p[-1][1], tuple(hi - lo for lo, hi in p))
              for p in _k1_passes(n, chunks)]
    plans = []
    for g_lo, g_hi, _ in passes:
        wbytes, kb_limbs = k1_limb_plan(weights[g_lo:g_hi])
        work, split = k1_work(tiles, kb_limbs, n_sms * shards)
        plans.append((wbytes, kb_limbs, work, split,
                      k1_from_coo(work, int(cum[g_hi] - cum[g_lo]))))

    def upload(parts, dtype):
        return torch.from_numpy(np.ascontiguousarray(
            np.concatenate(parts), dtype)).to(device)

    gids_d = upload([sg], np.int32)
    w_d = upload([weights], np.int32)
    offs_d = upload([cum[g_lo:g_hi + 1] - cum[g_lo]
                     for g_lo, g_hi, _ in passes], np.int32)
    wb_d = upload([p[0] for p in plans], np.uint8)
    kbl_d = upload([p[1] for p in plans], np.int32)
    work_d = upload([p[2] for p in plans], np.int32)
    out, o, kb, it = [], 0, 0, 0
    for (g_lo, g_hi, parts), (_, kb_limbs, work, split, from_coo) in zip(
            passes, plans):
        ng, nkb = g_hi - g_lo, len(kb_limbs)
        out.append(K1Chunk(
            n, parts, gids_d[int(cum[g_lo]):int(cum[g_hi])],
            offs_d[o:o + ng + 1], w_d[g_lo:g_hi], wb_d[kb:kb + nkb],
            kbl_d[kb:kb + nkb], work_d[it:it + len(work)],
            int(kb_limbs.max()), split, from_coo, window))
        o, kb, it = o + ng + 1, kb + nkb, it + len(work)
    return out


def k1_split_work(work: np.ndarray, kb_limbs: np.ndarray, parts: int):
    """K1's work list cut into `parts` contiguous runs of about equal limb
    products (a run may be empty), one a mesh shard."""
    cum = np.concatenate([[0], np.cumsum(kb_limbs, dtype=np.int64)])
    prefix = np.concatenate([[0], np.cumsum(cum[work[:, 3]]
                                            - cum[work[:, 2]])])
    target = prefix[-1] * np.arange(1, parts) / parts
    hi = np.searchsorted(prefix, target).clip(1, len(prefix) - 1)
    cut = np.where(target - prefix[hi - 1] < prefix[hi] - target, hi - 1, hi)
    bounds = np.concatenate([[0], np.maximum.accumulate(cut), [len(work)]])
    return [work[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]


def k1_shard(chunk: K1Chunk, work: np.ndarray, device) -> K1Chunk:
    """A pass on `device` with the part `work` of its work list: split
    counts the items of its most divided tile (atomic adds when above 1),
    and the occupancy build is decided for this part."""
    _, per_tile = np.unique(work[:, :2], axis=0, return_counts=True)
    return chunk._replace(
        **{f: getattr(chunk, f).to(device)
           for f in ('gids', 'offs', 'weights', 'wbytes', 'kb_limbs')},
        work=torch.from_numpy(np.ascontiguousarray(work, np.int32)).to(
            device),
        split=int(per_tile.max()),
        from_coo=k1_from_coo(work, int(chunk.gids.numel())))


def _k1_passes(n: int, chunks):
    """Runs of consecutive chunks whose occupancy (n x their patterns,
    rounded up to k-blocks) fits _K1_PASS_BYTES together; a chunk that
    does not fit alone is a pass of its own."""
    passes = [[chunks[0]]]
    for lo, hi in chunks[1:]:
        kb = -(-(hi - passes[-1][0][0]) // K1_KBLOCK)
        if n * kb * K1_KBLOCK <= _K1_PASS_BYTES:
            passes[-1].append((lo, hi))
        else:
            passes.append([(lo, hi)])
    return passes


def shared_kmer_counts_indexed(index: 'PrefilterIndex',
                               rows_chunk: int = 131072,
                               nnz_chunk: int = 524288,
                               engine: str = 'auto',
                               device=None, mesh=None) -> np.ndarray:
    """Exact pair counts from a PrefilterIndex (the kmer-db all2all-sp
    analog) with K1, chunk by chunk, over `mesh` (parallel/mesh.py), or
    without one on `device` (default cuda, see utils/device), a mesh of one
    shard. Each pass's work list is cut among the mesh's shards
    (`k1_split_work`); the shards of a device add their parts into one
    n x n counts there, the other devices' counts are added into the first
    device's, and that is summed over the processes of the mesh's group on
    the host (the shards' tiles and k-blocks are disjoint, so the sum is
    the count). engine='auto' answers corpora of <= 32 genomes on
    the host without a mesh, as the JAX package does; engine='device'
    always counts on the device. Returns an int64 (n, n) matrix whose
    diagonal is the k-mer-set sizes."""
    n = index.n
    if n == 0:
        return np.zeros((0, 0), dtype=np.int64)
    if mesh is None:
        dev = resolve_device(device)
        if engine == 'auto' and n <= _HOST_MAX_GENOMES:
            return _counts_from_index_host(index)
        mesh = make_mesh(device=dev)
    shards, n_shards = local_shards(mesh)
    _, chunks = device_chunks(index, shards[0][1], rows_chunk, nnz_chunk,
                              shards=n_shards)
    parts = [k1_split_work(c.work.cpu().numpy(), c.kb_limbs.cpu().numpy(),
                           n_shards) for c in chunks]
    runs = [(dev, [k1_shard(c, p[s], dev) for c, p in zip(chunks, parts)
                   if len(p[s])]) for s, dev in shards]
    sums = {}
    for dev, sub in runs:       # every launch first, then the sums
        counts = sums.get(dev)
        if counts is None:
            counts = sums[dev] = torch.zeros((n, n), dtype=torch.int32,
                                             device=dev)
        for chunk in sub:
            occupancy_count(counts, chunk)
    first, *others = sums.values()
    for counts in others:
        first += counts.to(first.device)
    out = reduce_sum(mesh, first.cpu().numpy().astype(np.int64))
    np.fill_diagonal(out, index.sizes)
    return out


def shared_kmer_counts_device(kmer_sets, rows_chunk: int = 131072,
                              nnz_chunk: int = 524288,
                              device=None) -> np.ndarray:
    """Exact pairwise shared-k-mer counts for sorted distinct uint64 sets,
    without the pattern index (the JAX package's unweighted
    `shared_kmer_counts_device`): the host groups the (k-mer, genome)
    incidence by k-mer and drops singleton groups (`_group_coo`), and K1
    counts the groups at weight 1 on `device` (default cuda), chunked as
    the JAX package chunks them. Returns an int64 (n, n) matrix whose
    diagonal is the set sizes."""
    dev = resolve_device(device)
    n = len(kmer_sets)
    if n == 0:
        return np.zeros((0, 0), dtype=np.int64)
    counts = torch.zeros((n, n), dtype=torch.int32, device=dev)
    for chunk in unweighted_passes(kmer_sets, dev, rows_chunk, nnz_chunk):
        occupancy_count(counts, chunk)
    out = counts.cpu().numpy().astype(np.int64)
    np.fill_diagonal(out, [len(s) for s in kmer_sets])
    return out


def unweighted_passes(kmer_sets, device, rows_chunk: int = 131072,
                      nnz_chunk: int = 524288):
    """`shared_kmer_counts_device`'s K1 passes on `device`: the k-mer
    groups of >= 2 genomes (`_group_coo`) at weight 1, with the JAX
    package's rows_chunk cap of that function (its occupancy block, rows x
    (n + 1) bf16, at ~1 GiB)."""
    n = len(kmer_sets)
    sg, shared_lens = _group_coo(kmer_sets)
    rows_chunk = max(1024, min(rows_chunk, (1 << 30) // (2 * (n + 1))))
    rows_chunk, nnz_chunk = _adapt_chunks(sg, shared_lens, n, rows_chunk,
                                          nnz_chunk)
    return k1_passes(n, sg, shared_lens, np.ones(len(shared_lens), np.int64),
                     device, rows_chunk, nnz_chunk)


def shared_kmer_counts_panels(kmer_sets, panel: int = 4096,
                              rows_chunk: int = 131072,
                              nnz_chunk: int = 524288, device=None):
    """Stream the pair-count matrix in row panels of `panel` genomes (the
    JAX package's `shared_kmer_counts_panels`, the out-of-core analog of
    kmer-db's `--batch-size`/`all2all-parts`, reference vclust.py:1404-1462):
    the device holds a (panel x n) block, never n x n. Each panel keeps the
    k-mer groups with a member in it and counts them at weight 1 with K1 in
    window mode on `device` (default cuda), over the panel's rows rounded
    out to 128 (the window), then sliced.

    Yields (lo, hi, counts_block) with counts_block int64 of shape
    (hi-lo, n); diagonal entries are set to the genome's k-mer-set size."""
    dev = resolve_device(device)
    n = len(kmer_sets)
    if n == 0:
        return
    sizes = np.array([len(s) for s in kmer_sets], dtype=np.int64)
    sg, shared_lens = _group_coo(kmer_sets)
    panel = min(panel, n)
    rows_chunk = max(
        1024, min(rows_chunk, (1 << 30) // (2 * (n + panel + 2))))
    rows_chunk, nnz_chunk = _adapt_chunks(sg, shared_lens, n, rows_chunk,
                                          nnz_chunk)
    n_groups = len(shared_lens)
    group_of_entry = np.repeat(np.arange(n_groups, dtype=np.int64),
                               shared_lens)
    for lo in range(0, n, panel):
        hi = min(lo + panel, n)
        row0 = lo // K1_TILE * K1_TILE
        rows = min(-(-hi // K1_TILE) * K1_TILE, n) - row0
        counts = torch.zeros((rows, n), dtype=torch.int32, device=dev)
        # Keep only groups with >= 1 member in [lo, hi): others cannot
        # touch this row panel.
        touched = np.zeros(n_groups, dtype=bool)
        touched[group_of_entry[(sg >= lo) & (sg < hi)]] = True
        lens_sel = shared_lens[touched]
        for chunk in k1_passes(n, sg[touched[group_of_entry]], lens_sel,
                               np.ones(len(lens_sel), np.int64), dev,
                               rows_chunk, nnz_chunk, window=(row0, rows)):
            occupancy_count(counts, chunk)
        block = counts[lo - row0:hi - row0].cpu().numpy().astype(np.int64)
        block[np.arange(hi - lo), np.arange(lo, hi)] = sizes[lo:hi]
        yield lo, hi, block


def _adapt_chunks(sg, shared_lens, n, rows_chunk, nnz_chunk):
    """Shrink chunk buffers to the data (pow2-bucketed, as the JAX package
    does, so the chunks match its one to one)."""
    nnz_total = max(int(len(sg)), n + 1, 1024)
    nnz_chunk = min(nnz_chunk, 1 << int(np.ceil(np.log2(nnz_total))))
    ng = max(int(len(shared_lens)), 1024)
    rows_chunk = min(rows_chunk, 1 << int(np.ceil(np.log2(ng))))
    return rows_chunk, nnz_chunk


def _chunk_groups(shared_lens, rows_chunk, nnz_chunk):
    """Cut groups into chunks of <= rows_chunk groups and <= nnz_chunk
    entries; returns (cum_entry_offsets, [(g_lo, g_hi), ...])."""
    n_groups = len(shared_lens)
    cum = np.concatenate([[0], np.cumsum(shared_lens, dtype=np.int64)])
    chunks = []
    g = 0
    while g < n_groups:
        g_end = min(g + rows_chunk, n_groups)
        g_end = min(g_end, int(np.searchsorted(
            cum, cum[g] + nnz_chunk, side='right')) - 1)
        assert g_end > g, 'group larger than nnz_chunk'
        chunks.append((g, g_end))
        g = g_end
    return cum, chunks


def shared_kmer_counts_host(kmer_sets) -> np.ndarray:
    """Numpy reference implementation (sort-merge intersections)."""
    n = len(kmer_sets)
    counts = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        counts[i, i] = len(kmer_sets[i])
        for j in range(i):
            counts[i, j] = counts[j, i] = len(
                np.intersect1d(kmer_sets[i], kmer_sets[j],
                               assume_unique=True))
    return counts


def shared_kmer_counts(kmer_sets, backend: str = 'auto', device=None,
                       mesh=None) -> np.ndarray:
    """Pair counts of per-genome sorted k-mer sets. backend='host' is the
    sort-merge on the host; 'auto' takes it too for <= 32 genomes, as the
    JAX package does, and otherwise counts with K1 on `device`, or over
    `mesh`."""
    if backend == 'host':
        return shared_kmer_counts_host(kmer_sets)
    dev = resolve_device(device) if mesh is None else None
    if backend == 'auto' and len(kmer_sets) <= _HOST_MAX_GENOMES:
        return shared_kmer_counts_host(kmer_sets)
    return shared_kmer_counts_indexed(PrefilterIndex(kmer_sets), device=dev,
                                      mesh=mesh)


def ani_shorter(counts: np.ndarray, sizes: np.ndarray, k: int,
                row_sizes: np.ndarray = None) -> np.ndarray:
    """kmer-db's `ani-shorter` estimate from shared-k-mer counts.

    [VERIFIED-EMPIRICAL in SURVEY.md section 2.4.5 against golden fltr.txt]:
        c = shared / min(|A|, |B|)            (containment on the shorter)
        ani_shorter = 1 + ln(2c / (1 + c)) / k

    counts may be the square (n, n) matrix (row_sizes=None) or a row-panel
    block (B, n) with row_sizes the B per-row k-mer-set sizes.
    """
    sizes = np.asarray(sizes, dtype=np.float64)
    rs = sizes if row_sizes is None else np.asarray(row_sizes, np.float64)
    min_sizes = np.minimum(rs[:, None], sizes[None, :])
    with np.errstate(divide='ignore', invalid='ignore'):
        c = counts / np.maximum(min_sizes, 1)
        s = 1.0 + np.log(2.0 * c / (1.0 + c)) / k
    s[counts == 0] = -np.inf
    return s
