"""Shared-k-mer counting as an exact weighted occupancy count on the device.

The port of the JAX package's ops/prefilter.py on one device (no mesh).
The host builds kmer-db's pattern-compressed incidence index (reference
contract vclust.py:915-1055; SURVEY.md section 2.4): per distinct genome
set ("pattern") of the k-mers shared by >= 2 genomes, its genome ids and
its multiplicity weight. The device turns it into exact pair counts,
chunk by chunk, with kernel K1 (csrc/occupancy.cu):

    counts[i, j] += sum_r occ[r, i] * w[r] * occ[r, j]

over a {0,1} (patterns x genomes) occupancy, accumulated in int32. The
chunking is the JAX package's (`_adapt_chunks`, `_chunk_groups` and the
rows_chunk cap), so chunks match one to one, and the result equals its
rint(f32) counts bit for bit.

`occupancy_count` is K1's wrapper: CPU tensors take
`occupancy_count_plain` (the scatter and a float64 product, exact for
integers below 2^53), CUDA tensors launch the kernel or raise.
`occupancy_count.launches` counts kernel launches.
"""

import ctypes
import pathlib

import numpy as np
import torch

from . import cuda
from ..utils.device import resolve_device

# Corpora of at most this many genomes are counted on the host when the
# engine/backend is 'auto', as in the JAX package.
_HOST_MAX_GENOMES = 32

_SIGNATURES = {
    'k1_count_chunk': [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                               ctypes.c_int64, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p,
                                               ctypes.c_void_p],
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

    def pair_block(self, i: int, j: int, device=None):
        """Exact shared-k-mer counts between batches i and j (i <= j).

        Returns (rows_offset, cols_offset, counts) where counts is the
        (n_i, n_j) int64 block (full square block for i == j).
        """
        ki, gi, szi = self._load(i)
        off_i, n_i = self.batches[i]
        if i == j:
            local = gi - off_i
            idx = PrefilterIndex.from_coo(np.asarray(ki), local, szi)
            counts = shared_kmer_counts_indexed(idx, device=device)
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
        counts = shared_kmer_counts_indexed(idx, device=device)
        return off_i, off_j, counts[:n_i, n_i:]


def occupancy_count_plain(counts, gids, offs, weights, n_limbs=None):
    """Plain torch version of K1 on any device: scatter the chunk's {0,1}
    (patterns x genomes) occupancy and add occ^T (w occ) in float64, which
    is exact for integer sums below 2^53. Updates counts in place."""
    n = counts.shape[0]
    ng = offs.numel() - 1
    sizes = (offs[1:] - offs[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(ng, device=counts.device), sizes)
    occ = torch.zeros((ng, n), dtype=torch.float64, device=counts.device)
    occ[rows, gids.long()] = 1.0
    prod = occ.T @ (occ * weights.to(torch.float64)[:, None])
    counts += torch.round(prod).to(counts.dtype)
    return counts


def occupancy_count(counts, gids, offs, weights, n_limbs: int):
    """K1 wrapper, one chunk: counts (n, n) int32 += occ^T diag(w) occ for
    the chunk's patterns r, whose genome ids are gids[offs[r]:offs[r+1]]
    (ids in [0, n); offs int32 starting at 0); weights int32 below 2^24
    with at most n_limbs bytes (1..3). CPU tensors take the plain version,
    CUDA tensors the kernel (or raise). Updates counts in place."""
    dev = counts.device
    cuda.require(counts, 'counts', torch.int32, 2, dev)
    for name, x in (('gids', gids), ('offs', offs), ('weights', weights)):
        cuda.require(x, name, torch.int32, 1, dev)
    n = counts.shape[0]
    ng = offs.numel() - 1
    if counts.shape != (n, n):
        raise ValueError(f'counts must be square, got {tuple(counts.shape)}')
    if weights.numel() != ng or ng < 1:
        raise ValueError('weights must hold one entry per pattern (>= 1)')
    if not 1 <= n_limbs <= 3:
        raise ValueError(f'n_limbs must be 1..3, got {n_limbs}')
    if dev.type == 'cpu':
        return occupancy_count_plain(counts, gids, offs, weights)
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    n_pad = -(-n // 64) * 64
    ld = -(-ng // 32) * 32
    occ = torch.empty((n_pad, ld), dtype=torch.uint8, device=dev)
    lib = cuda.library('occupancy', _SIGNATURES)
    rc = lib.k1_count_chunk(cuda.ptr(gids), cuda.ptr(offs), cuda.ptr(weights),
                            ng, cuda.ptr(occ), ld, n, n_pad, n_limbs,
                            cuda.ptr(counts), cuda.stream(counts))
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


def device_chunks(index: 'PrefilterIndex', device, rows_chunk: int = 131072,
                  nnz_chunk: int = 524288):
    """The index's chunks as K1 inputs on `device`, chunked as the JAX
    package chunks it. Returns (n_limbs, [(gids, offs, weights), ...])."""
    n = index.n
    sg, shared_lens, weights = index.gids, index.lens, index.weights
    rows_chunk = max(1024, min(rows_chunk, (1 << 28) // (4 * (n + 1))))
    rows_chunk, nnz_chunk = _adapt_chunks(sg, shared_lens, n, rows_chunk,
                                          nnz_chunk)
    assert nnz_chunk >= n, 'nnz_chunk must be >= number of genomes'
    if not len(shared_lens):
        return 1, []
    assert weights.max(initial=0) < (1 << 24), 'pattern weight overflow'
    cum, chunks = _chunk_groups(shared_lens, rows_chunk, nnz_chunk)
    gids_d = torch.from_numpy(np.ascontiguousarray(sg, np.int32)).to(device)
    w_d = torch.from_numpy(weights.astype(np.int32)).to(device)
    offs_all = np.concatenate([cum[g_lo:g_hi + 1] - cum[g_lo]
                               for g_lo, g_hi in chunks]).astype(np.int32)
    offs_d = torch.from_numpy(offs_all).to(device)
    out, o = [], 0
    for g_lo, g_hi in chunks:
        ng = g_hi - g_lo
        out.append((gids_d[int(cum[g_lo]):int(cum[g_hi])],
                    offs_d[o:o + ng + 1], w_d[g_lo:g_hi]))
        o += ng + 1
    return _n_limbs(weights), out


def shared_kmer_counts_indexed(index: 'PrefilterIndex',
                               rows_chunk: int = 131072,
                               nnz_chunk: int = 524288,
                               engine: str = 'auto',
                               device=None) -> np.ndarray:
    """Exact pair counts from a PrefilterIndex (the kmer-db all2all-sp
    analog) with K1, chunk by chunk, on `device` (default cuda, see
    utils/device). engine='auto' answers corpora of <= 32 genomes on the
    host, as the JAX package does; engine='device' always counts on the
    device. Returns an int64 (n, n) matrix whose diagonal is the k-mer-set
    sizes."""
    dev = resolve_device(device)
    n = index.n
    if n == 0:
        return np.zeros((0, 0), dtype=np.int64)
    if engine == 'auto' and n <= _HOST_MAX_GENOMES:
        return _counts_from_index_host(index)
    n_limbs, chunks = device_chunks(index, dev, rows_chunk, nnz_chunk)
    counts = torch.zeros((n, n), dtype=torch.int32, device=dev)
    for gids, offs, weights in chunks:
        occupancy_count(counts, gids, offs, weights, n_limbs)
    out = counts.cpu().numpy().astype(np.int64)
    np.fill_diagonal(out, index.sizes)
    return out


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


def shared_kmer_counts(kmer_sets, backend: str = 'auto',
                       device=None) -> np.ndarray:
    """Pair counts of per-genome sorted k-mer sets. backend='host' is the
    sort-merge on the host; 'auto' takes it too for <= 32 genomes, as the
    JAX package does, and otherwise counts on `device` with K1."""
    if backend == 'host':
        return shared_kmer_counts_host(kmer_sets)
    dev = resolve_device(device)
    if backend == 'auto' and len(kmer_sets) <= _HOST_MAX_GENOMES:
        return shared_kmer_counts_host(kmer_sets)
    return shared_kmer_counts_indexed(PrefilterIndex(kmer_sets), device=dev)


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
