"""Prefilter stage: all-vs-all shared-k-mer counting -> candidate pairs.

Replaces the kmer-db build/all2all/distance chain (reference
vclust.py:915-1055,1380-1471). One in-process stage: canonical k-mer sets per
genome (core/kmers.py), exact pairwise shared counts via the device
occupancy count (ops/prefilter.py, kernel K1), double filtering (count >= min_kmers AND
ani_shorter >= min_ident), optional per-row top-M capping (--max-seqs), and
the fltr.txt writer (io/formats.py).

`batch_size` selects the out-of-core row-panel mode (the reference's
`--batch-size`/`all2all-parts`, vclust.py:1404-1462): the pair-count matrix
is counted block by block through the persisted batch store, so device
memory holds one (batch x batch) block instead of the dense (n x n) matrix.
Results are identical by construction since counting is over the same
merged sets either way. Device work runs on `device` (default cuda, see
utils/device), or over a `mesh` the caller passes (parallel/mesh.py;
the CLI passes none, and the module says why); backend='host' counts on
the host and needs no device.
"""

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from ..core.kmers import canonical_kmer_set
from ..core.seq import encode
from ..io.formats import FilterMatrix
from ..ops.prefilter import ani_shorter, shared_kmer_counts
from ..utils.device import resolve_device
from ..utils.logging import get_logger
from .input import Genome

# Above this genome count the dense (n, n) device matrix is streamed in row
# panels even without an explicit --batch-size.
_AUTO_PANEL_THRESHOLD = 16384
_AUTO_PANEL = 8192


def genome_kmer_set(genome: Genome, k: int, fraction: float) -> np.ndarray:
    if len(genome.seqs) == 1:
        return canonical_kmer_set(genome.seqs[0], k, fraction)
    parts = [canonical_kmer_set(s, k, fraction) for s in genome.seqs]
    return np.unique(np.concatenate(parts)) if parts else np.empty(
        0, np.uint64)


def build_kmer_sets(genomes: List[Genome], k: int, fraction: float,
                    num_threads: Optional[int] = None) -> List[np.ndarray]:
    """Per-genome canonical k-mer sets; numpy extraction releases the GIL
    enough that a thread pool helps (the kmer-db `build -t` analog)."""
    if num_threads and num_threads > 1 and len(genomes) > 8:
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            return list(pool.map(
                lambda g: genome_kmer_set(g, k, fraction), genomes))
    return [genome_kmer_set(g, k, fraction) for g in genomes]


def _block_entries(block, sim, lo, hi, min_kmers, min_ident):
    """Lower-triangle (i, j, sim) entries of one row panel passing both
    filters, fully vectorized."""
    rows_local, cols = np.nonzero(
        (block >= min_kmers) & (sim >= min_ident)
        & (np.arange(block.shape[1])[None, :]
           < np.arange(lo, hi)[:, None]))
    return rows_local + lo, cols, sim[rows_local, cols]


def _batched_entries(genomes, kmer_sets, sizes, k, bsz, min_kmers,
                     min_ident, device, mesh=None):
    """Out-of-core blockwise counting through the persisted batch store
    (the kmer-db `--batch-size`/`all2all-parts` analog, reference
    vclust.py:1404-1462): per-batch artifacts on disk, one (batch_i,
    batch_j) counts block in RAM at a time, each block O(nnz_i + nnz_j).

    kmer_sets entries are released batch-by-batch as they are persisted,
    so peak host RAM is O(two batches), not O(corpus).
    """
    import tempfile
    from ..ops.prefilter import BatchIndexStore, ani_shorter as _ani
    n = len(kmer_sets)
    with tempfile.TemporaryDirectory(prefix='vclust_kdb_') as tmp:
        store = BatchIndexStore(tmp)
        for lo in range(0, n, bsz):
            store.add_batch(kmer_sets[lo:lo + bsz], lo)
            kmer_sets[lo:lo + bsz] = [None] * min(bsz, n - lo)
        nb = len(store.batches)
        for i in range(nb):
            off_i, n_i = store.batches[i]
            for j in range(i, nb):
                off_j, n_j = store.batches[j]
                ro, co, block = store.pair_block(i, j, device=device,
                                                 mesh=mesh)
                col_sizes = sizes[co:co + block.shape[1]]
                row_sizes = sizes[ro:ro + block.shape[0]]
                sim = _ani(block, col_sizes, k, row_sizes=row_sizes)
                if i == j:
                    rl, cl = np.nonzero(
                        (block >= min_kmers) & (sim >= min_ident)
                        & (np.arange(block.shape[1])[None, :]
                           < np.arange(block.shape[0])[:, None]))
                    yield rl + ro, cl + co, sim[rl, cl]
                else:
                    rl, cl = np.nonzero(
                        (block >= min_kmers) & (sim >= min_ident))
                    # global pair = (larger id, smaller id)
                    yield cl + co, rl + ro, sim[rl, cl]


def run_prefilter(
    genomes: List[Genome],
    k: int = 25,
    min_kmers: int = 20,
    min_ident: float = 0.7,
    kmers_fraction: float = 1.0,
    max_seqs: int = 0,
    batch_size: int = 0,
    backend: str = 'auto',
    num_threads: Optional[int] = None,
    device=None,
    mesh=None,
) -> FilterMatrix:
    """The prefilter stage over `genomes`. Counts on `device`, or over
    `mesh` (parallel/mesh.py)."""
    logger = get_logger()
    if backend == 'host':
        device = mesh = None
    elif mesh is None:
        device = resolve_device(device)
    names = [g.name for g in genomes]
    n = len(genomes)
    logger.info(f'Building canonical {k}-mer sets for {n} genomes')
    kmer_sets = build_kmer_sets(genomes, k, kmers_fraction, num_threads)
    sizes = np.array([len(s) for s in kmer_sets], dtype=np.int64)
    logger.info('Counting shared k-mers (occupancy matmul)')

    if mesh is not None:
        logger.info(f'Counting over a {len(mesh.devices)}-device mesh')
    use_batches = (backend != 'host'
                   and (batch_size > 0 or n > _AUTO_PANEL_THRESHOLD))
    all_i, all_j, all_v = [], [], []
    if use_batches:
        bsz = batch_size if batch_size > 0 else _AUTO_PANEL
        for ri, cj, v in _batched_entries(genomes, kmer_sets, sizes, k, bsz,
                                          min_kmers, min_ident, device, mesh):
            all_i.append(ri)
            all_j.append(cj)
            all_v.append(v)
    else:
        counts = shared_kmer_counts(kmer_sets, backend=backend, device=device,
                                    mesh=mesh)
        sim = ani_shorter(counts, sizes, k)
        ri, cj, v = _block_entries(counts, sim, 0, n, min_kmers, min_ident)
        all_i.append(ri)
        all_j.append(cj)
        all_v.append(v)

    rows = np.concatenate(all_i) if all_i else np.empty(0, np.int64)
    cols = np.concatenate(all_j) if all_j else np.empty(0, np.int64)
    vals = np.concatenate(all_v) if all_v else np.empty(0, np.float64)

    if max_seqs and max_seqs > 0 and len(rows):
        # kmer-db `-sample-rows ani-shorter:M`: keep the M best entries per
        # row by similarity (reference vclust.py:249-259,1015-1016).
        # One lexsort by (row, -val, col) then a per-row running rank via
        # segment arithmetic — O(nnz log nnz), no per-row scans.
        order = np.lexsort((cols, -vals, rows))
        r_sorted = rows[order]
        first = np.empty(len(order), dtype=bool)
        first[0] = True
        np.not_equal(r_sorted[1:], r_sorted[:-1], out=first[1:])
        seg_start = np.maximum.accumulate(
            np.where(first, np.arange(len(order)), 0))
        rank_in_row = np.arange(len(order)) - seg_start
        keep_sorted = rank_in_row < max_seqs
        keep = np.zeros(len(rows), dtype=bool)
        keep[order] = keep_sorted
        rows, cols, vals = rows[keep], cols[keep], vals[keep]

    m = FilterMatrix(kmer_length=k, fraction=kmers_fraction, names=names)
    order = np.lexsort((cols, rows))
    for t in order:
        m.entries[(int(rows[t]), int(cols[t]))] = float(vals[t])
    logger.info(f'Prefilter kept {len(rows)} candidate pairs')
    return m
