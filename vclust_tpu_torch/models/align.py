"""Align stage: all-vs-all (or prefiltered) LZ alignment -> ANI measures.

Replaces lz-ani (reference contract vclust.py:1058-1181; output semantics
verified empirically in SURVEY.md section 2.5.3 against the golden
example/output/ani.tsv):

- objects (ids table) sorted by total length descending, ties in input order;
- pair rows: for ids-order indices i < j emit (q=j, r=i) then (q=i, r=j) —
  shorter genome as query first; each direction parsed independently;
- ani  = sum(nt_match) / sum(alnlen)          over the direction's alignments
- gani = sum(nt_match) / qlen
- qcov = sum(alnlen) / qlen
- rcov = qcov of the opposite direction
- tani = (nt_match(q,r) + nt_match(r,q)) / (qlen + rlen)   (symmetric)
- len_ratio = min/max length; num_alns per direction;
- alignment rows sorted by alnlen descending within a directed pair.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.seq import encode
from ..io.formats import AniRow, AlnRow, FilterMatrix
from ..ops.lz_parse_py import AlignParams, Alignment, ReferenceIndex, parse_pair
from ..ops import lz_native
from ..utils.logging import get_logger
from .input import Genome

# Number of Ns used to join multi-contig genomes; wider than any anchor so no
# factor can span a contig boundary.
_CONTIG_JOIN = 64


@dataclass
class AlignResult:
    objects: List[Tuple[str, int, int]]          # (name, seq_len, no_parts)
    rows: List[AniRow] = field(default_factory=list)
    alignments: List[AlnRow] = field(default_factory=list)


@dataclass
class DirectedResult:
    n_alns: int = 0
    sum_match: int = 0
    sum_alnlen: int = 0
    alns: List[Alignment] = field(default_factory=list)


def order_objects(genomes: Sequence[Genome]) -> List[int]:
    """Indices of genomes in ids-table order (length desc, stable)."""
    lengths = [g.total_len for g in genomes]
    return sorted(range(len(genomes)), key=lambda i: (-lengths[i], i))


def _genome_codes(genome: Genome) -> np.ndarray:
    if len(genome.seqs) == 1:
        return encode(genome.seqs[0])
    gap = np.full(_CONTIG_JOIN, 4, dtype=np.int8)
    parts = []
    for idx, s in enumerate(genome.seqs):
        if idx:
            parts.append(gap)
        parts.append(encode(s))
    return np.concatenate(parts)


def align_directed(q_codes: np.ndarray, ref_index,
                   params: AlignParams) -> DirectedResult:
    if isinstance(ref_index, lz_native.NativeReferenceIndex):
        alns = lz_native.parse_pair_native(q_codes, ref_index, params)
    else:
        alns = parse_pair(q_codes, ref_index, params)
    res = DirectedResult(alns=alns)
    res.n_alns = len(alns)
    res.sum_match = sum(a.nt_match for a in alns)
    res.sum_alnlen = sum(a.alnlen for a in alns)
    return res


def run_align(
    genomes: Sequence[Genome],
    params: Optional[AlignParams] = None,
    filter_matrix: Optional[FilterMatrix] = None,
    filter_threshold: float = 0.0,
    out_filters: Optional[Dict[str, float]] = None,
    keep_alignments: bool = False,
    num_threads: Optional[int] = None,
    engine: str = 'auto',
) -> AlignResult:
    """Run the all-vs-all alignment over candidate pairs.

    engine: 'auto' (native C++ if available, else Python), 'native', 'py'
    (the host engines, bit-identical; the Python one is the semantic
    oracle), or 'gpu' ('tpu' is the same engine, the JAX package's name
    for it): the batched device engine (ops/align_gpu.py), on `cuda`
    unless VCLUST_TORCH_DEVICE asks for the CPU.
    """
    logger = get_logger()
    params = params or AlignParams()
    out_filters = out_filters or {}
    n = len(genomes)
    order = order_objects(genomes)
    objects = [(genomes[i].name, genomes[i].total_len, genomes[i].n_parts)
               for i in order]
    result = AlignResult(objects=objects)

    # Candidate unordered pairs in ids-order indexing.
    name_to_input_idx = {g.name: i for i, g in enumerate(genomes)}
    candidates: List[Tuple[int, int]] = []
    if filter_matrix is not None:
        fm_index = {name: i for i, name in enumerate(filter_matrix.names)}
        pos_in_ids = {idx: pos for pos, idx in enumerate(order)}
        for (fi, fj), v in filter_matrix.entries.items():
            if v < filter_threshold:
                continue
            na, nb = filter_matrix.names[fi], filter_matrix.names[fj]
            if na not in name_to_input_idx or nb not in name_to_input_idx:
                continue
            a = pos_in_ids[name_to_input_idx[na]]
            b = pos_in_ids[name_to_input_idx[nb]]
            i, j = (a, b) if a < b else (b, a)
            candidates.append((i, j))
        candidates = sorted(set(candidates))
    else:
        candidates = [(i, j) for i in range(n) for j in range(i + 1, n)]

    use_native = (engine == 'native'
                  or (engine == 'auto' and lz_native.available()))
    if engine == 'native' and not lz_native.available():
        raise RuntimeError('native align engine unavailable')

    if engine in ('gpu', 'tpu'):
        return _run_align_gpu(genomes, order, objects, result, candidates,
                              params, out_filters, keep_alignments)

    if use_native:
        return _run_align_native(genomes, order, objects, result, candidates,
                                 params, out_filters, keep_alignments,
                                 num_threads)

    codes = {}
    indexes = {}

    def get_codes(pos):
        if pos not in codes:
            codes[pos] = _genome_codes(genomes[order[pos]])
        return codes[pos]

    def get_index(pos):
        if pos not in indexes:
            if use_native:
                indexes[pos] = lz_native.NativeReferenceIndex(
                    get_codes(pos), params)
            else:
                indexes[pos] = ReferenceIndex(get_codes(pos), params)
        return indexes[pos]

    logger.info(f'Aligning {len(candidates)} genome pairs')
    lengths = [o[1] for o in objects]
    names = [o[0] for o in objects]

    for (i, j) in candidates:
        # Direction 1: q = j (shorter), r = i (longer); direction 2 reversed.
        d_ji = align_directed(get_codes(j), get_index(i), params)
        d_ij = align_directed(get_codes(i), get_index(j), params)
        if d_ji.n_alns == 0 and d_ij.n_alns == 0:
            continue
        qlen_j, qlen_i = lengths[j], lengths[i]
        tani = (d_ji.sum_match + d_ij.sum_match) / (qlen_i + qlen_j)
        len_ratio = min(qlen_i, qlen_j) / max(qlen_i, qlen_j)
        for (q, r, dqr, drq) in ((j, i, d_ji, d_ij), (i, j, d_ij, d_ji)):
            qlen, rlen = lengths[q], lengths[r]
            ani = dqr.sum_match / dqr.sum_alnlen if dqr.sum_alnlen else 0.0
            gani = dqr.sum_match / qlen
            qcov = dqr.sum_alnlen / qlen
            rcov = drq.sum_alnlen / rlen
            row = AniRow(
                qidx=q, ridx=r, query=names[q], reference=names[r],
                tani=tani, gani=gani, ani=ani, qcov=qcov, rcov=rcov,
                num_alns=dqr.n_alns, len_ratio=len_ratio,
                qlen=qlen, rlen=rlen,
                nt_match=dqr.sum_match,
                nt_mismatch=dqr.sum_alnlen - dqr.sum_match)
            if _passes_out_filters(row, out_filters):
                result.rows.append(row)
                if keep_alignments:
                    for a in sorted(dqr.alns,
                                    key=lambda a: (-a.alnlen, a.qstart)):
                        result.alignments.append(AlnRow(
                            query=names[q], reference=names[r],
                            pident=100.0 * a.nt_match / a.alnlen,
                            alnlen=a.alnlen,
                            qstart=a.qstart + 1, qend=a.qend + 1,
                            rstart=a.rstart + 1, rend=a.rend + 1,
                            nt_match=a.nt_match,
                            nt_mismatch=a.nt_mismatch))
    return result


def _run_align_gpu(genomes, order, objects, result, candidates, params,
                   out_filters, keep_alignments=False):
    """Device batch path: one program run per length bucket
    (ops/align_gpu.py:all2all_gpu). Emits the same measure columns as the
    JAX package's device engine, bit for bit; with keep_alignments, the
    per-alignment rows come from the device's segment records. Pairs
    touching genomes beyond the device engine's position range
    (align_gpu.MAX_TPU_LEN) go to the exact native engine (the Python
    oracle where the native library is absent)."""
    from ..ops import align_gpu
    from ..utils.device import resolve_device
    logger = get_logger()
    device = resolve_device()
    logger.info(f'Aligning {len(candidates)} genome pairs (GPU engine, '
                f'{device})')
    codes_list = [_genome_codes(genomes[order[pos]])
                  for pos in range(len(order))]
    oversized = {pos for pos, c in enumerate(codes_list)
                 if len(c) > align_gpu.MAX_TPU_LEN}
    host = np.array([i in oversized or j in oversized
                     for (i, j) in candidates], dtype=bool)
    pairs = np.asarray(candidates, dtype=np.int32).reshape(-1, 2)
    agg = np.zeros((len(candidates), 6), dtype=np.int64)
    blocks = [None] * (2 * len(candidates))  # directed task -> records

    def _place(sel, res):
        a, alns = res
        ks = np.flatnonzero(sel)
        agg[ks] = a
        if alns is not None:
            rows, counts = alns
            rows = rows[:, :6]  # the native engine's records have 7 columns
            offs = np.concatenate([[0], np.cumsum(counts)])
            for t, k in enumerate(ks):
                for d in (0, 1):
                    blocks[2 * k + d] = rows[offs[2 * t + d]:
                                             offs[2 * t + d + 1]]

    if (~host).any():
        res = align_gpu.all2all_gpu(codes_list, pairs[~host], params,
                                    keep_alignments=keep_alignments,
                                    device=device)
        _place(~host, res if keep_alignments else (res, None))
    if host.any():
        eng = 'native' if lz_native.available() else 'Python'
        logger.info(f'{int(host.sum())} pairs exceed the GPU engine\'s '
                    f'{align_gpu.MAX_TPU_LEN}-base range; using the exact '
                    f'{eng} engine for them')
        if lz_native.available():
            _place(host, lz_native.all2all_native(
                codes_list, pairs[host], params,
                keep_alignments=keep_alignments))
        else:
            _place(host, _all2all_py(codes_list, pairs[host], params,
                                     keep_alignments))
    alns = None
    if keep_alignments:
        alns = (np.concatenate(blocks) if blocks
                else np.empty((0, 6), np.int32),
                np.array([len(b) for b in blocks], dtype=np.int64))
    return _emit_rows(result, candidates, objects, agg, alns, out_filters)


def _all2all_py(codes_list, pairs, params, keep_alignments):
    """Python-oracle batch shim with lz_native.all2all_native's output
    layout: agg int64 (N, 6) = (n_ji, match_ji, alnlen_ji, n_ij, match_ij,
    alnlen_ij) for pair (i, j) with the (q=j, r=i) direction first, and
    (aln_rows, counts) in the native record layout when requested."""
    agg = np.zeros((len(pairs), 6), dtype=np.int64)
    counts = np.zeros(2 * len(pairs), dtype=np.int64)
    blocks = []
    indexes = {}

    def idx_of(r):
        if r not in indexes:
            indexes[r] = ReferenceIndex(codes_list[r], params)
        return indexes[r]

    for k, (i, j) in enumerate(np.asarray(pairs, dtype=np.int64)):
        for d, (q, r) in enumerate(((j, i), (i, j))):
            alns = parse_pair(codes_list[q], idx_of(int(r)), params)
            agg[k, 3 * d:3 * d + 3] = (len(alns),
                                       sum(a.nt_match for a in alns),
                                       sum(a.alnlen for a in alns))
            if keep_alignments:
                counts[2 * k + d] = len(alns)
                for a in alns:
                    blocks.append((a.qstart, a.qend, a.rstart, a.rend,
                                   a.nt_match, a.nt_mismatch))
    if not keep_alignments:
        return agg, None
    rows = (np.asarray(blocks, dtype=np.int32) if blocks
            else np.empty((0, 6), np.int32))
    return agg, (rows, counts)


def _run_align_native(genomes, order, objects, result, candidates, params,
                      out_filters, keep_alignments, num_threads):
    """Batch path: one native lz_all2all call, thread pool over pairs.

    Bit-identical to the per-pair Python path (pinned by
    tests/test_align_native.py); results are stored by pair index inside the
    engine, so output is deterministic at any thread count.
    """
    import multiprocessing
    logger = get_logger()
    n_threads = num_threads or min(multiprocessing.cpu_count(), 64)
    logger.info(f'Aligning {len(candidates)} genome pairs '
                f'({n_threads} threads, native batch engine)')
    codes_list = [_genome_codes(genomes[order[pos]])
                  for pos in range(len(order))]
    pairs = np.asarray(candidates, dtype=np.int32).reshape(-1, 2)
    agg, alns = lz_native.all2all_native(
        codes_list, pairs, params, n_threads=n_threads,
        keep_alignments=keep_alignments)
    return _emit_rows(result, candidates, objects, agg, alns, out_filters)


def _emit_rows(result, candidates, objects, agg, alns, out_filters):
    """AniRow (and, where alns is given, AlnRow) emission of the batch
    engines. agg int64 (N, 6) = (n_ji, match_ji, alnlen_ji, n_ij,
    match_ij, alnlen_ij) a candidate pair (i, j), the (q=j, r=i) direction
    first; alns = (rows, counts) in the native record layout, two directed
    tasks a pair in that order. Records of a directed pair are ordered by
    alnlen descending, then qstart."""
    lengths = [o[1] for o in objects]
    names = [o[0] for o in objects]
    if alns is not None:
        aln_rows, aln_counts = alns
        aln_offsets = np.zeros(len(aln_counts) + 1, dtype=np.int64)
        np.cumsum(aln_counts, out=aln_offsets[1:])

    for k, (i, j) in enumerate(candidates):
        n_ji, match_ji, alnlen_ji, n_ij, match_ij, alnlen_ij = agg[k]
        if n_ji == 0 and n_ij == 0:
            continue
        qlen_j, qlen_i = lengths[j], lengths[i]
        tani = (match_ji + match_ij) / (qlen_i + qlen_j)
        len_ratio = min(qlen_i, qlen_j) / max(qlen_i, qlen_j)
        for d, (q, r, n_a, s_match, s_alnlen, o_alnlen) in enumerate((
                (j, i, n_ji, match_ji, alnlen_ji, alnlen_ij),
                (i, j, n_ij, match_ij, alnlen_ij, alnlen_ji))):
            qlen, rlen = lengths[q], lengths[r]
            row = AniRow(
                qidx=q, ridx=r, query=names[q], reference=names[r],
                tani=tani,
                gani=s_match / qlen,
                ani=s_match / s_alnlen if s_alnlen else 0.0,
                qcov=s_alnlen / qlen,
                rcov=o_alnlen / rlen,
                num_alns=int(n_a), len_ratio=len_ratio,
                qlen=qlen, rlen=rlen,
                nt_match=int(s_match),
                nt_mismatch=int(s_alnlen - s_match))
            if not _passes_out_filters(row, out_filters):
                continue
            result.rows.append(row)
            if alns is not None:
                lo, hi = aln_offsets[2 * k + d], aln_offsets[2 * k + d + 1]
                block = aln_rows[lo:hi]
                alnlens = block[:, 4] + block[:, 5]
                for t in np.lexsort((block[:, 0], -alnlens)):
                    a = block[t]
                    al = int(alnlens[t])
                    result.alignments.append(AlnRow(
                        query=names[q], reference=names[r],
                        pident=100.0 * int(a[4]) / al, alnlen=al,
                        qstart=int(a[0]) + 1, qend=int(a[1]) + 1,
                        rstart=int(a[2]) + 1, rend=int(a[3]) + 1,
                        nt_match=int(a[4]), nt_mismatch=int(a[5])))
    return result


def _passes_out_filters(row: AniRow, out_filters: Dict[str, float]) -> bool:
    for key, threshold in out_filters.items():
        if threshold and getattr(row, key) < threshold:
            return False
    return True
