"""Readers/writers for every on-disk interchange format of the pipeline.

These formats are the real API between stages (SURVEY.md section 1, L1) and
must match the reference byte-for-byte on the bundled examples:

- fltr.txt      — prefilter sparse matrix (kmer-db `distance` CSV, golden
                  example/output/fltr.txt)
- ani.tsv       — alignment measures TSV (lz-ani, golden ani.tsv)
- ani.ids.tsv   — object table `id seq_len no_parts`, length-descending
- ani.aln.tsv   — per-alignment TSV (lz-ani --out-alignment)
- clusters.tsv  — `object cluster` table (clusty)
"""

import pathlib
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from ..utils.fmt import fmt_fltr_value, fmt_len_ratio, fmt_measure

ALN_HEADER = ['query', 'reference', 'pident', 'alnlen', 'qstart', 'qend',
              'rstart', 'rend', 'nt_match', 'nt_mismatch']


# ---------------------------------------------------------------------------
# fltr.txt (prefilter output; format pinned by golden example/output/fltr.txt)
# ---------------------------------------------------------------------------

@dataclass
class FilterMatrix:
    """Sparse lower-triangle similarity matrix over named genomes.

    ``names`` are in input-appearance order; ``entries[(i, j)]`` with i > j
    holds the value for the pair (names[i], names[j]).
    """
    kmer_length: int
    fraction: float
    names: List[str]
    entries: Dict[Tuple[int, int], float] = field(default_factory=dict)

    def lookup(self, i: int, j: int):
        if i == j:
            return None
        key = (i, j) if i > j else (j, i)
        return self.entries.get(key)


def _fmt_fraction(fraction: float) -> str:
    return f'{fraction:g}'


def write_fltr(path, m: FilterMatrix) -> None:
    with open(path, 'w') as fh:
        names = ','.join(m.names)
        fh.write(f'kmer-length: {m.kmer_length} fraction: '
                 f'{_fmt_fraction(m.fraction)} ,{names},\n')
        for i, name in enumerate(m.names):
            parts = [name]
            for j in range(i):
                v = m.entries.get((i, j))
                if v is not None:
                    parts.append(f'{j + 1}:{fmt_fltr_value(v)}')
            fh.write(','.join(parts) + ',\n')


def read_fltr(path) -> FilterMatrix:
    with open(path) as fh:
        header = fh.readline().rstrip('\n')
        tokens = header.split(',')
        meta = tokens[0]
        fields = meta.split()
        k = int(fields[1])
        fraction = float(fields[3])
        names = [t for t in tokens[1:] if t]
        m = FilterMatrix(kmer_length=k, fraction=fraction, names=names)
        for i, line in enumerate(fh):
            toks = [t for t in line.rstrip('\n').split(',') if t]
            for t in toks[1:]:
                j_str, v_str = t.split(':')
                m.entries[(i, int(j_str) - 1)] = float(v_str)
    return m


# ---------------------------------------------------------------------------
# ani.ids.tsv
# ---------------------------------------------------------------------------

def write_ids(path, objects: Sequence[Tuple[str, int, int]]) -> None:
    """objects: (id, seq_len, no_parts) already in length-descending order."""
    with open(path, 'w') as fh:
        fh.write('id\tseq_len\tno_parts\n')
        for oid, seq_len, no_parts in objects:
            fh.write(f'{oid}\t{seq_len}\t{no_parts}\n')


def read_ids(path) -> List[Tuple[str, int, int]]:
    out = []
    with open(path) as fh:
        header = fh.readline().rstrip('\n').split('\t')
        assert header[0] == 'id', f'unexpected ids header: {header}'
        for line in fh:
            toks = line.rstrip('\n').split('\t')
            out.append((toks[0], int(toks[1]), int(toks[2])))
    return out


# ---------------------------------------------------------------------------
# ani.tsv
# ---------------------------------------------------------------------------

@dataclass
class AniRow:
    qidx: int
    ridx: int
    query: str
    reference: str
    tani: float
    gani: float
    ani: float
    qcov: float
    rcov: float
    num_alns: int
    len_ratio: float
    qlen: int
    rlen: int
    nt_match: int
    nt_mismatch: int

    def formatted(self, fields: Sequence[str]) -> List[str]:
        out = []
        for f in fields:
            v = getattr(self, f)
            if f in ('tani', 'gani', 'ani', 'qcov', 'rcov'):
                out.append(fmt_measure(v))
            elif f == 'len_ratio':
                out.append(fmt_len_ratio(v))
            else:
                out.append(str(v))
        return out


def write_ani(path, rows: Sequence[AniRow], fields: Sequence[str]) -> None:
    with open(path, 'w') as fh:
        fh.write('\t'.join(fields) + '\n')
        for row in rows:
            fh.write('\t'.join(row.formatted(fields)) + '\n')


def read_ani(path):
    """Read an ani.tsv with arbitrary column subset -> (header, rows of str)."""
    with open(path) as fh:
        header = fh.readline().rstrip('\n').split('\t')
        rows = [line.rstrip('\n').split('\t') for line in fh if line.strip()]
    return header, rows


# ---------------------------------------------------------------------------
# ani.aln.tsv
# ---------------------------------------------------------------------------

@dataclass
class AlnRow:
    query: str
    reference: str
    pident: float
    alnlen: int
    qstart: int  # 1-based inclusive
    qend: int
    rstart: int  # rstart > rend encodes reverse strand
    rend: int
    nt_match: int
    nt_mismatch: int


def write_aln(path, rows: Sequence[AlnRow]) -> None:
    with open(path, 'w') as fh:
        fh.write('\t'.join(ALN_HEADER) + '\n')
        for r in rows:
            fh.write('\t'.join([
                r.query, r.reference, fmt_measure(r.pident), str(r.alnlen),
                str(r.qstart), str(r.qend), str(r.rstart), str(r.rend),
                str(r.nt_match), str(r.nt_mismatch),
            ]) + '\n')


# ---------------------------------------------------------------------------
# clusters.tsv
# ---------------------------------------------------------------------------

def write_clusters(path, objects: Sequence[str], labels) -> None:
    """labels: per-object cluster id (int) or representative name (str)."""
    with open(path, 'w') as fh:
        fh.write('object\tcluster\n')
        for obj, lab in zip(objects, labels):
            fh.write(f'{obj}\t{lab}\n')


def read_clusters(path) -> List[Tuple[str, str]]:
    out = []
    with open(path) as fh:
        fh.readline()
        for line in fh:
            toks = line.rstrip('\n').split('\t')
            if len(toks) >= 2:
                out.append((toks[0], toks[1]))
    return out


# ---------------------------------------------------------------------------
# file lists (one FASTA path per line; reference vclust.py:947-950,1137-1140)
# ---------------------------------------------------------------------------

def write_filelist(path, paths) -> None:
    with open(path, 'w') as fh:
        for p in paths:
            fh.write(str(pathlib.Path(p)) + '\n')
