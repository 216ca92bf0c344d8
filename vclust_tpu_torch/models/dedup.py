"""FASTA merge + exact deduplication engine.

Replacement for the reference's mfasta-tool `mrds` mode (contract:
reference vclust.py:810-912; behavior pinned by reference test.py:196-310 and
example/datasets/README.txt):

- merges input FASTAs in order; exact duplicates removed, with reverse
  complements counted as duplicates (--rev-comp-as-equivalent);
- keeper = first occurrence in input order; output preserves encounter order;
- duplicates file: one line per group with duplicates,
  ``keeper -same_orientation_dup +revcomp_dup ...`` in encounter order;
- optional per-file id prefixes; optional gzip output.

This stage is host-bound IO (hashing + dict lookups, no FLOPs) — it stays on
the CPU by design; the device work starts at the prefilter.
"""

import hashlib
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.seq import revcomp_str
from ..io.fasta import FastaRecord, iter_fasta, write_fasta


@dataclass
class DedupResult:
    records: List[FastaRecord]              # unique records, encounter order
    duplicates: List[Tuple[str, List[Tuple[str, bool]]]] = field(
        default_factory=list)               # (keeper_id, [(dup_id, is_rc)])
    n_total: int = 0


def _digest(seq: bytes) -> bytes:
    return hashlib.sha256(seq).digest()


def deduplicate_records(record_iter) -> DedupResult:
    """Streaming dedup over FastaRecords; revcomp counts as duplicate."""
    seen: Dict[bytes, int] = {}             # digest -> group index
    groups: List[Tuple[FastaRecord, List[Tuple[str, bool]]]] = []
    n_total = 0
    for rec in record_iter:
        n_total += 1
        up = rec.seq.upper()
        d_fwd = _digest(up)
        group_idx = seen.get(d_fwd)
        is_rc = False
        if group_idx is None:
            d_rc = _digest(revcomp_str(up))
            group_idx = seen.get(d_rc)
            is_rc = group_idx is not None
        if group_idx is None:
            seen[d_fwd] = len(groups)
            groups.append((rec, []))
        else:
            groups[group_idx][1].append((rec.id, is_rc))
    result = DedupResult(records=[g[0] for g in groups], n_total=n_total)
    for keeper, dups in groups:
        if dups:
            result.duplicates.append((keeper.id, dups))
    return result


def _prefixed_records(path, prefix: Optional[str]):
    for rec in iter_fasta(path):
        if prefix:
            rec = FastaRecord(id=prefix + rec.id,
                              description=prefix + rec.description,
                              seq=rec.seq)
        yield rec


def run_deduplicate(
    input_paths: Sequence,
    output_path,
    duplicates_path,
    prefixes: Optional[Sequence[str]] = None,
    gzip_output: bool = False,
    gzip_level: int = 4,
) -> DedupResult:
    """Full deduplicate stage: merge files -> dedup -> write outputs."""
    input_paths = [pathlib.Path(p) for p in input_paths]
    if prefixes:
        assert len(prefixes) == len(input_paths)
    else:
        prefixes = [None] * len(input_paths)

    def all_records():
        for path, prefix in zip(input_paths, prefixes):
            yield from _prefixed_records(path, prefix)

    result = deduplicate_records(all_records())
    write_fasta(output_path, result.records,
                gzip_output=gzip_output, gzip_level=gzip_level)
    with open(duplicates_path, 'w') as fh:
        for keeper_id, dups in result.duplicates:
            marks = ''.join(
                f' {"+" if is_rc else "-"}{dup_id}' for dup_id, is_rc in dups)
            fh.write(f'{keeper_id}{marks}\n')
    return result
