"""Shared input-loading model for the prefilter and align stages.

Mirrors the reference's two input modes (validate_args_fasta_input,
reference vclust.py:687-702):

- directory input: every FASTA file is one genome (sample); requires >= 2
  files; sample name = file stem (with .gz and the FASTA extension stripped);
  a multi-contig file is one genome whose parts are its sequences;
- single-file input ("multifasta" mode): every sequence is its own genome,
  named by its FASTA id.
"""

import pathlib
from dataclasses import dataclass
from typing import List

from ..io.fasta import read_fasta

FASTA_EXTENSIONS = {'.fasta', '.fa', '.fna', '.ffn', '.frn', '.txt'}


@dataclass
class Genome:
    name: str
    seqs: List[bytes]      # one or more contigs (parts)

    @property
    def total_len(self) -> int:
        return sum(len(s) for s in self.seqs)

    @property
    def n_parts(self) -> int:
        return len(self.seqs)


def sample_name(path) -> str:
    name = pathlib.Path(path).name
    if name.endswith('.gz'):
        name = name[:-3]
    stem, dot, ext = name.rpartition('.')
    return stem if dot else name


def list_fasta_dir(path) -> List[pathlib.Path]:
    """Sorted FASTA files in a directory (reference sorts the listing)."""
    files = []
    for p in sorted(pathlib.Path(path).iterdir()):
        if not p.is_file():
            continue
        name = p.name[:-3] if p.name.endswith('.gz') else p.name
        if pathlib.Path(name).suffix.lower() in FASTA_EXTENSIONS:
            files.append(p)
    return files


def load_genomes(input_path) -> tuple:
    """Load (genomes, is_multifasta) from a FASTA file or directory."""
    input_path = pathlib.Path(input_path)
    if input_path.is_dir():
        genomes = []
        for f in list_fasta_dir(input_path):
            records = read_fasta(f)
            genomes.append(Genome(
                name=sample_name(f), seqs=[r.seq for r in records]))
        return genomes, False
    records = read_fasta(input_path)
    return [Genome(name=r.id, seqs=[r.seq]) for r in records], True
