"""FASTA reading/writing (plain and gzip), host side.

Replaces the parsing half of the reference's mfasta-tool (contract at
reference vclust.py:810-912). Sequences are kept as raw bytes; ids are the
first whitespace-delimited token of the header.
"""

import gzip
import pathlib
from dataclasses import dataclass
from typing import Iterator, List, Union


@dataclass
class FastaRecord:
    id: str
    description: str  # full header line without '>'
    seq: bytes

    def __len__(self):
        return len(self.seq)


def _open_maybe_gzip(path, mode='rb'):
    path = pathlib.Path(path)
    with open(path, 'rb') as fh:
        magic = fh.read(2)
    if magic == b'\x1f\x8b':
        return gzip.open(path, mode)
    return open(path, mode)


def iter_fasta(path) -> Iterator[FastaRecord]:
    header = None
    chunks: List[bytes] = []
    with _open_maybe_gzip(path) as fh:
        for line in fh:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(b'>'):
                if header is not None:
                    yield _make_record(header, chunks)
                header = line[1:].decode('utf-8', errors='replace')
                chunks = []
            else:
                chunks.append(line)
        if header is not None:
            yield _make_record(header, chunks)


def _make_record(header: str, chunks: List[bytes]) -> FastaRecord:
    seq = b''.join(chunks)
    seq_id = header.split()[0] if header.split() else header
    return FastaRecord(id=seq_id, description=header, seq=seq)


def read_fasta(path) -> List[FastaRecord]:
    return list(iter_fasta(path))


def write_fasta(path, records, gzip_output: bool = False,
                gzip_level: int = 4, wrap: int = 70) -> None:
    path = pathlib.Path(path)
    if gzip_output:
        fh = gzip.open(path, 'wb', compresslevel=gzip_level)
    else:
        fh = open(path, 'wb')
    with fh:
        for rec in records:
            fh.write(b'>' + rec.description.encode('utf-8') + b'\n')
            seq = rec.seq
            if wrap:
                for i in range(0, len(seq), wrap):
                    fh.write(seq[i:i + wrap] + b'\n')
            else:
                fh.write(seq + b'\n')


def read_fasta_paths(paths) -> List[FastaRecord]:
    """Read and concatenate records from several FASTA files, in order."""
    out: List[FastaRecord] = []
    for p in paths:
        out.extend(iter_fasta(p))
    return out
