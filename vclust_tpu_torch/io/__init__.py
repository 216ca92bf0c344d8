from .fasta import read_fasta, write_fasta, FastaRecord  # noqa: F401
from . import formats  # noqa: F401
