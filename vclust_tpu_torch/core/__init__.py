from .seq import (  # noqa: F401
    encode, decode, revcomp_codes, revcomp_str, canonical_bytes, pack2bit,
)
from .kmers import canonical_kmer_set, kmer_sets  # noqa: F401
