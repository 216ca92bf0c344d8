"""Nucleotide sequence encoding primitives.

Sequences are encoded as small integer codes (A=0, C=1, G=2, T=3; anything
else = 4) in numpy int8 arrays on the host, and can be 2-bit packed into
int32 words for device residency. The A<C<G<T code
order makes integer comparison equal to lexicographic comparison, so canonical
k-mers (min of k-mer and reverse complement) are integer minima.
"""

import numpy as np

# Encoding lookup: byte value -> code. Case-insensitive; U treated as T
# (RNA tolerance); everything else (incl. IUPAC ambiguity codes and N) -> 4.
_ENC = np.full(256, 4, dtype=np.int8)
for i, base in enumerate('ACGT'):
    _ENC[ord(base)] = i
    _ENC[ord(base.lower())] = i
_ENC[ord('U')] = 3
_ENC[ord('u')] = 3

_DEC = np.frombuffer(b'ACGTN', dtype=np.uint8)

# Complement on codes: 0<->3, 1<->2, invalid stays invalid.
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)

# Byte-level reverse complement table for raw ASCII sequences (dedup path).
_COMP_BYTES = np.arange(256, dtype=np.uint8)
for a, b in [('A', 'T'), ('C', 'G'), ('G', 'C'), ('T', 'A'),
             ('a', 't'), ('c', 'g'), ('g', 'c'), ('t', 'a'),
             ('U', 'A'), ('u', 'a'),
             # IUPAC ambiguity codes
             ('R', 'Y'), ('Y', 'R'), ('S', 'S'), ('W', 'W'), ('K', 'M'),
             ('M', 'K'), ('B', 'V'), ('V', 'B'), ('D', 'H'), ('H', 'D'),
             ('r', 'y'), ('y', 'r'), ('s', 's'), ('w', 'w'), ('k', 'm'),
             ('m', 'k'), ('b', 'v'), ('v', 'b'), ('d', 'h'), ('h', 'd')]:
    _COMP_BYTES[ord(a)] = ord(b)


def encode(seq) -> np.ndarray:
    """Encode an ASCII sequence (str or bytes) to int8 codes 0..4."""
    if isinstance(seq, str):
        seq = seq.encode('ascii')
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _ENC[raw]


def decode(codes: np.ndarray) -> str:
    return _DEC[np.clip(codes, 0, 4)].tobytes().decode('ascii')


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return _COMP[codes][::-1]


def revcomp_str(seq) -> bytes:
    """Reverse complement of a raw ASCII sequence (bytes in, bytes out)."""
    if isinstance(seq, str):
        seq = seq.encode('ascii')
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _COMP_BYTES[raw][::-1].tobytes()


def canonical_bytes(seq: bytes) -> bytes:
    """Canonical representative of {seq, revcomp(seq)}: the uppercased
    lexicographic minimum. Used for reverse-complement-aware dedup
    (reference mfasta-tool --rev-comp-as-equivalent, vclust.py:852)."""
    up = seq.upper()
    rc = revcomp_str(up)
    return up if up <= rc else rc


def pack2bit(codes: np.ndarray, word: int = 16) -> np.ndarray:
    """Pack codes (invalid treated as A) into int32 words, `word` bases per
    word, little-endian within a word: base i occupies bits 2*i..2*i+1.
    Length padded to a multiple of `word` with zeros."""
    codes = np.where(codes >= 4, 0, codes).astype(np.uint64)
    n = len(codes)
    pad = (-n) % word
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint64)])
    codes = codes.reshape(-1, word)
    shifts = (2 * np.arange(word, dtype=np.uint64))
    packed = (codes << shifts).sum(axis=1, dtype=np.uint64)
    return packed.astype(np.uint32).view(np.int32)
