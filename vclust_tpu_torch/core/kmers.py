"""Canonical k-mer extraction (host side, vectorized numpy).

The prefilter counts *distinct shared canonical k-mers* between genome pairs
(reference kmer-db contract, SURVEY.md section 2.4). A canonical k-mer is
min(kmer, revcomp(kmer)) as a 2k-bit integer with A=0<C=1<G=2<T=3, which
equals the lexicographic minimum. Windows containing any non-ACGT base are
skipped.

Output per genome: a sorted np.uint64 array of distinct canonical k-mers —
the host-side sketch that feeds the device occupancy-count prefilter
(ops/prefilter.py).
"""

import numpy as np

from .seq import encode, revcomp_codes


def _window_values(codes: np.ndarray, k: int) -> np.ndarray:
    """2k-bit integer value of each length-k window of a code array."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint64)
    vals = np.zeros(n, dtype=np.uint64)
    c = codes.astype(np.uint64)
    for j in range(k):
        vals = (vals << np.uint64(2)) | c[j:j + n]
    return vals


def canonical_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """Canonical k-mer values of every valid window (with multiplicity)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint64)
    # Mask windows containing invalid bases via prefix sums of validity.
    invalid = (codes >= 4).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(invalid)])
    ok = (cs[k:] - cs[:-k]) == 0
    clean = np.where(codes >= 4, 0, codes).astype(np.int8)
    fwd = _window_values(clean, k)
    rc_all = revcomp_codes(clean)  # all codes valid now
    rc_fwd = _window_values(rc_all, k)
    # revcomp of window starting at i = window of rc sequence at n-1-i
    rc = rc_fwd[::-1]
    return np.minimum(fwd, rc)[ok]


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — used for the --kmers-fraction MinHash-style
    subsample (reference vclust.py:240-248). This is the standard
    fraction rule hash(kmer) <= f*(2**64-1) with a fixed 64-bit mixer;
    kmer-db's own `-f` hash function lives in its absent C++ submodule,
    so fltr.txt at fraction < 1 is NOT byte-comparable to kmer-db output
    (parity is only required, and holds, at fraction = 1.0). The rule is
    a pure function of the k-mer value, so the subsample is deterministic
    across runs, batches and hosts (pinned by
    tests/test_prefilter.py::test_fraction_batched_matches_unbatched)."""
    x = x.copy()
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def canonical_kmer_set(seq, k: int, fraction: float = 1.0) -> np.ndarray:
    """Sorted distinct canonical k-mers of a sequence (str/bytes/codes)."""
    codes = seq if isinstance(seq, np.ndarray) else encode(seq)
    kmers = np.unique(canonical_kmers(codes, k))
    if fraction < 1.0:
        threshold = np.uint64(int(fraction * float(2**64 - 1)))
        kmers = kmers[_mix64(kmers) <= threshold]
    return kmers


def kmer_sets(seqs, k: int, fraction: float = 1.0):
    """Canonical k-mer sets for a list of sequences."""
    return [canonical_kmer_set(s, k, fraction) for s in seqs]
