"""Seeded genomes for the index builds (K9 and K10, csrc/index.cu) and
their plain versions, shared by tests/test_torch_index_model.py (numpy
models), tests/test_torch_index.py (the JAX package) and
tests/test_torch_kernels.py (the card). numpy and the port only."""

import numpy as np

from vclust_tpu_torch.core.seq import revcomp_codes


def index_genomes(seed, Lp):
    """Genomes for bucket Lp (>= 4,096) with the index builds' hard rows:
    a poly-A run of 2,100 bases (one k-mer value over ~65 blocks, the
    sort's largest run of equal keys); a genome of N only (no valid seed:
    every slot invalid, every hash H - 1); one that ends at the bucket's
    edge (its last k - 1 positions run past it); a tandem repeat of period
    3 (equal values inside a block, so hash ties resolved by offset); Ns
    that leave blocks fewer valid positions than C (an N every fourth
    base over 400 bases: none valid; an N every 32 bases over 1,200: 32 -
    k valid a block, below C = 32); a short genome; a random one. Codes
    0-4 (int8)."""
    rng = np.random.default_rng(seed)
    n = Lp - 300
    poly = rng.integers(0, 4, n).astype(np.int8)
    poly[500:2600] = 0
    edge = rng.integers(0, 4, Lp).astype(np.int8)
    tandem = rng.integers(0, 4, n).astype(np.int8)
    tandem[1000:1600] = np.tile(np.array([0, 1, 2], np.int8), 200)
    sparse = rng.integers(0, 4, n).astype(np.int8)
    sparse[1200:1600:4] = 4
    sparse[2000:3200:32] = 4
    return [poly, np.full(n // 2, 4, np.int8), edge, tandem, sparse,
            rng.integers(0, 4, 700).astype(np.int8),
            rng.integers(0, 4, n - 1000).astype(np.int8)]


def padded(codes, Lp):
    """fwd and rc (G, Lp) int8: each genome and its reverse complement,
    padded with 4s to the bucket, as GenomeIndex._build lays them out."""
    fwd = np.full((len(codes), Lp), 4, np.int8)
    rc = fwd.copy()
    for r, c in enumerate(codes):
        fwd[r, :len(c)] = c
        rc[r, :len(c)] = revcomp_codes(c)
    return fwd, rc
