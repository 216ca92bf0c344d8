"""Peaks of the card and the least work of the kernels whose share of its
roofline the benchmark reports: K2 (v3 stage 1, `stage1_kernel`) and K6
(the v2 front end, `front_kernel`). The counts depend only on the pairs
each pipe aligned, their buckets and their genomes' lengths, never on how
a kernel does its work, how far it pads or how the pairs are batched, so
a later kernel that replaces one reads against the same bound.
"""

import math

import numpy as np

# One H100 SXM (NVIDIA's data sheet, dense rates, 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
# The int32 pipe: 64 lanes an SM x 132 SMs x 1.98 GHz, one instruction a
# lane and clock (half the data sheet's 67 TFLOP/s float32 rate).
INT32_SLOTS_PER_S = 33.5e12 / 2

# The engine's constants the counts read (a frozen copy).
V3_H = 2048
V3_WQ = 128
V3_MAX_BUCKET = 131072
SEED_K = 8
FINE = 32
C = 16


def k2_ops(lq: np.ndarray, lr: np.ndarray) -> float:
    """Least int8 operations of stage 1 for the directed pairs of queries
    of lq bases against references of lr bases: the product of the
    query's occupancy rows (its half-blocks of V3_WQ / 2 bases x H) with
    the reference's (its blocks of FINE bases x H), 2 operations a
    multiply-add. Only the rows that hold the genome count: the rows of
    the bucket's padding past its end are the kernel's choice, not the
    work (PERF.md's K2 row counts the whole bucket)."""
    lq = np.asarray(lq, dtype=np.float64)
    lr = np.asarray(lr, dtype=np.float64)
    return float((2.0 * np.ceil(lq / (V3_WQ // 2)) * np.ceil(lr / FINE)
                  * V3_H).sum())


def seeds_per_block(L: int, kb: int) -> np.ndarray:
    """Seeds the v2 index keeps in each fine block of a genome of L bases
    of codes 0-3 at bucket kb: min(C, the block's valid k-mers)."""
    start = np.arange(kb // FINE) * FINE
    valid = np.clip(L - SEED_K + 1 - start, 0, FINE)
    return np.minimum(valid, C)


def k6_fine_coarse(C_: int = C) -> tuple:
    """Int32 slots of K6's least election work on a fine block of 4C votes
    and on a coarse block of 16C (a frozen copy of the count of PERF.md's
    K6 row): the sort, n log2 n compare-selects, the merge of 4 runs, the
    window and equal counts by moving pointers (4 a vote), the exact
    votes and the support (2 a vote)."""
    c4 = 4 * C_
    fine = c4 * math.ceil(math.log2(c4)) + 4 * c4 + 2 * c4 + 2 * c4
    coarse = 2 * 4 * c4 + 4 * c4 + 2 * 4 * c4
    return fine, coarse


def k6_least(lens: np.ndarray, pairs: np.ndarray, kb: np.ndarray) -> tuple:
    """(bytes, int32 slots) K6 needs at least for the v2 pipe's directed
    pairs of one align call (pairs (i, j), their buckets kb): each
    distinct genome's query seeds and each distinct reference's sorted
    values and packs read once a bucket, the election written (10 bytes a
    fine block); a search a valid query seed and strand over the
    reference strand's valid entries (a compare-select a level), and the
    election work on the fine and coarse blocks that hold a seed."""
    fine, coarse = k6_fine_coarse()
    nbytes = 0.0
    slots = 0.0
    for L in np.unique(kb).tolist():
        at = kb == L
        packs = 1 if L > 65536 else 2
        gids = np.unique(pairs[at])
        n = np.zeros(len(lens), np.int64)      # valid seeds, a strand
        fb = np.zeros(len(lens), np.int64)     # fine blocks with a seed
        cb = np.zeros(len(lens), np.int64)     # coarse blocks with a seed
        for g in gids.tolist():
            s = seeds_per_block(int(lens[g]), L)
            n[g] = s.sum()
            fb[g] = (s > 0).sum()
            cb[g] = (s.reshape(-1, 4).sum(axis=1) > 0).sum()
        levels = 2 * np.ceil(np.log2(n + 1))   # both strands
        nbytes += float(((L // FINE) * C * 4 + n[gids] * 4
                         + 2 * n[gids] * (4 + 8 * packs)).sum())
        i, j = pairs[at, 0], pairs[at, 1]
        for q, r in ((j, i), (i, j)):
            slots += float((2 * n[q] * levels[r] + fine * fb[q]
                            + coarse * cb[q]).sum())
            nbytes += len(q) * (L // FINE) * 10
    return nbytes, slots


def k6_least_s(nbytes: float, slots: float) -> float:
    """K6's least seconds: the larger of its bytes and its slots bound."""
    return max(nbytes / HBM_BYTES_PER_S, slots / INT32_SLOTS_PER_S)
