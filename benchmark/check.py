"""The check that decides `correct`: the aggregates the timed window
produced, against the plain reference (reference/engine.py), exactly.

Once the window has closed, a sample of each distinct job's pairs is drawn
from the seed, stratified by bucket; inside a bucket, by whether the
pair's two lengths differ by more than the hybrid's coverage rule allows
(a share under RERUN_COV of the longer: the hybrid must then align the
pair again on v2, whatever v3 found); and by whether the pair is flagged:
the job's first execution aligned it again on v2 (the program's own
choice, read from its calls) or left it a coverage under RERUN_COV in
either direction (as a re-run that was skipped leaves v3's aggregates of
a hard pair). Every stratum gets its share of the sample by its pairs,
and at least `floor` pairs (all it has, if fewer); a stratum of flagged
pairs of equal lengths, the pairs v3 leaves hard by their bases, gets at
least `flagged_floor`. So the longest genomes, the pairs the hybrid
re-runs and those it keeps on v3 are all in it. Each execution's six
aggregates of those pairs are held against the reference, which aligns
each sampled pair once after the program's state is freed and decides by
its own rule which pairs to align again: one wrong column in one
execution is a mismatch. The limit is 0: the port's aggregates are
integers, equal to its plain versions' bit for bit.
"""

import numpy as np

from jobs import pad_bucket

# The hybrid's coverage rule (a frozen copy of the engine's default).
RERUN_COV = 0.997


def draw_sample(job, rng: np.random.Generator, size: int, floor: int,
                first=None, rerun=None, flagged_floor: int = 0
                ) -> np.ndarray:
    """Sorted indices into job.pairs (see the module docstring); `first`:
    the job's first (len(pairs), 6) aggregates, `rerun`: indices of the
    pairs its first execution aligned again on v2, or None."""
    stratum = strata(job, first, rerun)
    picked = []
    total = len(stratum)
    for key in np.unique(stratum):
        at = np.flatnonzero(stratum == key)
        least = flagged_floor if key % 4 == 2 else floor
        n = min(len(at), max(floor, least,
                             int(round(size * len(at) / total))))
        picked.append(rng.choice(at, n, replace=False))
    return np.sort(np.concatenate(picked))


def strata(job, first=None, rerun=None) -> np.ndarray:
    """Each pair's stratum: 4 x its bucket, plus 1 where its lengths differ
    beyond RERUN_COV, plus 2 where it is flagged (see the module
    docstring)."""
    li, lj = job.lens[job.pairs[:, 0]], job.lens[job.pairs[:, 1]]
    kb = np.maximum([pad_bucket(L) for L in li], [pad_bucket(L) for L in lj])
    unequal = np.minimum(li, lj) < RERUN_COV * np.maximum(li, lj)
    flagged = np.zeros(len(li), dtype=bool)
    if first is not None:
        first = np.asarray(first, dtype=np.float64)
        flagged |= (np.minimum(first[:, 2] / np.maximum(lj, 1),
                               first[:, 5] / np.maximum(li, 1)) < RERUN_COV)
    if rerun is not None:
        flagged[np.asarray(rerun, dtype=np.int64)] = True
    return 4 * kb + unequal + 2 * flagged


def pair_index(job, pairs) -> np.ndarray:
    """The indices into job.pairs of `pairs` ((n, 2), each in job.pairs)."""
    n = len(job.lens)
    key = job.pairs[:, 0].astype(np.int64) * n + job.pairs[:, 1]
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    want = pairs[:, 0] * n + pairs[:, 1]
    at = np.minimum(np.searchsorted(key, want), len(key) - 1)
    if len(want) and (key[at] != want).any():
        raise ValueError("a pair that is not the job's")
    return at


def compare(jobs, samples, kept, device, align_pairs) -> dict:
    """Hold every execution's aggregates of the sampled pairs (kept[k]: a
    list of (len(pairs), 6) arrays, one an execution of job k) against the
    reference's (align_pairs(codes_list, pairs, device)). Returns the
    counts and, for each mismatch, what the reference and the program
    gave."""
    mismatched = compared = hard = 0
    detail = []
    for k, (job, idx) in enumerate(zip(jobs, samples)):
        if not kept[k]:
            continue
        want, was_hard = align_pairs(job.codes_list, job.pairs[idx], device)
        hard += int(was_hard.sum())
        for e, out in enumerate(kept[k]):
            got = out[idx]
            compared += len(idx)
            bad = np.flatnonzero((got != want).any(axis=1))
            mismatched += len(bad)
            for b in bad[:max(0, 20 - len(detail))]:
                i, j = (int(x) for x in job.pairs[idx[b]])
                detail.append(dict(
                    job=k, execution=e, pair=[i, j],
                    lengths=[int(job.lens[i]), int(job.lens[j])],
                    bucket=max(pad_bucket(job.lens[i]),
                               pad_bucket(job.lens[j])),
                    hybrid_v2=bool(was_hard[b]),
                    columns=[c for c in range(6) if got[b, c] != want[b, c]],
                    program=got[b].tolist(), reference=want[b].tolist()))
    return dict(mismatched_pairs=mismatched, compared_pairs=compared,
                sampled_hard_pairs=hard, mismatches=detail)
