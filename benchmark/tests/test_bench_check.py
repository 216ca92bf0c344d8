"""The check's sample: stratified by bucket, by whether the hybrid must
re-run a pair for its lengths alone and by whether the first execution
gave it a low coverage, with a floor in every stratum."""

import numpy as np
import pytest

import check
import jobs


class FakeJob:
    def __init__(self, lens, pairs):
        self.lens = np.asarray(lens, dtype=np.int64)
        self.pairs = np.asarray(pairs, dtype=np.int32)


def _job():
    # Genomes 0-39 at 60,000 and 59,990 (equal within 0.3%), 40-79 at
    # 60,000 and 50,000 (unequal), 80-83 at 200,000 (v2 alone).
    lens = ([60000, 59990] * 20 + [60000, 50000] * 20
            + [200000, 199000, 180000, 170000])
    i, j = np.triu_indices(84, 1)
    return FakeJob(lens, np.stack([i, j], 1))


def test_every_stratum_has_its_floor():
    job = _job()
    st = check.strata(job)
    idx = check.draw_sample(job, np.random.default_rng(1), 100, 12)
    assert (np.diff(idx) > 0).all()
    for key in np.unique(st):
        have = (st == key).sum()
        assert (st[idx] == key).sum() >= min(12, have)
    # Both classes at bucket 65,536 and the bucket above v3.
    keys = set(st.tolist())
    assert {4 * 65536, 4 * 65536 + 1} <= keys
    assert any(k // 4 > 131072 for k in keys)


def test_flagged_pairs_of_equal_lengths_have_their_own_floor():
    """Pairs that the first execution aligned again on v2, or left under
    RERUN_COV in either direction (as a skipped re-run leaves v3's
    aggregates), form a stratum of their own; where their lengths are equal
    it takes at least `flagged_floor` of its pairs."""
    job = _job()
    first = np.zeros((len(job.pairs), 6))
    li = job.lens[job.pairs[:, 0]]
    lj = job.lens[job.pairs[:, 1]]
    first[:, 2], first[:, 5] = lj, li              # whole coverage
    flagged = np.zeros(len(first), dtype=bool)
    flagged[:60] = True                            # pairs (0, 1..60)
    first[:30, 5] = np.floor(0.99 * li[:30])
    st = check.strata(job, first, rerun=np.arange(30, 60))
    assert ((st % 4 >= 2) == flagged).all()
    assert (check.strata(job) % 4 < 2).all()
    assert (check.strata(job, first) % 4 >= 2).sum() == 30
    idx = check.draw_sample(job, np.random.default_rng(2), 100, 12,
                            first=first, rerun=np.arange(30, 60),
                            flagged_floor=50)
    for key in np.unique(st[flagged]):
        have = (st == key).sum()
        want = min(have, 50) if key % 4 == 2 else min(have, 12)
        assert (st[idx] == key).sum() >= want


def test_pair_index():
    job = _job()
    at = check.pair_index(job, job.pairs[[5, 0, 900]])
    assert at.tolist() == [5, 0, 900]
    assert len(check.pair_index(job, np.zeros((0, 2)))) == 0
    with pytest.raises(ValueError):
        check.pair_index(job, [[3, 2]])


def test_sample_is_the_seeds():
    job = _job()
    a = check.draw_sample(job, np.random.default_rng([7, 1]), 100, 12)
    b = check.draw_sample(job, np.random.default_rng([7, 1]), 100, 12)
    c = check.draw_sample(job, np.random.default_rng([8, 1]), 100, 12)
    assert (a == b).all() and not np.array_equal(a, c)


def test_unequal_is_the_hybrids_rule():
    job = FakeJob([1000, 997, 996], [[0, 1], [0, 2]])
    assert (check.strata(job) % 2).tolist() == [0, 1]
    assert check.RERUN_COV == 0.997
    assert jobs.pad_bucket(1000) == 4096
