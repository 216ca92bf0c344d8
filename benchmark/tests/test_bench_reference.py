"""The frozen reference against the port's CPU path (its plain versions):
equal aggregates on tiny jobs of both configurations, through both pipes
and the hybrid's merge, and on a pair above 131,072 (v2 alone)."""

import pytest

import jobs
from reference import engine
from tiny import config, traffic


def port(codes_list, pairs):
    from vclust_tpu_torch.ops import align_gpu
    return align_gpu.all2all_gpu(codes_list, pairs, device='cpu')


@pytest.mark.parametrize('cfg', ['imgvr_votu', 'ictv_species'])
def test_reference_equals_port_cpu(cfg):
    j = jobs.make_jobs(config(cfg), traffic(jobs=1), 2 ** 31 + 5)[0]
    want, hard = engine.align_pairs(j.codes_list, j.pairs, 'cpu')
    assert (port(j.codes_list, j.pairs) == want).all()
    if cfg == 'ictv_species':      # both pipes and the merge ran
        assert hard.any() and not hard.all()
    assert (want[:, [2, 5]] > 0).any()


def test_reference_equals_port_above_v3():
    """A family of three genomes of 140,000 bases: bucket 196,608, v2
    only."""
    t = traffic(jobs=1, families=1, family_size=dict(exponent=2, min=3,
                                                     max=3),
                length=dict(median=140000, sigma=0.01, min=140000,
                            max=140000))
    j = jobs.make_jobs(config('imgvr_votu'), t, 11)[0]
    assert jobs.pad_bucket(j.lens[0]) == 196608
    want, _ = engine.align_pairs(j.codes_list, j.pairs, 'cpu')
    assert (port(j.codes_list, j.pairs) == want).all()
    assert (want[:, 1] > 0).all()


def test_reference_batching_does_not_matter():
    """One pair alone, and in its job, reads the same."""
    j = jobs.make_jobs(config('ictv_species'), traffic(jobs=1), 8)[0]
    want, _ = engine.align_pairs(j.codes_list, j.pairs, 'cpu')
    for k in (0, len(j.pairs) - 1):
        one, _ = engine.align_pairs(j.codes_list, j.pairs[k:k + 1], 'cpu')
        assert (one[0] == want[k]).all()
