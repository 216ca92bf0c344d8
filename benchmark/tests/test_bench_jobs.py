"""The job generator: deterministic per seed, and the same work on every
seed."""

import json

import numpy as np
import pytest

import jobs
from conftest import BENCH
from tiny import config, traffic

# (configuration, traffic, pairs a genome of the traffic's plan)
CELLS = [('imgvr_votu', 'complete', 13.70),
         ('imgvr_votu', 'complete_131k', 13.70),
         ('imgvr_votu', 'whole', 13.70),
         ('imgvr_votu', 'whole_131k', 13.70),
         ('ictv_species', 'genus', 13.43)]


@pytest.mark.parametrize('cfg', ['imgvr_votu', 'ictv_species'])
def test_same_seed_same_jobs(cfg):
    a = jobs.make_jobs(config(cfg), traffic(), 2 ** 31 + 17)
    b = jobs.make_jobs(config(cfg), traffic(), 2 ** 31 + 17)
    for x, y in zip(a, b):
        assert (x.pairs == y.pairs).all()
        assert all((p == q).all() for p, q in zip(x.codes_list,
                                                   y.codes_list))


@pytest.mark.parametrize('cfg', ['imgvr_votu', 'ictv_species'])
def test_seeds_give_the_same_work(cfg):
    """Two seeds, and two jobs of one seed: the same pairs, family sizes
    and lengths, other sequences."""
    a = jobs.make_jobs(config(cfg), traffic(), 5)
    b = jobs.make_jobs(config(cfg), traffic(), 6)
    for x in a[1:] + b:
        assert (x.pairs == a[0].pairs).all()
        assert (x.lens == a[0].lens).all()
        assert sorted(np.bincount(x.family)) == sorted(
            np.bincount(a[0].family))
    assert not (a[0].codes_list[0] == b[0].codes_list[0]).all()
    assert not (a[0].codes_list[0] == a[1].codes_list[0]).all()


@pytest.mark.parametrize('cfg,mix,per_genome', CELLS)
def test_cell_plan(cfg, mix, per_genome):
    """The cells' own plans: largest family first, sizes and lengths
    inside their laws, the pairs a genome the plan was chosen for."""
    t = json.loads((BENCH / 'traffic' / f'{mix}.json').read_text())
    st = jobs.job_stats(config(cfg), t)
    assert abs(st['pairs_per_genome'] - per_genome) < 0.01
    p = jobs.plan(t)
    assert [s for s, _ in p] == sorted((s for s, _ in p), reverse=True)
    sizes = jobs.family_sizes(t['family_size'], t['families'])
    assert sizes.min() >= t['family_size']['min']
    assert sizes.max() <= t['family_size']['max']
    lens = jobs.genome_lengths(t['length'], t['families'])
    assert lens.min() >= t['length'].get('min', 1)
    assert lens.max() <= t['length'].get('max', lens.max())


def test_complete_pairs_mostly_unequal():
    """The vOTU cell's members keep 85-100% of their base: nearly every
    pair's lengths differ by more than the hybrid's 0.3%."""
    t = json.loads((BENCH / 'traffic' / 'complete.json').read_text())
    st = jobs.job_stats(config('imgvr_votu'), t)
    assert st['unequal_pairs'] > 0.95 * st['pairs']
    assert max(st['pairs_by_bucket']) > 131072          # v2 alone, too
    # The stand-in: the same plan with the bases clipped to 131,072.
    s = json.loads((BENCH / 'traffic' / 'complete_131k.json').read_text())
    assert dict(s, length=None) == dict(t, length=None)
    st = jobs.job_stats(config('imgvr_votu'), s)
    assert max(st['pairs_by_bucket']) == 131072
    assert st['pairs'] == 23764 and st['genomes'] == 1735


def test_member_lengths_keep_their_share():
    cfg = config('imgvr_votu')
    t = json.loads((BENCH / 'traffic' / 'complete.json').read_text())
    levels = jobs.job_levels(cfg, t)
    assert 'kept_share' not in cfg['levels'][-1]
    want = jobs.member_lengths(40000, levels[-1], 7)
    assert sorted(want) == sorted(
        round(40000 * s) for s in jobs.spread(t['kept_share'], 7))
    fam = jobs.make_family(jobs.Maker(np.random.default_rng(9),
                                      jobs.load_pool(), cfg),
                           7, 40000, levels)
    assert [len(g) for g in fam] == want.tolist()
    assert 0.85 * 40000 <= min(want) and max(want) <= 40000


def test_whole_members_keep_the_base_length():
    """The stand-in's traffic: complete's plan, every member of a family
    at its base's length; its warm-up's pairs are of unequal lengths at
    every bucket, so that they run v2 there too."""
    cfg = config('imgvr_votu')
    t = json.loads((BENCH / 'traffic' / 'complete.json').read_text())
    w = json.loads((BENCH / 'traffic' / 'whole.json').read_text())
    assert dict(w, kept_share=t['kept_share']) == t
    st = jobs.job_stats(cfg, w)
    assert st['unequal_pairs'] == 0 and st['pairs'] == 23764
    assert max(st['pairs_by_bucket']) > 131072
    j = jobs.make_jobs(cfg, dict(w, jobs=1), 8)[0]
    assert (j.lens[j.pairs[:, 0]] == j.lens[j.pairs[:, 1]]).all()
    a = jobs.make_warmup(cfg, w, 8)
    kb = {jobs.pad_bucket(int(max(a.lens[i], a.lens[j])))
          for i, j in a.pairs}
    assert kb == set(st['pairs_by_bucket'])
    # The stand-in in BENCHMARK.json: the same with the bases clipped to
    # 131,072 (no pair on v2 alone).
    c = json.loads((BENCH / 'traffic' / 'whole_131k.json').read_text())
    assert dict(c, length=None) == dict(w, length=None)
    assert c['length'] == dict(w['length'], max=131072)
    sc = jobs.job_stats(cfg, c)
    assert max(sc['pairs_by_bucket']) == 131072 and sc['pairs'] == 23764
    lo = np.minimum(a.lens[a.pairs[:, 0]], a.lens[a.pairs[:, 1]])
    hi = np.maximum(a.lens[a.pairs[:, 0]], a.lens[a.pairs[:, 1]])
    assert (lo < 0.997 * hi).all()


def test_warmup_covers_every_bucket():
    """The warm-up job has pairs at every bucket the cell's pairs reach,
    is small, and has the same sizes on every seed."""
    cfg = config('imgvr_votu')
    t = json.loads((BENCH / 'traffic' / 'complete.json').read_text())
    st = jobs.job_stats(cfg, t)
    pool = jobs.load_pool()
    a = jobs.make_warmup(cfg, t, 5, pool)
    b = jobs.make_warmup(cfg, t, 2 ** 31 + 6, pool)
    assert (a.lens == b.lens).all() and (a.pairs == b.pairs).all()
    kb = {jobs.pad_bucket(int(max(a.lens[i], a.lens[j])))
          for i, j in a.pairs}
    assert kb == set(st['pairs_by_bucket'])
    assert len(a.pairs) < 0.01 * st['pairs']
    # Its pairs are of unequal lengths: the hybrid re-runs them on v2.
    lo = np.minimum(a.lens[a.pairs[:, 0]], a.lens[a.pairs[:, 1]])
    hi = np.maximum(a.lens[a.pairs[:, 0]], a.lens[a.pairs[:, 1]])
    assert (lo < 0.997 * hi).all()
    # Not the cell's own first job.
    j = jobs.make_jobs(cfg, dict(t, jobs=1), 5, pool)[0]
    assert not any((g == j.codes_list[0][:len(g)]).all()
                   for g in a.codes_list if len(g) <= j.lens[0])


def test_job_pairs_are_the_families():
    j = jobs.make_jobs(config('ictv_species'), traffic(), 3)[0]
    assert (j.pairs[:, 0] < j.pairs[:, 1]).all()
    assert (j.family[j.pairs[:, 0]] == j.family[j.pairs[:, 1]]).all()
    n = np.bincount(j.family)
    assert len(j.pairs) == int((n * (n - 1) // 2).sum())
    assert (np.diff(j.lens) <= 0).all()
    for c in j.codes_list:
        assert c.dtype == np.int8 and c.min() >= 0 and c.max() <= 3


def test_descend_divergence_and_length():
    """A level's substitutions change the share of bases it names, and
    indels and gene-sized replacements keep the length."""
    mk = jobs.Maker(np.random.default_rng(4), jobs.load_pool(),
                    config('ictv_species'))
    base = mk.fresh(50000)
    sub = mk.descend(base, dict(divergence=[0, 0]), 0.04)
    assert abs((sub != base).mean() - 0.04) < 0.002
    lvl = config('ictv_species')['levels'][0]
    for d in (0.0, 0.1):
        assert len(mk.descend(base, lvl, d)) == len(base)


def test_apply_indels():
    seq = np.arange(20)
    out = jobs.apply_indels(
        seq, [(2, 3), (4, 2), (15, 10)],
        [(0, np.array([-1])), (3, np.array([-2, -2])), (10, np.array([-3])),
         (20, np.array([-9]))])
    assert out.tolist() == [-1, 0, 1, -2, -2, 6, 7, 8, 9, -3, 10, 11, 12,
                            13, 14, -9]
