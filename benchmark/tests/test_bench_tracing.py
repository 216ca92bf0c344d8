"""The traced run's instruments on the CPU: the spans and counters around
the engine, the least-work counts, the idle gaps' names and the per-layer
readers. (The device trace itself is read on the card.)"""

import importlib
import json
import time

import numpy as np
import pytest

import jobs
import roofline
import tracing
from conftest import ROOT
from tiny import config, traffic

SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())


@pytest.fixture(scope='module')
def recorded():
    from vclust_tpu_torch.ops import align_gpu as ag
    j = jobs.make_jobs(config('ictv_species'), traffic(jobs=1), 5)[0]
    rec = tracing.Recorder(ag)
    real = ag._all2all_single
    with rec:
        t0 = time.perf_counter()
        out = ag.all2all_gpu(j.codes_list, j.pairs, device='cpu')
        rec.job(t0, time.perf_counter(), len(j.pairs))
    assert ag._all2all_single is real          # unwrapped on exit
    return j, out, rec


def test_counters(recorded):
    j, out, rec = recorded
    c = rec.counters()
    assert c['pairs'] == c['pairs_v3_calls'] == len(j.pairs)
    assert 0 < c['pairs_v2_calls'] < len(j.pairs)
    assert c['tasks'] == 2 * (c['pairs_v3_calls'] + c['pairs_v2_calls'])
    assert c['dispatches_v3'] > 0 and c['dispatches_v2'] > 0
    assert 0 < c['prep_s'] <= sum(b - a for n, a, b in rec.spans
                                   if n == 'index.build')
    li, lj = j.lens[j.pairs[:, 0]], j.lens[j.pairs[:, 1]]
    assert c['k2_ops'] == roofline.k2_ops(lj, li) + roofline.k2_ops(li, lj)
    assert c['k6_bytes'] > 0 and c['k6_slots'] > 0


def test_k2_ops_from_lengths():
    # 2 operations x (65,536 / 64) half-blocks x 2,048 blocks x H.
    assert roofline.k2_ops([65536], [65536]) == 2 * 1024 * 2048 * 2048
    # A query of 50,000 bases against a reference of 40,001: 782 half-blocks
    # and 1,251 blocks, whatever the bucket they are padded to.
    assert roofline.k2_ops([50000], [40001]) == 2 * 782 * 1251 * 2048
    assert roofline.k2_ops([50000, 1], [1, 50000]) == \
        2 * 2048 * (782 + 1563)


def test_k6_counts_seeds():
    """min(C, valid 8-mers) a fine block: 93 valid k-mers in 100 bases
    (blocks of 32, 32, 29), 63 in 70 (32, 31)."""
    assert roofline.seeds_per_block(100, 4096)[:4].tolist() == [16, 16, 16, 0]
    assert roofline.seeds_per_block(70, 4096)[:3].tolist() == [16, 16, 0]
    assert roofline.seeds_per_block(70, 4096).sum() == 32


def test_gaps_named_by_deepest_span():
    spans = [('job', 0, 10), ('pipe.v3', 1, 6), ('index.build', 1, 3),
             ('index.prep', 1, 2), ('dispatch.v3', 4, 5)]
    busy, gaps = tracing._union_and_gaps([(2.5, 4.2), (5, 7)], 0, 11)
    assert busy == pytest.approx(3.7)
    named = tracing._name_gaps(gaps, spans)
    lbl = dict(tracing.GAP_NAMES)
    assert named[lbl['index.prep']] == pytest.approx(1)
    assert named[lbl['index.build']] == pytest.approx(0.5)
    assert named[lbl['dispatch.v3']] == pytest.approx(0.8)
    assert named[lbl['job']] == pytest.approx(4)
    assert named[tracing.OUTSIDE] == pytest.approx(1)
    assert sum(named.values()) == pytest.approx(11 - 3.7)


def test_short_names():
    assert tracing._short('void (anonymous namespace)::stage1_kernel<2, '
                          '256>(CUtensorMap_st, int const*)') \
        == 'stage1_kernel<2, 256>'
    assert tracing._short('Memcpy HtoD (Pageable -> Device)') == \
        'Memcpy HtoD'
    assert tracing._short('void front_kernel<(bool)0>(int*)') == \
        'front_kernel<(bool)0>'


def test_readers(recorded):
    _, _, rec = recorded
    c = rec.counters()
    data = dict(window_s=2.0, busy_s=0.5, counters=c, peak_bytes=2 ** 31,
                device_ops={'stage1_kernel<2, 256>': 0.01,
                            'front_kernel<2, false>': 0.02})
    got = {m['name']: importlib.import_module(f"metrics.{m['name']}")
           .read(data) for m in SPEC['per_layer']}
    assert got['device_idle_share'] == pytest.approx(75.0)
    assert got['peak_device_gib'] == pytest.approx(2.0)
    assert got['v2_pairs_per_pair'] == c['pairs_v2_calls'] / c['pairs']
    assert got['k2_roofline'] == pytest.approx(
        100 * c['k2_ops'] / roofline.INT8_TENSOR_OPS_PER_S / 0.01)
    # The host's preparation plus the index kernels' device time.
    idx = dict(data, device_ops={'index_v3_kernel': 0.1,
                                 'index_v2_pass<Item>': 0.05,
                                 'stage1_kernel<2, 256>': 0.01})
    assert importlib.import_module('metrics.index_share').read(idx) == \
        pytest.approx(100 * (c['prep_s'] + 0.15) / 2.0)
    # Nothing to read: no value (never a 0 share).
    none = dict(data, device_ops={}, busy_s=0.0)
    for name in ('k2_roofline', 'k6_roofline', 'device_idle_share',
                 'index_share'):
        assert importlib.import_module(f'metrics.{name}').read(none) is None
