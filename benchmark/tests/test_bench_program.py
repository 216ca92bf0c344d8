"""The per-layer metrics read from the program's own spans and counters
(program_record.py, vclust_tpu_torch/utils/trace.py) on the CPU: on a
hand-made record, on the engine's record of a job under torch.profiler
beside the harness's wrappers, without a record; and tools/gap_split.py's
gap names."""

import importlib
import sys
import time

import pytest

import jobs
import program_record
import tracing
from conftest import ROOT
from tiny import config, traffic
from vclust_tpu_torch.utils import trace

sys.path.insert(0, str(ROOT / 'tools'))
import gap_split  # noqa: E402

METRICS = ('index_fill_share', 'index_upload_share', 'pipe_grouping_share',
           'syncs_per_dispatch')


def _read(name, t):
    return importlib.import_module(f'metrics.{name}').read(t)


def _record(spans, counters):
    rec = trace.Record()
    rec.spans = [trace.Span(n, a, b, None, 0, {}) for n, a, b in spans]
    rec.counters.update(counters)
    return rec


def test_readers_on_a_hand_made_record(monkeypatch):
    rec = _record([('job', 0, 10), ('pipe', 0, 9), ('pipe.group', 0, 0.5),
                   ('index.build', 0.5, 3), ('index.fill', 0.5, 2),
                   ('index.upload', 2, 2.25), ('index.kernels', 2.25, 3),
                   ('pipe.rows', 3, 3.5), ('dispatch.upload', 3.5, 4),
                   ('pipe.to_host', 8, 8.5), ('pipe.scatter', 8.5, 9),
                   ('index.fill', 9, 9.5)],
                  {'dispatches': 4, 'host_syncs': 22})
    monkeypatch.setattr(trace, '_profiled', rec)
    t = dict(window_s=20.0, counters={'jobs': 1})
    assert _read('index_fill_share', t) == pytest.approx(100 * 2 / 20)
    assert _read('index_upload_share', t) == pytest.approx(100 * .25 / 20)
    assert _read('pipe_grouping_share', t) == pytest.approx(100 * 1.5 / 20)
    assert _read('syncs_per_dispatch', t) == pytest.approx(5.5)
    # A record of other jobs than the window's is not read.
    for name in METRICS:
        assert _read(name, dict(t, counters={'jobs': 2})) is None


def test_readers_without_a_record(monkeypatch):
    t = dict(window_s=20.0, counters={'jobs': 1})
    monkeypatch.setattr(trace, '_profiled', None)
    for name in METRICS:
        assert _read(name, t) is None
    monkeypatch.setattr(trace, '_profiled', _record([('job', 0, 1)], {}))
    for name in METRICS:
        assert _read(name, t) is None
    # An older program, without the tracer.
    import vclust_tpu_torch.utils as utils
    monkeypatch.delattr(utils, 'trace')
    monkeypatch.setitem(sys.modules, 'vclust_tpu_torch.utils.trace', None)
    assert program_record.record(t) is None
    for name in METRICS:
        assert _read(name, t) is None


def test_readers_on_the_engine_under_a_profiler():
    """A job under torch.profiler beside the harness's wrappers: the
    program records it with no recording() on, the two index shares make
    up index_prep_share, and the dispatches agree with the harness's."""
    from torch.profiler import ProfilerActivity, profile
    from vclust_tpu_torch.ops import align_gpu as ag
    j = jobs.make_jobs(config('ictv_species'), traffic(jobs=1), 5)[0]
    ag.all2all_gpu(j.codes_list, j.pairs, device='cpu')   # unprofiled
    rec = tracing.Recorder(ag)
    with profile(activities=[ProfilerActivity.CPU]), rec:
        t0 = time.perf_counter()
        ag.all2all_gpu(j.codes_list, j.pairs, device='cpu')
        t1 = time.perf_counter()
        rec.job(t0, t1, len(j.pairs))
    assert trace._rec is None
    program = trace.profiled()
    assert sum(s.name == 'job' for s in program.spans) == 1
    c = rec.counters()
    t = dict(window_s=t1 - t0, counters=c)
    got = {n: _read(n, t) for n in METRICS + ('index_prep_share',)}
    assert all(v is not None and v > 0 for v in got.values())
    assert got['index_fill_share'] + got['index_upload_share'] == \
        pytest.approx(got['index_prep_share'], rel=1e-9)
    assert program.counters['dispatches'] == \
        c['dispatches_v3'] + c['dispatches_v2']
    assert got['syncs_per_dispatch'] > 5      # 4 up, 1 back, 2 a build
    assert {n for n, _, _ in gap_split.leaves(program)} == \
        {n for n, _ in gap_split.LEAVES}


def test_gap_split_names_gaps_by_the_program(monkeypatch):
    """A gap under the harness's pipe.v3 span with the program's
    pipe.group inside it splits between the two names; the total stays."""
    monkeypatch.setattr(tracing, 'GAP_NAMES', tracing.GAP_NAMES)
    monkeypatch.setattr(tracing, 'read_device_trace',
                        tracing.read_device_trace)
    harness = [('job', 0, 10), ('pipe.v3', 1, 8), ('dispatch.v3', 5, 6)]
    program = [('pipe.group', 2, 3), ('dispatch.launch', 4.9, 6.1)]
    busy, gaps = tracing._union_and_gaps([(0, 1.5), (5.5, 10)], 0, 10)
    before = tracing._name_gaps(gaps, harness)
    gap_split.install()
    lbl = dict(tracing.GAP_NAMES)
    after = tracing._name_gaps(gaps, harness + program)
    assert before[lbl['pipe.v3']] == pytest.approx(3.5)
    assert after[lbl['pipe.v3']] == pytest.approx(2.4)
    assert after[lbl['pipe.group']] == pytest.approx(1)
    assert after[lbl['dispatch.launch']] == pytest.approx(0.6)
    assert lbl['dispatch.v3'] not in after
    assert sum(after.values()) == pytest.approx(sum(before.values()))
    assert sum(after.values()) == pytest.approx(10 - busy)
    assert gap_split.leaves(None) == []
