"""The port's tracer (vclust_tpu_torch/utils/trace.py) and the align
engine's spans and counters (ops/align_gpu.py), on the CPU, without the
JAX package.

A job of the hybrid corpus (tests/hybrid_cases.py: 21 pairs at bucket
4,096, a proper subset re-run on v2) through `all2all_gpu(...,
device='cpu')`, with and without records, the tracer on and off: the
results are bit-identical; off, nothing is recorded; on, every span nests
inside its parent and carries its job's id, `prep_s` is the sum of the
`index.fill` and `index.upload` spans, and the counters agree with
wrappers of the calls they count; under torch.profiler alone the calls
record into `trace.profiled()`."""

import json

import numpy as np
import pytest
import torch

from hybrid_cases import hybrid_genomes
from vclust_tpu_torch.models import align as talign
from vclust_tpu_torch.ops import align_gpu as ag
from vclust_tpu_torch.utils import trace

# Six pytest workers share the machine: one torch thread each.
torch.set_num_threads(1)

CPU = torch.device('cpu')
NAMES = {'job', 'pipe', 'pipe.group', 'index.build', 'index.fill',
         'index.upload', 'index.kernels', 'pipe.rows', 'dispatch.upload',
         'dispatch.launch', 'pipe.to_host', 'pipe.scatter'}
SMALL = np.array([(0, 1), (0, 2), (1, 2)], dtype=np.int32)


def _corpus():
    gs = hybrid_genomes()
    codes = [talign._genome_codes(gs[i]) for i in talign.order_objects(gs)]
    n = len(codes)
    pairs = np.array([(i, j) for i in range(n) for j in range(i + 1, n)],
                     dtype=np.int32)
    return codes, pairs


class Calls:
    """Counts, while entered, the row-core calls, the arena builds (one
    `index_v3_empty` or `index_v2_empty` a build) and the tensors copied
    back to the host (`Tensor.cpu`)."""

    def __init__(self, mp):
        self.rows = self.builds = self.back = 0

        def counting(fn, what):
            def run(*args, **kw):
                setattr(self, what, getattr(self, what) + 1)
                return fn(*args, **kw)
            return run
        for name in ('_row_core_v3', '_row_core'):
            mp.setattr(ag, name, counting(getattr(ag, name), 'rows'))
        for name in ('index_v3_empty', 'index_v2_empty'):
            mp.setattr(ag, name, counting(getattr(ag, name), 'builds'))
        mp.setattr(torch.Tensor, 'cpu', counting(torch.Tensor.cpu, 'back'))


def _run(codes, pairs, keep, on):
    """(result, index, Record or None, Calls) of one all2all_gpu call."""
    idx = ag.GenomeIndex(codes, device=CPU)
    with pytest.MonkeyPatch.context() as mp:
        calls = Calls(mp)
        if on:
            with trace.recording() as rec:
                out = ag.all2all_gpu(codes, pairs, index=idx,
                                     keep_alignments=keep)
        else:
            rec = None
            out = ag.all2all_gpu(codes, pairs, index=idx,
                                 keep_alignments=keep)
    return out, idx, rec, calls


@pytest.fixture(scope='module', params=[False, True], ids=['aggs', 'recs'])
def runs(request):
    codes, pairs = _corpus()
    keep = request.param
    return keep, _run(codes, pairs, keep, False), \
        _run(codes, pairs, keep, True)


def test_results_identical_on_and_off(runs):
    keep, off, on = runs
    if keep:
        assert np.array_equal(off[0][0], on[0][0])
        assert np.array_equal(off[0][1][0], on[0][1][0])
        assert np.array_equal(off[0][1][1], on[0][1][1])
    else:
        assert off[0].dtype == on[0].dtype == np.int64
        assert np.array_equal(off[0], on[0])
    assert off[3].rows == on[3].rows and off[3].back == on[3].back


def test_off_records_nothing():
    codes, pairs = _corpus()
    with trace.recording() as rec:
        pass
    assert not rec.spans and not rec.counters
    assert trace.span('job') is trace.span('pipe', pipe='v3')
    ag.all2all_gpu(codes[:3], SMALL, device=CPU)
    trace.count('host_syncs')
    trace.add_span('index.fill', 0.0, 1.0)
    assert not rec.spans and not rec.counters
    assert trace._rec is None


def test_recording_is_one_at_a_time():
    with trace.recording():
        with pytest.raises(RuntimeError):
            trace.recording().__enter__()
    assert trace._rec is None


def test_spans_nest_and_carry_the_job(runs):
    _, _, (_, _, rec, _) = runs
    spans = rec.spans
    assert {s.name for s in spans} == NAMES
    assert spans[0].name == 'job' and spans[0].parent is None
    assert spans[0].attrs == {'pairs': 21}
    for i, s in enumerate(spans):
        assert s.start <= s.end and s.job == 0
        if i:
            p = spans[s.parent]
            assert s.parent < i
            assert p.start <= s.start and s.end <= p.end
    # Both pipes: v3 on every pair, v2 on the hard ones.
    pipes = [s.attrs for s in spans if s.name == 'pipe']
    assert [p['pipe'] for p in pipes] == ['v3', 'v2']
    assert pipes[0]['pairs'] == 21 and 0 < pipes[1]['pairs'] < 21
    builds = [s.attrs for s in spans if s.name == 'index.build']
    assert [b['key'] for b in builds] == [(4096, 'v3'),
                                          (4096, ag.SEEDS_PER_BLOCK)]
    parent = {s.name: spans[s.parent].name for s in spans
              if s.parent is not None}
    assert parent == {
        'pipe': 'job', 'pipe.group': 'pipe', 'index.build': 'pipe',
        'index.fill': 'index.build', 'index.upload': 'index.build',
        'index.kernels': 'index.build', 'pipe.rows': 'pipe',
        'dispatch.upload': 'pipe', 'dispatch.launch': 'pipe',
        'pipe.to_host': 'pipe', 'pipe.scatter': 'pipe'}


def test_jobs_take_their_own_ids():
    codes, pairs = _corpus()
    with trace.recording() as rec:
        for _ in range(2):
            ag.all2all_gpu(codes[:3], SMALL, device=CPU)
    jobs = [s for s in rec.spans if s.name == 'job']
    assert [s.job for s in jobs] == [0, 1]
    assert {s.job for s in rec.spans} == {0, 1}
    first = rec.spans.index(jobs[1])
    assert all(s.job == 0 for s in rec.spans[:first])


def test_profiled_jobs_record_without_recording():
    """Under torch.profiler, with no recording() on, each engine call
    records into profiled(): a fresh record after an unprofiled call, the
    same one while the calls stay profiled; recording() takes precedence."""
    from torch.profiler import ProfilerActivity, profile
    codes, _ = _corpus()
    ag.all2all_gpu(codes[:3], SMALL, device=CPU)
    with profile(activities=[ProfilerActivity.CPU]):
        ag.all2all_gpu(codes[:3], SMALL, device=CPU)
        first = trace.profiled()
        ag.all2all_gpu(codes[:3], SMALL, device=CPU)
    assert trace._rec is None and trace.profiled() is first
    jobs = [s for s in first.spans if s.name == 'job']
    assert [s.job for s in jobs] == [0, 1]
    assert {s.name for s in first.spans} == NAMES
    assert first.counters['dispatches'] > 0
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.recording() as rec:
            ag.all2all_gpu(codes[:3], SMALL, device=CPU)
    assert trace.profiled() is first and len(rec.spans) > 0
    ag.all2all_gpu(codes[:3], SMALL, device=CPU)
    assert trace.profiled() is first
    with profile(activities=[ProfilerActivity.CPU]):
        ag.all2all_gpu(codes[:3], SMALL, device=CPU)
    again = trace.profiled()
    assert again is not first
    assert [s.job for s in again.spans if s.name == 'job'] == [0]


def test_prep_s_is_fill_plus_upload(runs):
    _, _, (_, idx, rec, _) = runs
    parts = sum(s.end - s.start for s in rec.spans
                if s.name in ('index.fill', 'index.upload'))
    assert idx.prep_s > 0
    assert idx.prep_s == pytest.approx(parts, rel=1e-12, abs=0)


def test_counters_match_the_calls(runs):
    keep, _, (_, _, rec, calls) = runs
    c = rec.counters
    assert c['dispatches'] == calls.rows > 0
    assert calls.builds == 2
    # 1 tensor a dispatch copied back, 3 with records.
    assert calls.back == (3 if keep else 1) * calls.rows
    assert c['host_syncs'] == 4 * calls.rows + calls.back + 2 * calls.builds
    assert set(c) == {'dispatches', 'host_syncs'}
    assert sum(s.name == 'dispatch.launch' for s in rec.spans) == calls.rows


def test_write_chrome(tmp_path):
    """The spans as a track of their own, moved by the anchor onto the
    device timeline where the trace holds the anchor's kernel; on the host
    clock, said so, where it does not."""
    rec = trace.Record()
    rec.spans = [trace.Span('job', 2.0, 2.5, None, 0, {'pairs': 3}),
                 trace.Span('pipe', 2.1, 2.4, 0, 0, {'pipe': 'v3'})]
    rec.counters.update(dispatches=2, host_syncs=11)
    path = tmp_path / 'x.trace.json'
    spin = {'ph': 'X', 'cat': 'kernel', 'name': 'spin_kernel(long)',
            'pid': 0, 'tid': 7, 'ts': 1_000_000.0, 'dur': 2.0,
            'args': {'correlation': 5}}
    call = {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
            'pid': 1, 'tid': 1, 'ts': 999_990.0, 'dur': 3.0,
            'args': {'correlation': 5}}
    k2 = {'ph': 'X', 'cat': 'kernel', 'name': 'stage1_kernel', 'pid': 0,
          'tid': 7, 'ts': 1_500_000.0, 'dur': 5.0}
    # By the launch call where the trace holds it, else by the kernel.
    for events, anchor, shift in (([spin, call, k2], 1.9, 999_990 - 1.9e6),
                                  ([spin, k2], 1.9, 1_000_000 - 1.9e6),
                                  ([spin, call, k2], None, 0.0)):
        path.write_text(json.dumps({'traceEvents': events}))
        rec.anchor = anchor
        meta = trace.write_chrome(rec, path)
        got = json.loads(path.read_text())
        assert got['vclust'] == meta
        assert meta['counters'] == {'dispatches': 2, 'host_syncs': 11}
        assert ('anchor_offset_us' in meta) == (anchor is not None)
        assert ('host' in meta['clock']) == (anchor is None)
        ev = got['traceEvents']
        track = [e for e in ev if e.get('ph') == 'M']
        assert track[0]['args']['name'] == trace.TRACK
        mine = [e for e in ev if e.get('cat') == 'vclust']
        assert {e['pid'] for e in mine} == {track[0]['pid']} != {0}
        assert [e['name'] for e in mine] == ['job', 'pipe']
        assert mine[0]['ts'] == pytest.approx(2.0e6 + shift)
        assert mine[1]['dur'] == pytest.approx(0.3e6)
        assert mine[1]['args'] == {'pipe': 'v3', 'job': 0, 'parent': 0}
