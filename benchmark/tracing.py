"""The traced run's instruments: the harness's spans and counters around
the layers of the port's align engine, and the device trace.

`Recorder` wraps, while it is entered, the engine's entry points as the
window drives them (the harness's copy of the smoke test's pipe timer):
`_all2all_single` (a span a pipe call; the pairs, buckets and tasks each
pipe aligned), the row cores `_row_core_v3` and `_row_core` (a span and a
count a dispatch) and `GenomeIndex._build` (a span a build, and the
program's own `prep_s` it adds). No span synchronises with the card: the
traced window keeps the overlap of the host's work with the device's that
the timed window has.

`read_device_trace` reads torch.profiler's trace (device activity only):
the busy time of the card, each kernel's time, and the idle gaps, each
put under the innermost harness span the host was in when it began, in
host time by a marker kernel launched at a known instant.
"""

import collections
import json
import os
import re
import tempfile
import time

import numpy as np

from jobs import pad_bucket
from roofline import V3_MAX_BUCKET, k2_ops, k6_least

# Idle gaps are named by the innermost span open on the host, in this
# order of depth.
GAP_NAMES = (
    ('dispatch.v3', 'v3 dispatch launches (_row_core_v3)'),
    ('dispatch.v2', 'v2 dispatch launches (_row_core)'),
    ('index.prep', 'index preparation (padding, reverse complements, '
                   'uploads)'),
    ('index.build', 'index kernels and arena allocation (K9, K10 '
                    'wrappers)'),
    ('pipe.v3', 'v3 pipe outside dispatches and index (grouping, copies '
                'back)'),
    ('pipe.v2', 'v2 pipe outside dispatches and index (grouping, copies '
                'back)'),
    ('job', 'hybrid selection and merge (all2all_gpu outside the pipes)'),
)
OUTSIDE = 'between jobs (the harness)'


class Recorder:
    """Spans (name, start, end) in perf_counter seconds and counters of the
    window (see the module docstring)."""

    def __init__(self, ag):
        self.ag = ag
        self.spans = []
        self.calls = []           # (pipe, C, lens, pairs) a pipe call
        self.dispatches = collections.Counter()
        self.prep_s = 0.0
        self.jobs = []            # pairs an align call

    def __enter__(self):
        ag = self.ag
        self._real = (ag._all2all_single, ag._row_core_v3, ag._row_core,
                      ag.GenomeIndex._build)
        real_single, real_v3, real_v2, real_build = self._real
        spans, calls = self.spans, self.calls
        clock = time.perf_counter

        def single(codes, pairs, params=None, index=None,
                   keep_alignments=False, seeds_per_block=None, pipe='v2',
                   device=None, mesh=None):
            t0 = clock()
            try:
                return real_single(codes, pairs, params, index,
                                   keep_alignments, seeds_per_block, pipe,
                                   device, mesh)
            finally:
                spans.append((f'pipe.{pipe}', t0, clock()))
                calls.append((pipe, seeds_per_block,
                              index.lens if index is not None else
                              np.array([len(c) for c in codes]),
                              np.asarray(pairs).reshape(-1, 2)))

        def core(pipe, real):
            def run(*args, **kw):
                t0 = clock()
                try:
                    return real(*args, **kw)
                finally:
                    spans.append((f'dispatch.{pipe}', t0, clock()))
                    self.dispatches[pipe] += 1
            return run

        def build(index, *args, **kw):
            p0 = index.prep_s
            t0 = clock()
            try:
                return real_build(index, *args, **kw)
            finally:
                t1 = clock()
                dp = index.prep_s - p0
                self.prep_s += dp
                spans.append(('index.build', t0, t1))
                spans.append(('index.prep', t0, t0 + dp))

        ag._all2all_single = single
        ag._row_core_v3 = core('v3', real_v3)
        ag._row_core = core('v2', real_v2)
        ag.GenomeIndex._build = build
        return self

    def __exit__(self, *exc):
        ag = self.ag
        (ag._all2all_single, ag._row_core_v3, ag._row_core,
         ag.GenomeIndex._build) = self._real
        return False

    def job(self, t0, t1, n_pairs):
        self.spans.append(('job', t0, t1))
        self.jobs.append(n_pairs)

    def counters(self) -> dict:
        """The counters of the window, and the least work of K2 and K6 over
        the pairs each pipe aligned."""
        pairs = {'v3': 0, 'v2': 0}
        k2 = 0.0
        k6_bytes = k6_slots = 0.0
        cache = {}
        for pipe, C, lens, pr in self.calls:
            pairs[pipe] += len(pr)
            if not len(pr):
                continue
            key = (pipe, lens.tobytes(), pr.tobytes())
            if key not in cache:
                pb = np.array([pad_bucket(int(L)) for L in lens])
                kb = np.maximum(pb[pr[:, 0]], pb[pr[:, 1]])
                v3 = (kb <= V3_MAX_BUCKET) if pipe == 'v3' else \
                    np.zeros(len(kb), bool)
                li, lj = lens[pr[v3, 0]], lens[pr[v3, 1]]
                ops = k2_ops(lj, li) + k2_ops(li, lj)
                nb, sl = (k6_least(lens, pr[~v3], kb[~v3]) if (~v3).any()
                          else (0.0, 0.0))
                cache[key] = (ops, nb, sl)
            ops, nb, sl = cache[key]
            k2 += ops
            k6_bytes += nb
            k6_slots += sl
        return dict(pairs_v3_calls=pairs['v3'], pairs_v2_calls=pairs['v2'],
                    pairs=sum(self.jobs), jobs=len(self.jobs),
                    dispatches_v3=self.dispatches['v3'],
                    dispatches_v2=self.dispatches['v2'],
                    tasks=2 * (pairs['v3'] + pairs['v2']),
                    prep_s=self.prep_s,
                    k2_ops=k2, k6_bytes=k6_bytes, k6_slots=k6_slots)


def profile(torch):
    """A torch.profiler of the card's activity alone."""
    from torch.profiler import ProfilerActivity, profile as prof
    return prof(activities=[ProfilerActivity.CUDA])


def marker(torch) -> float:
    """Launch the marker kernel (a short spin) on an idle card; returns the
    host instant of the launch."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return t


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces and argument
    list."""
    name = name.replace('(anonymous namespace)::', '')
    name = re.sub(r'^void ', '', name).strip()
    if name.endswith(')'):
        depth = 0
        for k in range(len(name) - 1, -1, -1):
            depth += {')': 1, '(': -1}.get(name[k], 0)
            if depth == 0:
                name = name[:k].strip() or name
                break
    return re.sub(r'\b[A-Za-z_]\w*::', '', name)


def read_device_trace(prof, t_marker: float, t0: float, t1: float,
                      spans: list) -> dict:
    """Busy seconds of the card in the host window [t0, t1], each device
    operation's seconds (by short name) and the idle gaps' seconds by the
    innermost span the host was in (GAP_NAMES), from the profiler's trace
    aligned to the host clock by the marker kernel launched at t_marker."""
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    finally:
        os.unlink(path)
    events = events.get('traceEvents', events) \
        if isinstance(events, dict) else events
    dev = [e for e in events if e.get('ph') == 'X' and e.get('cat') in
           ('kernel', 'gpu_memcpy', 'gpu_memset')]
    marks = [e for e in dev if 'spin_kernel' in e.get('name', '')]
    if not marks:
        raise RuntimeError('device trace: the marker kernel is missing')
    # Device instant (us) -> host instant (s).
    off = marks[0]['ts'] * 1e-6 - t_marker
    ops = collections.Counter()
    iv = []
    for e in dev:
        if e is marks[0]:
            continue
        a = e['ts'] * 1e-6 - off
        b = a + e['dur'] * 1e-6
        a, b = max(a, t0), min(b, t1)
        if b > a:
            iv.append((a, b))
            ops[_short(e['name'])] += b - a
    busy, gaps = _union_and_gaps(iv, t0, t1)
    return dict(busy_s=busy, device_ops=ops, idle_gaps=_name_gaps(gaps,
                                                                   spans),
                events=len(dev))


def _union_and_gaps(iv, t0, t1):
    """(length of the union of intervals iv inside [t0, t1], the gaps
    between them in [t0, t1])."""
    iv.sort()
    busy = 0.0
    gaps = []
    cs = ce = t0
    for a, b in iv:
        if a > ce:
            busy += ce - cs
            gaps.append((ce, a))
            cs = a
        ce = max(ce, b)
    busy += ce - cs
    if t1 > ce:
        gaps.append((ce, t1))
    return busy, gaps


def _name_gaps(gaps, spans) -> dict:
    """Seconds of the gaps under each span name: each piece of a gap goes to
    the deepest span (GAP_NAMES order) open over it, else OUTSIDE."""
    depth = {n: d for d, (n, _) in enumerate(GAP_NAMES)}
    label = dict(GAP_NAMES)
    cuts = []
    for n, a, b in spans:
        if n in depth and b > a:
            cuts.append((a, 1, depth[n]))
            cuts.append((b, -1, depth[n]))
    cuts.sort()
    out = collections.Counter()
    open_ = collections.Counter()
    k = 0
    for g0, g1 in gaps:
        t = g0
        while k < len(cuts) and cuts[k][0] <= t:
            open_[cuts[k][2]] += cuts[k][1]
            k += 1
        while t < g1:
            nxt = cuts[k][0] if k < len(cuts) else g1
            seg_end = min(nxt, g1)
            live = [d for d, c in open_.items() if c > 0]
            name = label[GAP_NAMES[min(live)][0]] if live else OUTSIDE
            out[name] += seg_end - t
            t = seg_end
            while k < len(cuts) and cuts[k][0] <= t:
                open_[cuts[k][2]] += cuts[k][1]
                k += 1
    return out
