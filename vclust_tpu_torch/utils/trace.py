"""Spans and counters of the port's own layers, kept in memory.

Off by default. Then `span` returns one shared no-op context (no clock
read, no span kept) and `count` returns after one test. `recording()`
turns both on for the length of a `with` block and yields the `Record`
they fill:

    with trace.recording() as rec:
        all2all_gpu(codes, pairs)
    rec.spans      # Span(name, start, end, parent, job, attrs), by start
    rec.counters   # {name: total}

Besides, an engine call (`job`) made while a torch.profiler records and
no `recording()` is on records into `profiled()`: the record of the
latest unbroken run of such calls, begun anew by the first profiled call
after an unprofiled one. So a profiled window of calls comes with its
spans (the benchmark's traced runs read them this way).

Times are `time.perf_counter()` seconds. A span's `parent` is the index
in `rec.spans` of the span open around it (None at the top), and `job` is
the id of the `job` span it runs under: each span named `job` opens a new
id, 0, 1, ... in the record. On a machine with CUDA, `recording()` also
takes an anchor: it synchronises the card, reads the clock (`rec.anchor`)
and launches a short spin kernel (`torch.cuda._sleep`), so that a
`torch.profiler` trace taken meanwhile can be put on this clock
(`write_chrome`).

The engine opens and closes its spans on the thread that called it; the
tracer is not meant to be shared by threads.
"""

import collections
import contextlib
import json
import time
from typing import NamedTuple, Optional

import torch

# The track the spans take in a Chrome trace.
TRACK = 'vclust host spans'
# Cycles of the anchor's spin kernel (a few microseconds).
ANCHOR_CYCLES = 1000


class Span(NamedTuple):
    name: str
    start: float
    end: float
    parent: Optional[int]
    job: Optional[int]
    attrs: dict


class Record:
    """What one `recording()` holds: closed spans, in the order they were
    opened, the counters, and the anchor's host instant (None without a
    card)."""

    def __init__(self):
        self.spans = []
        self.counters = collections.Counter()
        self.anchor = None
        self._open = []      # indices in `spans` of the spans open now
        self._jobs = 0

    def _begin(self, name, start, attrs) -> int:
        parent = self._open[-1] if self._open else None
        if name == 'job':
            job, self._jobs = self._jobs, self._jobs + 1
        else:
            job = self.spans[parent].job if parent is not None else None
        self.spans.append(Span(name, start, start, parent, job, attrs))
        return len(self.spans) - 1

    def _open_span(self, name, attrs) -> int:
        i = self._begin(name, time.perf_counter(), attrs)
        self._open.append(i)
        return i

    def _close_span(self, i):
        self._open.pop()
        self.spans[i] = self.spans[i]._replace(end=time.perf_counter())


_rec: Optional[Record] = None
_profiled: Optional[Record] = None
_last_profiled = False     # whether the latest job recorded into _profiled


class _Off:
    """The context `span` returns while the tracer is off."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Live:
    __slots__ = ('rec', 'name', 'attrs', 'i')

    def __init__(self, rec, name, attrs):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        self.i = self.rec._open_span(self.name, self.attrs)

    def __exit__(self, *exc):
        self.rec._close_span(self.i)
        return False


def span(name: str, **attrs):
    """A context that records a span `name` with `attrs` while the tracer
    is on."""
    if _rec is None:
        return _OFF
    return _Live(_rec, name, attrs)


@contextlib.contextmanager
def job(**attrs):
    """The span `job` of one engine call, with `attrs`. While no
    `recording()` is on and a torch.profiler records, the call records
    into `profiled()`."""
    global _rec, _profiled, _last_profiled
    implicit = _rec is None and (torch.autograd.profiler._is_profiler_enabled
                                 or torch.autograd._profiler_enabled())
    if implicit:
        if not _last_profiled:
            _profiled = Record()
        _rec = _profiled
    _last_profiled = implicit
    try:
        with span('job', **attrs):
            yield
    finally:
        if implicit:
            _rec = None


def profiled() -> Optional[Record]:
    """The record of the latest unbroken run of engine calls made under a
    torch.profiler with no `recording()` on; None before the first."""
    return _profiled


def add_span(name: str, start: float, end: float, **attrs):
    """Record a span from the caller's own `time.perf_counter()` reads,
    under the span open now (for code that reads the clock anyway)."""
    if _rec is not None:
        i = _rec._begin(name, start, attrs)
        _rec.spans[i] = _rec.spans[i]._replace(end=end)


def count(name: str, n: int = 1):
    """Add n to the counter `name` while the tracer is on."""
    if _rec is not None:
        _rec.counters[name] += n


def _anchor() -> Optional[float]:
    """On a machine with CUDA: the host instant of the anchor's spin
    kernel launch, on an idle card."""
    if not torch.cuda.is_available():
        return None
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(ANCHOR_CYCLES)
    return t


class recording:
    """Turn the tracer on for a `with` block; yields its `Record`. One at a
    time."""

    def __enter__(self) -> Record:
        global _rec
        if _rec is not None:
            raise RuntimeError('the tracer is already recording')
        rec = Record()
        rec.anchor = _anchor()
        _rec = rec
        return rec

    def __exit__(self, *exc):
        global _rec
        _rec = None
        return False


def write_chrome(rec: Record, path) -> dict:
    """Add the record's spans to the Chrome trace at `path` (as
    torch.profiler's `export_chrome_trace` writes it) as a track of their
    own, TRACK, and its counters to the trace's metadata (key `vclust`).
    With an anchor and its spin kernel in the trace, the spans are put on
    the timeline of the trace's kernels and host events; otherwise they
    keep the host clock, and the metadata says so. Returns the
    metadata."""
    with open(path) as fh:
        trace = json.load(fh)
    events = trace['traceEvents']
    spins = sorted((e for e in events if e.get('ph') == 'X'
                    and e.get('cat') == 'kernel'
                    and 'spin_kernel' in e.get('name', '')),
                   key=lambda e: e['ts'])
    meta = dict(counters=dict(rec.counters), spans=len(rec.spans))
    if rec.anchor is not None and spins:
        # The anchor's launch call where the trace holds the host's side
        # (its correlation id), else the kernel's start, which lags the
        # call by the launch's latency.
        spin = spins[0]
        corr = spin.get('args', {}).get('correlation')
        calls = [e for e in events if corr is not None
                 and e.get('cat') in ('cuda_runtime', 'cuda_driver')
                 and e.get('args', {}).get('correlation') == corr]
        at = calls[0]['ts'] if calls else spin['ts']
        off = at - rec.anchor * 1e6
        meta.update(clock='the trace\'s timeline, by the anchor kernel\'s '
                          + ('launch call' if calls else 'start'),
                    anchor_offset_us=off,
                    anchor_kernel_after_us=spin['ts'] - at)
    else:
        off = 0.0
        meta.update(clock='host time.perf_counter(), not aligned with the '
                          "profiler's events")
    pids = [e['pid'] for e in events if isinstance(e.get('pid'), int)]
    pid = max(pids, default=0) + 1
    events.append(dict(name='process_name', ph='M', pid=pid, tid=0,
                       args=dict(name=TRACK)))
    for s in rec.spans:
        events.append(dict(
            name=s.name, ph='X', cat='vclust', pid=pid, tid=0,
            ts=s.start * 1e6 + off, dur=(s.end - s.start) * 1e6,
            args=dict(s.attrs, job=s.job, parent=s.parent)))
    trace['vclust'] = meta
    with open(path, 'w') as fh:
        json.dump(trace, fh)
    return meta
