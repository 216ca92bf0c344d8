"""The program's own spans and counters of a traced run's window
(vclust_tpu_torch/utils/trace.py): the engine keeps a record of the calls
it makes while a torch.profiler records, as the traced window's are.
Readers of per-layer metrics take it from here; None where the program
has no tracer (an older commit) or the record is not the window's."""


def record(t: dict):
    """The program's record of the window whose traced data is `t`: its
    calls must be the window's jobs (`t['counters']['jobs']`)."""
    try:
        from vclust_tpu_torch.utils import trace
    except ImportError:
        return None
    rec = trace.profiled()
    if rec is None:
        return None
    jobs = sum(s.name == 'job' for s in rec.spans)
    if jobs != t.get('counters', {}).get('jobs'):
        return None
    return rec


def seconds(t: dict, *names):
    """The summed seconds of the program's spans `names` in the window;
    None without a record or such a span."""
    rec = record(t)
    if rec is None:
        return None
    got = [s.end - s.start for s in rec.spans if s.name in names]
    return sum(got) if got else None


def share(t: dict, *names):
    """`seconds` of `names` over the window, in %."""
    s = seconds(t, *names)
    if s is None or t['window_s'] <= 0:
        return None
    return 100.0 * s / t['window_s']
