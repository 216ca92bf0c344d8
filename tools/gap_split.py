"""A traced run of a benchmark cell whose idle gaps are named, below the
harness's own spans, by the align engine's leaf spans
(vclust_tpu_torch/utils/trace.py): which host work the card waits for.

    python3 tools/gap_split.py --workload imgvr_votu.whole_131k \\
        --seed 2147485001 --seconds 30

Runs `benchmark/run.py --trace 1` in this process with the gaps' names
extended: its result line is the traced run's, and its log (stderr) line
of idle gaps holds every name. Then prints to stderr the engine's span
seconds and counters over the window. Needs a card, as the traced run
does.
"""

import collections
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / 'benchmark')):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402
import tracing  # noqa: E402
from vclust_tpu_torch.utils import trace  # noqa: E402

# The engine's leaf spans, innermost first; they do not overlap one another.
LEAVES = (
    ('index.fill', 'index.fill (host padding and reverse complements)'),
    ('index.upload', 'index.upload (the arena codes to the card, waits '
                     'included)'),
    ('index.kernels', 'index.kernels (arena allocation, K9 and K10 '
                      'wrappers)'),
    ('pipe.group', 'pipe.group (pairs to bucket groups, the work list)'),
    ('pipe.rows', 'pipe.rows (rows and placement arrays of a group)'),
    ('dispatch.upload', "dispatch.upload (a dispatch's four row arrays to "
                        'the card, waits included)'),
    ('dispatch.launch', "dispatch.launch (the row core's host time: "
                        'wrappers, launches)'),
    ('pipe.to_host', 'pipe.to_host (the copies back, waits included)'),
    ('pipe.scatter', 'pipe.scatter (gather and the scatter-back)'),
)


def leaves(rec) -> list:
    """The record's leaf spans as the harness's (name, start, end)."""
    if rec is None:
        return []
    names = dict(LEAVES)
    return [(s.name, s.start, s.end) for s in rec.spans if s.name in names]


def install():
    """Put the engine's leaf spans below the harness's in the gaps'
    names: the harness names each piece of a gap by the deepest span open
    over it, so the gaps' total stays."""
    tracing.GAP_NAMES = LEAVES + tuple(
        g for g in tracing.GAP_NAMES if g not in LEAVES)
    real = tracing.read_device_trace

    def read(prof, t_marker, t0, t1, spans):
        return real(prof, t_marker, t0, t1,
                    list(spans) + leaves(trace.profiled()))
    tracing.read_device_trace = read


def main(argv=None) -> int:
    install()
    rc = run.main(list(sys.argv[1:] if argv is None else argv)
                  + ['--trace', '1'])
    rec = trace.profiled()
    if rec is not None:
        span_s = collections.Counter()
        for s in rec.spans:
            span_s[s.name] += s.end - s.start
        print(json.dumps(dict(program_counters=rec.counters,
                              program_span_s=span_s)), file=sys.stderr)
    return rc


if __name__ == '__main__':
    sys.exit(main())
