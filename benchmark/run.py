#!/usr/bin/env python3
"""The port's align benchmark: one cell of BENCHMARK.json on one H100.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration (configs/<config>.json: how the genomes of
a family descend from its base) and a traffic mix (traffic/<traffic>.json:
the plan of a job), and the per-layer metrics list their readers
(metrics/<name>.py); all are found by name, so a cell, a mix or a metric
is added as files and entries.

Set-up builds the port's kernels (cached in its checkout), makes the
cell's few distinct jobs from the seed (jobs.py) and runs a small warm-up
job with pairs at each bucket the cell's pairs reach, on both pipes
(jobs.make_warmup). The window is a closed loop with one client:
`all2all_gpu(codes_list, pairs)` a job, as
`align --engine gpu` calls it (a fresh index each call, the program's
defaults), jobs back to back in turn until --seconds have passed; the job
running then is finished. `align_pairs_per_s` is the window's pairs over
the wall time from the first job's start to the last one's end. With
--trace 1 the same window runs under the harness's spans and torch.profiler
(tracing.py), and the line carries the per-layer metrics and the
breakdown in place of the end-to-end metrics.

After the window, a sample of each job's pairs is drawn from the seed
(check.py) and, with the program's state freed, the reference
(reference/engine.py) aligns the sampled pairs: every execution's
aggregates of them must equal its own. The last lines on stderr, and the
last key of the result line, give each number compared beside its limit.
The result is the last line of stdout, one JSON object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))
# Kernel caches of the libraries under the program, at fixed paths inside
# the checkout (the port's own kernels build into vclust_tpu_torch/_build).
for _var, _sub in (('TRITON_CACHE_DIR', 'triton'),
                   ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
    os.environ[_var] = str(HERE / '_cache' / _sub)

import numpy as np  # noqa: E402

import check  # noqa: E402
import jobs as jobgen  # noqa: E402

# Modules that may not be loaded in the process that prints the result
# (top-level names, compared whole).
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'vclust_tpu')
# The sample the check compares: pairs a distinct job, the least a
# stratum of it, and the least a stratum of flagged pairs of equal lengths
# (check.py).
SAMPLE_PAIRS = 300
SAMPLE_FLOOR = 12
SAMPLE_FLAGGED_FLOOR = 200
KERNEL_LIBRARIES = ('index', 'align_v3', 'back_half', 'align_v2')


def load_cell(workload: str) -> dict:
    """The cell's entry, configuration, traffic and metrics from
    BENCHMARK.json and the files they name."""
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    wl = {w['name']: w for w in bench['workloads']}.get(workload)
    if wl is None:
        raise SystemExit(f'no workload {workload!r} in BENCHMARK.json')

    def here(m):
        return 'workloads' not in m or workload in m['workloads']
    return cell_from_files(wl, [m for m in bench['end_to_end'] if here(m)],
                           [m for m in bench['per_layer'] if here(m)])


def cell_from_files(wl: dict, end_to_end: list, per_layer: list) -> dict:
    """A cell from its entry (name, config, traffic, chips) and the files
    configs/<config>.json and traffic/<traffic>.json."""
    config = json.loads((HERE / 'configs' / f"{wl['config']}.json")
                        .read_text())
    traffic = json.loads((HERE / 'traffic' / f"{wl['traffic']}.json")
                         .read_text())
    return dict(workload=wl, config=config, traffic=traffic,
                end_to_end=end_to_end, per_layer=per_layer)


class RerunPairs:
    """Within its `with`, records the pairs the program aligns again on v2
    (the pairs its `_all2all_single` takes with pipe 'v2') while `on`."""

    def __init__(self, ag):
        self.ag, self.on, self.pairs = ag, False, []

    def __enter__(self):
        real = self.real = self.ag._all2all_single

        def single(codes, pairs, *args, **kw):
            pipe = args[4] if len(args) > 4 else kw.get('pipe', 'v2')
            if self.on and pipe == 'v2':
                self.pairs.append(np.array(pairs, dtype=np.int64))
            return real(codes, pairs, *args, **kw)
        self.ag._all2all_single = single
        return self

    def __exit__(self, *exc):
        self.ag._all2all_single = self.real

    def take(self) -> np.ndarray:
        got = (np.concatenate(self.pairs) if self.pairs
               else np.zeros((0, 2), np.int64))
        self.pairs = []
        return got


def forbidden_modules() -> list:
    return sorted({n.split('.')[0] for n in sys.modules}
                  & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = 'cuda', log=sys.stderr) -> dict:
    """Set-up, the window and the check of one run (see the module
    docstring). Returns the result line's object."""
    import torch
    from vclust_tpu_torch.ops import align_gpu as ag

    parts = {'imports_s': time.perf_counter() - T_START}
    t = time.perf_counter()
    on_card = device == 'cuda'
    if on_card:
        from vclust_tpu_torch.ops import cuda as kcuda
        torch.cuda.init()
        torch.zeros(1, device='cuda')
        parts['cuda_context_s'] = time.perf_counter() - t
        t = time.perf_counter()
        kcuda.build(KERNEL_LIBRARIES)
        for name in KERNEL_LIBRARIES:
            kcuda.library(name, getattr(kcuda, f'{name.upper()}_SIGNATURES'))
        parts['kernels_s'] = time.perf_counter() - t
        t = time.perf_counter()
    pool = jobgen.load_pool()
    jobs = jobgen.make_jobs(cell['config'], cell['traffic'], seed, pool)
    warm = jobgen.make_warmup(cell['config'], cell['traffic'], seed, pool)
    parts['jobs_s'] = time.perf_counter() - t
    t = time.perf_counter()
    ag.all2all_gpu(warm.codes_list, warm.pairs)
    if on_card:
        torch.cuda.synchronize()
    parts['warmup_s'] = time.perf_counter() - t
    setup_s = time.perf_counter() - T_START

    rec = prof = t_mark = None
    kept = [[] for _ in jobs]
    rerun = [None] * len(jobs)
    job_s = []
    n_pairs = k = 0
    with contextlib.ExitStack() as stack:
        rec_v2 = stack.enter_context(RerunPairs(ag))
        if trace:
            import tracing
            rec = tracing.Recorder(ag)
            prof = stack.enter_context(tracing.profile(torch))
            t_mark = tracing.marker(torch)
            stack.enter_context(rec)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        while k == 0 or time.perf_counter() - t0 < seconds:
            w = k % len(jobs)
            job = jobs[w]
            rec_v2.on = k < len(jobs)
            tj = time.perf_counter()
            out = ag.all2all_gpu(job.codes_list, job.pairs)
            job_s.append(time.perf_counter() - tj)
            if rec_v2.on:
                rerun[w] = rec_v2.take()
            if rec is not None:
                rec.job(tj, tj + job_s[-1], len(job.pairs))
            kept[w].append(out)
            n_pairs += len(job.pairs)
            k += 1
        t1 = time.perf_counter()
        window_s = t1 - t0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        del out

    result = dict(correct=None, attempted=n_pairs, failed=None)
    if trace:
        counters = rec.counters()
        dev = tracing.read_device_trace(prof, t_mark, t0, t1, rec.spans)
        del prof
        data = dict(window_s=window_s, busy_s=dev['busy_s'],
                    counters=counters, device_ops=dev['device_ops'],
                    peak_bytes=peak)
        metrics = {}
        for m in cell['per_layer']:
            v = importlib.import_module(f"metrics.{m['name']}").read(data)
            if v is not None:
                metrics[m['name']] = dict(value=float(v), unit=m['unit'])
        result['metrics'] = metrics
        result['breakdown'] = dict(
            device_ops=[[n, s] for n, s in dev['device_ops'].most_common(10)],
            idle_gaps=[[n, s] for n, s in dev['idle_gaps'].most_common(10)])
        print(json.dumps(dict(counters=counters, device_events=dev['events'],
                              idle_gaps=dev['idle_gaps'])), file=log)
    else:
        values = dict(align_pairs_per_s=n_pairs / window_s, setup_s=setup_s)
        result['metrics'] = {m['name']: dict(value=values[m['name']],
                                             unit=m['unit'])
                             for m in cell['end_to_end']}
    result['device'] = dict(
        platform='gpu' if on_card else 'cpu',
        kind=torch.cuda.get_device_name(0) if on_card else 'cpu',
        count=cell['workload']['chips'], memory_peak_bytes=int(peak))
    if trace:
        result['device'].update(busy_s=data['busy_s'], window_s=window_s)
    print(json.dumps(dict(setup_parts=parts, setup_s=setup_s,
                          window_s=window_s, jobs=k, pairs=n_pairs,
                          job_s=job_s)),
          file=log)

    # The check, with the program's state freed.
    rng = np.random.default_rng([int(seed), 1])
    flags = [dict(first=kept[k][0], rerun=check.pair_index(j, rerun[k]))
             if kept[k] else {} for k, j in enumerate(jobs)]
    samples = [check.draw_sample(j, rng, SAMPLE_PAIRS, SAMPLE_FLOOR,
                                 flagged_floor=SAMPLE_FLAGGED_FLOOR, **f)
               for j, f in zip(jobs, flags)]
    print(json.dumps(dict(
        sampled=[len(s) for s in samples],
        rerun=[len(f.get('rerun', ())) for f in flags],
        flagged=[int((check.strata(j, **f) % 4 >= 2).sum())
                 for j, f in zip(jobs, flags)])), file=log)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    from reference import engine
    t = time.perf_counter()
    res = check.compare(jobs, samples, kept, device, engine.align_pairs)
    res['reference_s'] = time.perf_counter() - t
    print(json.dumps(res), file=log)
    result['correct'] = res['mismatched_pairs'] == 0
    result['failed'] = res['mismatched_pairs']
    result['compared_pairs'] = res['compared_pairs']
    result['checks'] = dict(mismatched_pairs=dict(
        value=res['mismatched_pairs'], limit=0))
    print(f"check mismatched_pairs {res['mismatched_pairs']} limit 0 "
          f"(compared {res['compared_pairs']})", file=log)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    chips = cell['workload']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'needs {chips} CUDA device(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f'modules loaded in the run: {found}', file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
