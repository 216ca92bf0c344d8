#!/usr/bin/env python3
"""Witnesses for a mismatch the check found: one run's jobs, replayed.

    python3 benchmark/witness.py --workload <config>.<traffic> --seed <n> \
        --job <k> --pair <i>,<j> [--pair ...] [--cycles 2] [--swap k7,k6]

Makes the run's jobs from its seed, as the run does, then on the card:
the run's warm-up job and `cycles` turns of the window's order of jobs,
keeping the given pairs' aggregates from each execution of job k; the
pairs alone
(a job of their own genomes); and, with --swap, the window again with each
named kernel replaced by its plain version (k7: `propagate_v2_plain`, k6:
`votes_elect_v2_plain`). Off the card: the port's plain path on the CPU
and the reference, on the pairs alone. Prints one JSON line.
"""

import argparse
import json
import sys

import numpy as np

import run
from reference import engine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--job', type=int, required=True)
    ap.add_argument('--pair', action='append', required=True)
    ap.add_argument('--cycles', type=int, default=2)
    ap.add_argument('--swap', default='')
    args = ap.parse_args(argv)
    import torch
    from vclust_tpu_torch.ops import align_gpu as ag
    cfg, mix = args.workload.split('.', 1)   # a cell kept out, too
    cell = run.cell_from_files(dict(name=args.workload, config=cfg,
                                    traffic=mix, chips=1), [], [])
    jobs = run.jobgen.make_jobs(cell['config'], cell['traffic'], args.seed)
    job = jobs[args.job]
    want = [tuple(int(x) for x in p.split(',')) for p in args.pair]
    rows = [int(np.flatnonzero((job.pairs[:, 0] == i)
                               & (job.pairs[:, 1] == j))[0]) for i, j in want]
    sel = job.pairs[rows]

    warm = run.jobgen.make_warmup(cell['config'], cell['traffic'], args.seed)

    def window(tag):
        got = []
        ag.all2all_gpu(warm.codes_list, warm.pairs)
        for _ in range(args.cycles):
            for k, jb in enumerate(jobs):
                out = ag.all2all_gpu(jb.codes_list, jb.pairs)
                if k == args.job:
                    got.append(out[rows].tolist())
        return {tag: got}

    res = dict(workload=args.workload, seed=args.seed, job=args.job,
               pairs=[list(p) for p in want],
               lengths=[[int(job.lens[i]), int(job.lens[j])] for i, j in want])
    res.update(window('card_window'))
    alone = ag.all2all_gpu(job.codes_list, sel)
    res['card_alone'] = alone.tolist()
    for name in filter(None, args.swap.split(',')):
        real = {'k7': ('_propagate_v2', ag.propagate_v2_plain),
                'k6': ('_votes_elect_v2', ag.votes_elect_v2_plain)}[name]
        keep = getattr(ag, real[0])
        setattr(ag, real[0], real[1])
        try:
            res.update(window(f'card_window_{name}_plain'))
        finally:
            setattr(ag, real[0], keep)
    res['cpu_port_alone'] = ag.all2all_gpu(job.codes_list, sel,
                                           device='cpu').tolist()
    ref, hard = engine.align_pairs(job.codes_list, sel, 'cuda')
    res['reference_card'] = ref.tolist()
    res['reference_cpu'] = engine.align_pairs(job.codes_list, sel,
                                              'cpu')[0].tolist()
    res['hybrid_v2'] = hard.tolist()
    torch.cuda.synchronize()
    print(json.dumps(res))
    return 0


if __name__ == '__main__':
    sys.exit(main())
