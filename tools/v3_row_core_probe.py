#!/usr/bin/env python3
"""One v3 dispatch at bucket 65,536 on a card, as the checkout at --root
(default: this one) computes it: stage 1 (`_stage1_v3`), stages 2-4
(`_bands_v3`) and the whole row core (`_row_core_v3`, with and without
records), each timed by CUDA events (`ms`, chip_smoke.py:time_ms) and on
the device (`device_ms`, chip_smoke.py:device_ms), and the row core's peak
device bytes above those allocated before it, at B = 26 rows and at the
checkout's own B (`_dispatch_rows`), K = 8 queries a row. The inputs are
chip_smoke.py's: its 48 genomes, the references cycled over the rows, the
queries drawn from --seed. Both --root checkouts must have these
functions; each builds its own kernels.

To compare two commits on one card, run it on each in turns, in one call:

    python3 tools/v3_row_core_probe.py --root PARENT_CHECKOUT
    python3 tools/v3_row_core_probe.py
    python3 tools/v3_row_core_probe.py
    python3 tools/v3_row_core_probe.py --root PARENT_CHECKOUT

Prints one JSON line a dispatch size, then the card's name and power
limit (nvidia-smi).
"""

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=str(REPO),
                    help='the checkout whose port is measured')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit('v3_row_core_probe.py needs a CUDA card')
    import chip_smoke as cs
    from vclust_tpu_torch.ops import align_gpu as ag
    dev = torch.device('cuda')
    kb, K, reps = 65536, ag.K_QUERIES, args.reps
    codes, pairs = cs.align_inputs(cs.mutant_corpus())
    lens = [len(c) for c in codes]
    gids = sorted({g for i, j in pairs.tolist() for g in (i, j)
                   if max(ag._pad_bucket(lens[i]),
                          ag._pad_bucket(lens[j])) == kb})
    b = ag.GenomeIndex(codes, device=dev).ensure_v3(kb, gids)
    g3 = ag._v3_geom(kb, kb)
    own = ag._dispatch_rows(kb, K, dev, False)
    rng = np.random.default_rng(args.seed)
    long_ = [g for g in b['rows'] if ag._pad_bucket(len(codes[g])) == kb]
    p = ag.AlignParams()
    kw = dict(Lq=kb, Lr=kb, K=K, mqd=p.mqd, mrd=p.mrd, reg=p.reg)
    tb, sm = ag.V3_TBAND, ag.V3_SMIN
    for B in sorted({26, own}):
        refs = [long_[w % len(long_)] for w in range(B)]
        r_rows = torch.tensor([b['rows'][g] for g in refs],
                              dtype=torch.int32, device=dev)
        rlens = torch.tensor([len(codes[g]) for g in refs],
                             dtype=torch.int32, device=dev)
        q_rows = torch.from_numpy(rng.integers(
            0, len(b['rows']), (B, K)).astype(np.int32)).to(dev)
        s1 = ag._stage1_v3(b['qocc'], b['rocc'], r_rows, q_rows)
        fns = dict(
            stage1=lambda: ag._stage1_v3(b['qocc'], b['rocc'], r_rows,
                                         q_rows),
            bands=lambda: ag._bands_v3(b, r_rows, rlens, q_rows, *s1, tb, sm,
                                       g3),
            row_core=lambda: ag._row_core_v3(b, r_rows, rlens, q_rows, tb,
                                             sm, **kw),
            row_core_records=lambda: ag._row_core_v3(
                b, r_rows, rlens, q_rows, tb, sm, with_alns=True, **kw))
        out = dict(root=str(root), bucket=kb, B=B, K=K, own_B=own)
        for name, fn in fns.items():
            out[f'{name}_ms'] = cs.time_ms(fn, reps)
            out[f'{name}_device_ms'] = cs.device_ms(fn, reps)[0]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fns['row_core']()
        torch.cuda.synchronize()
        out['row_core_peak_bytes'] = torch.cuda.max_memory_allocated() - base
        out['card'] = torch.cuda.get_device_name(0)
        print(json.dumps(out), flush=True)
        del s1, fns
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == '__main__':
    main()
