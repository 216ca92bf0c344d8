#!/usr/bin/env python3
"""The dispatch size B of the port's v3 align pipe (vclust_tpu_torch/ops/
align_gpu.py) on a card: what a dispatch holds, and what B buys.

On chip_smoke.py's two align_v3 corpora (the 48 genomes and the 128
contigs, made in the run):
  memory  one dispatch at bucket 65,536 (K = 8 queries a row) at B = 1, 2,
          4, 8 and 16 rows, aggregates alone and with records: the peak
          device bytes above those allocated before it
          (torch.cuda.max_memory_allocated), their slope per query, and the
          bytes a query position that slope implies once the four bands'
          counts are taken off (K3 and K5 read the windows from the wide
          rows in place; the measured counterpart of `_BYTES_PER_POS`);
  sweep   `_all2all_single(..., pipe='v3')` over each corpus with the live-bytes budget
          `_LIVE_BYTES` at 0.5, 1, 2, 4 and 8 GiB, the budgets interleaved
          in every repetition: B at each bucket, K2 launches, warm pairs/s
          (best of --reps), and the peak device memory of a run with
          records.
Needs one CUDA card:

    python3 tools/v3_dispatch_probe.py [--reps N]

Prints one JSON line a measurement, then the card's name and power limit
(nvidia-smi).
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

BUDGETS_GIB = (0.5, 1, 2, 4, 8)
ROWS = (1, 2, 4, 8, 16)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def buckets_of(ag, codes, pairs) -> dict:
    lens = [len(c) for c in codes]
    members = {}
    for i, j in pairs.tolist():
        kb = max(ag._pad_bucket(lens[i]), ag._pad_bucket(lens[j]))
        members.setdefault(kb, set()).update((i, j))
    return members


def dispatch_memory(torch, dev, ag, idx, codes, kb=65536, K=8, seed=0):
    """Peak bytes of one dispatch of B rows at bucket kb, per B."""
    b = idx.bucket[(kb, 'v3')]
    g3 = ag._v3_geom(kb, kb)
    p = ag.AlignParams()
    rng = np.random.default_rng(seed)
    long_ = [g for g in b['rows'] if ag._pad_bucket(len(codes[g])) == kb]
    res = {}
    for with_alns in (False, True):
        peaks = []
        for B in ROWS:
            refs = [long_[w % len(long_)] for w in range(B)]
            r_rows = torch.tensor([b['rows'][g] for g in refs],
                                  dtype=torch.int32, device=dev)
            rlens = torch.tensor([len(codes[g]) for g in refs],
                                 dtype=torch.int32, device=dev)
            q_rows = torch.from_numpy(rng.integers(
                0, len(b['rows']), (B, K)).astype(np.int32)).to(dev)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = ag._row_core_v3(b, r_rows, rlens, q_rows, ag.V3_TBAND,
                                  ag.V3_SMIN, Lq=kb, Lr=kb, K=K, mqd=p.mqd,
                                  mrd=p.mrd, reg=p.reg, with_alns=with_alns)
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() - base)
            del out
        slope = (peaks[-1] - peaks[0]) / ((ROWS[-1] - ROWS[0]) * K)
        bands = 4 * (kb // ag.FINE) * g3['BAND']
        res['records' if with_alns else 'aggregates'] = dict(
            peak_bytes_by_rows=dict(zip(ROWS, peaks)),
            bytes_per_query=slope, band_bytes_per_query=bands,
            bytes_per_position=(slope - bands) / kb)
    emit(dict(measure='memory', bucket=kb, K=K,
              model_bytes_per_position=[ag._BYTES_PER_POS,
                                        ag._BYTES_PER_POS_RECORDS], **res))


def sweep(torch, dev, ag, corpora, reps: int):
    """Warm pairs/s of each corpus at each live-bytes budget."""
    saved = ag._LIVE_BYTES
    walls = {(name, g): [] for name in corpora for g in BUDGETS_GIB}
    launches = {}
    try:
        for _ in range(reps):
            for gib in BUDGETS_GIB:
                ag._LIVE_BYTES = int(gib * 2 ** 30)
                for name, (codes, pairs, idx) in corpora.items():
                    ag.stage1_pack.launches = 0
                    t0 = time.perf_counter()
                    ag._all2all_single(codes, pairs, index=idx, pipe='v3')
                    walls[(name, gib)].append(time.perf_counter() - t0)
                    launches[(name, gib)] = ag.stage1_pack.launches
        for gib in BUDGETS_GIB:
            ag._LIVE_BYTES = int(gib * 2 ** 30)
            for name, (codes, pairs, idx) in corpora.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ag._all2all_single(codes, pairs, index=idx,
                                   keep_alignments=True, pipe='v3')
                torch.cuda.synchronize()
                ws = walls[(name, gib)]
                emit(dict(
                    measure='sweep', corpus=name, live_gib=gib,
                    rows_by_bucket={kb: ag._dispatch_rows(kb, 8, dev, False)
                                    for kb in sorted(buckets_of(
                                        ag, codes, pairs))},
                    k2_launches=launches[(name, gib)], walls_s=ws,
                    pairs_per_s=len(pairs) / min(ws),
                    peak_gib_with_records=torch.cuda.max_memory_allocated()
                    / 2 ** 30))
    finally:
        ag._LIVE_BYTES = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit('CUDA is not available: the probe needs a GPU')
    import chip_smoke as cs
    from vclust_tpu_torch.ops import align_gpu as ag
    from vclust_tpu_torch.ops import cuda
    dev = torch.device('cuda')
    emit(dict(build_s=cuda.build()))
    corpora = {}
    for name, corpus in (('genomes48', cs.mutant_corpus()),
                         ('contigs128', cs.contig_corpus())):
        codes, pairs = cs.align_inputs(corpus)
        idx = ag.GenomeIndex(codes, device=dev)
        ag._all2all_single(codes, pairs, index=idx, pipe='v3')   # warm-up
        corpora[name] = (codes, pairs, idx)
    dispatch_memory(torch, dev, ag, corpora['genomes48'][2],
                    corpora['genomes48'][0])
    sweep(torch, dev, ag, corpora, args.reps)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == '__main__':
    main()
