#!/usr/bin/env python3
"""Where the v3 align pipe's tANI error against the exact engine comes
from, on a subset of bench.py's 48-genome align corpus, on the CPU.

The subset is every genome of the families (an example genome and its
three 5% mutants) of the given ids-order genomes (default: 1 and 27, the
pair chip_smoke.py's align_v3 phase finds farthest from the native
engine), and all pairs among them. Over those pairs it runs:
  native  the JAX package's C++ engine (ops/lz_native.py), the reference;
  jax_v3  the JAX package's `_all2all_single(..., pipe='v3')` (v3 alone);
  hybrid  the JAX package's `all2all_tpu` (v3, then its v2 re-run of hard
          pairs);
  port    the port's `_all2all_single(..., pipe='v3')` (plain K2 and K3 on
          the CPU);
  port_hybrid  the port's `all2all_gpu` (its v3, then its v2 re-run);
and prints, for each of the last four, the max |tANI - tANI(native)|,
the pairs above 0.01 and the tANI of the named pair, and whether the port
equals jax_v3 and port_hybrid equals hybrid, bit for bit.

    JAX_PLATFORMS=cpu python3 tools/v3_dtani_check.py [--genomes 1 27]

Takes a few minutes (XLA compiles the v3 and v2 programs at buckets
49,152 and 65,536).
"""

import argparse
import json
import os
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--genomes', type=int, nargs='+', default=[1, 27])
    args = ap.parse_args()
    import torch
    import bench
    from vclust_tpu.models.align import _genome_codes, order_objects
    from vclust_tpu.models.input import load_genomes
    from vclust_tpu.ops import align_tpu as ja
    from vclust_tpu.ops import lz_native
    from vclust_tpu.ops.lz_parse_py import AlignParams
    from vclust_tpu.utils.data import example_path
    from vclust_tpu_torch.ops import align_gpu as ag

    genomes, _ = load_genomes(example_path('multifasta.fna'))
    corpus = bench.make_align_corpus(genomes, reps=3)
    order = order_objects(corpus)

    def family(i):
        return corpus[order[i]].name.split('.r')[0]

    fams = {family(i) for i in args.genomes}
    keep = [i for i in range(len(order)) if family(i) in fams]
    codes = [_genome_codes(corpus[order[i]]) for i in keep]
    n = len(codes)
    pairs = np.array([(a, b) for a in range(n) for b in range(a + 1, n)],
                     dtype=np.int32)
    named = tuple(keep.index(i) for i in args.genomes[:2])

    nat, _ = lz_native.all2all_native(codes, pairs, AlignParams(),
                                      n_threads=os.cpu_count() or 1)
    runs = {
        'jax_v3': ja._all2all_single(codes, pairs, None,
                                     ja.GenomeIndexTPU(codes), None, False,
                                     ja.SEEDS_PER_BLOCK, pipe='v3'),
        'hybrid': ja.all2all_tpu(codes, pairs),
        'port': ag._all2all_single(codes, pairs, pipe='v3',
                                   device=torch.device('cpu')),
        'port_hybrid': ag.all2all_gpu(codes, pairs,
                                      device=torch.device('cpu')),
    }
    lens = np.array([len(c) for c in codes], np.float64)
    den = lens[pairs[:, 0]] + lens[pairs[:, 1]]

    def tani(out):
        return (out[:, 1] + out[:, 4]) / den

    row = int(np.flatnonzero((pairs[:, 0] == min(named))
                             & (pairs[:, 1] == max(named)))[0])
    res = dict(genomes_ids_order=keep, families=sorted(fams),
               pairs=len(pairs), named_pair=list(args.genomes[:2]),
               tani_native_named=float(tani(nat)[row]),
               port_eq_jax_v3=bool(np.array_equal(runs['port'],
                                                  runs['jax_v3'])),
               port_hybrid_eq_hybrid=bool(np.array_equal(
                   runs['port_hybrid'], runs['hybrid'])))
    for name, out in runs.items():
        d = np.abs(tani(out) - tani(nat))
        res[name] = dict(max_abs_dtani=float(d.max()),
                         pairs_over_0_01=int((d > 0.01).sum()),
                         tani_named=float(tani(out)[row]))
    print(json.dumps(res), flush=True)


if __name__ == '__main__':
    main()
