"""One process of a multi-process run of the port: the real sharded paths
over a global mesh, held bit for bit against this process's own unsharded
results (the port of the JAX package's tools/multihost_worker.py).

Start one per process, each with the environment contract of
parallel/distributed.py:

    VCLUST_DIST_COORD=127.0.0.1:<port> VCLUST_DIST_NPROCS=2 \\
    VCLUST_DIST_PROCID=<0|1> python -m vclust_tpu_torch.parallel.worker \\
        [--device cpu|cuda:0] [--shards 2] [--timeout 60]

Each process holds --shards shards on --device (default: one a visible
card). It runs the example corpus's prefilter counts (K1's work lists cut
among every process's shards, == the host counts), the dense sharded
products (== one int product), and the device align engine on 6 mutants
with records (== the unsharded run), then prints
`MULTIHOST_OK pid=<rank>/<processes> shards=<mesh shards>`.
"""

import argparse
import sys

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default=None)
    ap.add_argument('--shards', type=int, default=None)
    ap.add_argument('--timeout', type=float, default=300.0,
                    help='seconds a collective may wait before it fails')
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from .distributed import (global_mesh, maybe_initialize, process_info,
                              reduce_sum)
    from .mesh import int_products, local_shards, sharded_pair_counts

    if not maybe_initialize(args.timeout):
        sys.exit('VCLUST_DIST_COORD, VCLUST_DIST_NPROCS and '
                 'VCLUST_DIST_PROCID must all be set')
    info = process_info()
    if info is None:
        sys.exit('expected a run of more than one process')
    pid, nprocs = info
    devices = (None if args.device is None and args.shards is None else
               [args.device or 'cuda'] * (args.shards or 1))
    mesh = global_mesh(devices=devices)
    _, n_shards = local_shards(mesh)
    assert n_shards == nprocs * len(mesh.devices)

    # The prefilter counts: every process's shards add their parts.
    from ..models.input import load_genomes
    from ..models.prefilter import genome_kmer_set
    from ..ops.prefilter import (PrefilterIndex, shared_kmer_counts_host,
                                 shared_kmer_counts_indexed)
    from ..utils.data import example_path
    genomes, _ = load_genomes(example_path('multifasta.fna'))
    sets = [genome_kmer_set(g, 25, 1.0) for g in genomes]
    counts = shared_kmer_counts_indexed(PrefilterIndex(sets), mesh=mesh,
                                        engine='device')
    np.testing.assert_array_equal(counts, shared_kmer_counts_host(sets))
    assert int(reduce_sum(mesh, np.ones(1, np.int64))[0]) == nprocs

    # The dense products, row blocks on every process's shards.
    rng = np.random.default_rng(0)
    occ = (rng.random((8 * n_shards, 256)) < 0.2).astype(np.int8)
    want = int_products(torch.from_numpy(occ), torch.from_numpy(occ))
    np.testing.assert_array_equal(sharded_pair_counts(mesh, occ),
                                  want.numpy())

    # The device align engine: its dispatches dealt to every shard.
    from ..entry import _assert_same, _mutants
    from ..ops import align_gpu
    codes = _mutants(np.random.default_rng(0), 6)
    pairs = np.array([(i, j) for i in range(6) for j in range(i + 1, 6)],
                     dtype=np.int32)
    sharded = align_gpu.all2all_gpu(codes, pairs, keep_alignments=True,
                                    mesh=mesh)
    single = align_gpu.all2all_gpu(codes, pairs, keep_alignments=True,
                                   device=mesh.devices[0])
    _assert_same(single, sharded)

    print(f'MULTIHOST_OK pid={pid}/{nprocs} shards={n_shards}', flush=True)
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
