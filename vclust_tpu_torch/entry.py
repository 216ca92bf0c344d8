"""Entry points for a quick check of the port on its devices: the dense
prefilter step on one device, and a dry run of the real pipeline over a
mesh (the counterparts of the JAX package's `entry` and
`dryrun_multichip`).

    python -m vclust_tpu_torch.entry            # every visible card
    python -m vclust_tpu_torch.entry --shards 2 --device cuda:0

Both run on `cuda` unless the caller asks for the CPU (device='cpu'), and
raise without CUDA otherwise.
"""

import argparse
import tempfile

import numpy as np
import torch

from .parallel.mesh import ani_shorter_f32, int_products, make_mesh
from .utils.device import resolve_device


def entry(device=None):
    """The flagship compute step at the example's shape, on `device`
    (default cuda): the exact int product of a (128, 8192) {0,1} occupancy
    with itself, ani-shorter in float32 and the keep mask (counts >= 20,
    sim >= 0.7). Returns (fn, example_args); the inputs are the JAX
    package's entry's (numpy's generator at seed 0)."""
    dev = resolve_device(device)
    G, M = 128, 8192
    k = 25
    rng = np.random.default_rng(0)
    occ = torch.from_numpy((rng.random((G, M)) < 0.05).astype(np.int8))
    sizes = torch.from_numpy(rng.integers(1000, 50_000, G).astype(
        np.float32))

    def forward(occ, sizes):
        counts = int_products(occ, occ)
        sim = ani_shorter_f32(counts, sizes, sizes, k)
        keep = (counts >= 20) & (sim >= 0.7)
        return counts, sim, keep

    return forward, (occ.to(dev), sizes.to(dev))


def _mutants(rng, n: int, length: int = 3500, rate: float = 0.03):
    base = rng.integers(0, 4, length).astype(np.int8)
    codes = []
    for _ in range(n):
        mut = base.copy()
        mask = rng.random(len(mut)) < rate
        mut[mask] = rng.integers(0, 4, mask.sum())
        codes.append(mut)
    return codes


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the real pipeline over an n-shard mesh (`make_mesh(n_devices,
    device)`: the first n cards, or n shards of `device`) and hold it to
    the unsharded paths: the example corpus's sharded prefilter counts ==
    the host counts; the batch store (--batch-size) with each block over
    the mesh == the host counts; the sharded device align (records
    included) == the single device's; the same under a MAX_ARENA = 3 cap.
    Raises AssertionError on a mismatch."""
    from .models.input import load_genomes
    from .models.prefilter import genome_kmer_set
    from .ops import align_gpu
    from .ops.prefilter import (BatchIndexStore, PrefilterIndex,
                                shared_kmer_counts_host,
                                shared_kmer_counts_indexed)
    from .utils.data import example_path

    mesh = make_mesh(n_devices, device=device)

    # 1. The prefilter counts over the mesh, on the example corpus.
    genomes, _ = load_genomes(example_path('multifasta.fna'))
    sets = [genome_kmer_set(g, 25, 1.0) for g in genomes]
    counts = shared_kmer_counts_indexed(PrefilterIndex(sets), mesh=mesh)
    expect = shared_kmer_counts_host(sets)
    np.testing.assert_array_equal(counts, expect)

    # 1b. The batch store's blocks, each over the mesh.
    with tempfile.TemporaryDirectory() as tmp:
        store = BatchIndexStore(tmp)
        for lo in range(0, len(sets), 5):
            store.add_batch(sets[lo:lo + 5], lo)
        nb = len(store.batches)
        got = np.zeros_like(expect)
        for i in range(nb):
            for j in range(i, nb):
                ro, co, blk = store.pair_block(i, j, mesh=mesh)
                got[ro:ro + blk.shape[0], co:co + blk.shape[1]] = blk
                if i != j:
                    got[co:co + blk.shape[1], ro:ro + blk.shape[0]] = blk.T
    np.testing.assert_array_equal(got, expect)

    # 2. The device align engine, its dispatches dealt to the mesh's shards.
    codes = _mutants(np.random.default_rng(0), 4)
    pairs = np.array([(i, j) for i in range(4) for j in range(i + 1, 4)],
                     dtype=np.int32)
    single = align_gpu.all2all_gpu(codes, pairs, keep_alignments=True,
                                   device=mesh.devices[0])
    sharded = align_gpu.all2all_gpu(codes, pairs, keep_alignments=True,
                                    mesh=mesh)
    _assert_same(single, sharded)

    # 2b. Sub-arenas under a genome cap, over the mesh.
    old_cap = align_gpu.MAX_ARENA
    align_gpu.MAX_ARENA = 3
    try:
        capped = align_gpu.all2all_gpu(codes, pairs, keep_alignments=True,
                                       mesh=mesh)
    finally:
        align_gpu.MAX_ARENA = old_cap
    _assert_same(single, capped)
    n_cand = int((counts >= 20).sum() - len(genomes)) // 2
    print(f'dryrun_multichip({n_devices}): OK, {n_cand} candidate pairs, '
          f'{len(pairs)} sharded-aligned pairs', flush=True)


def _assert_same(a, b) -> None:
    """Aggregates and records of two all2all_gpu(keep_alignments=True)
    runs are equal."""
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1][0], b[1][0])
    np.testing.assert_array_equal(a[1][1], b[1][1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--shards', type=int, default=None,
                    help='mesh shards (default: one a visible card)')
    ap.add_argument('--device', default=None,
                    help='put every shard on this device (e.g. cpu)')
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print('entry OK:', [tuple(o.shape) for o in out], flush=True)
    dryrun_multichip(args.shards or len(make_mesh(device=args.device)
                                        .devices), device=args.device)


if __name__ == '__main__':
    main()
