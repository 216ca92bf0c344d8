#!/usr/bin/env python3
"""The port's mesh paths across several cards of one host, against one card.

Builds the kernels and, over a mesh of every visible card (or --shards
shards of cuda:0), times and checks:
  k1      K1's count (`shared_kmer_counts_indexed`) of chip_smoke.py's case
          c (16,384 genomes, 65,536 patterns from --seed) and of c with
          its patterns 8 times over, new weights (524,288 patterns): one
          card, then each pass's work list cut among the mesh's shards
          (every launch first, the devices' counts added on the first card,
          one n x n copy to the host); == bit for bit; the wall of each,
          and of the launches alone (to the cards' sync);
  align   all2all_gpu (the hybrid, with records) on chip_smoke.py's 48
          genomes: one card, then the dispatches dealt to the shards;
          == bit for bit, warm pairs/s of each;
  start   a fresh process's first tensor on one card and on every card
          (the contexts' start-up), 3 times each;
  cli     `python -m vclust_tpu_torch align --engine gpu --out-aln` on the
          48 genomes and on 192 (3 more mutants of each at 5%), and
          `prefilter` on the 192, each in a process that sees one card
          (CUDA_VISIBLE_DEVICES), and over `auto_mesh()` in one that sees
          them all (the JAX package's CLI takes that mesh; the port's
          stays on one card), in the order one, mesh, mesh, one: the wall
          of each process, files == byte for byte;
  workers one `python -m vclust_tpu_torch.parallel.worker` process a
          shard, each on its shard's device, one gloo group: each prints
          MULTIHOST_OK;
  dryrun  `dryrun_multichip` over the mesh.
Needs CUDA:

    python3 tools/mesh_probe.py [--seed N] [--shards N] [--parts k1,cli]

Prints one JSON line a part, then the cards' names and power limits
(nvidia-smi). Exits 1 on a mismatch or a failed part.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def heavier(idx, times: int, seed: int):
    """`idx` with its patterns `times` over, each copy with new weights."""
    from vclust_tpu_torch.ops.prefilter import index_from_numpy
    rng = np.random.default_rng(seed)
    lens = np.tile(idx.lens, times)
    weights = rng.integers(1, 70001, len(lens)).astype(np.int64)
    return index_from_numpy(idx.n, idx.sizes, np.tile(idx.gids, times), lens,
                            weights)


def more_mutants(corpus, times: int, seed: int):
    """`corpus` and `times - 1` mutants of each genome at 5%
    substitutions, as chip_smoke.py's mutant_corpus makes its 48."""
    from vclust_tpu_torch.models.input import Genome
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b'ACGT', dtype='S1')
    out = list(corpus)
    for rep in range(1, times):
        for g in corpus:
            s = np.frombuffer(g.seqs[0], dtype='S1').copy()
            mask = rng.random(len(s)) < 0.05
            s[mask] = acgt[rng.integers(0, 4, mask.sum())]
            out.append(Genome(name=f'{g.name}.m{rep}', seqs=[s.tobytes()]))
    return out


def start_walls(cards: int, reps: int = 3) -> dict:
    """Seconds a fresh process takes to make its first tensor on each of
    one card and of `cards` cards (the contexts' start), alternated."""
    code = ('import time, torch; t0 = time.perf_counter(); '
            '[torch.zeros(1, device=f"cuda:{i}") for i in range({k})]; '
            'torch.cuda.synchronize(); print(time.perf_counter() - t0)')
    out = {'one_card_s': [], 'mesh_s': []}
    for _ in range(reps):
        for key, k in (('one_card_s', 1), ('mesh_s', cards)):
            run = subprocess.run([sys.executable, '-c', code.replace(
                '{k}', str(k))], capture_output=True, text=True, check=True)
            out[key].append(float(run.stdout))
    return out


# Runs the CLI with its device work over `auto_mesh()`: the mesh that
# the JAX package's CLI takes when several devices are visible.
CLI_OVER_MESH = """
import sys
from vclust_tpu_torch import cli
from vclust_tpu_torch.models import prefilter
from vclust_tpu_torch.ops import align_gpu
from vclust_tpu_torch.parallel.mesh import auto_mesh
mesh = auto_mesh()
counts, align = prefilter.shared_kmer_counts, align_gpu.all2all_gpu
prefilter.shared_kmer_counts = lambda *a, **kw: counts(
    *a, **dict(kw, mesh=mesh))
align_gpu.all2all_gpu = lambda *a, **kw: align(*a, **dict(kw, mesh=mesh))
cli.main(sys.argv[1:])
"""


def cli_walls(stage: str, corpus, work: pathlib.Path, cards: int) -> dict:
    """Wall seconds of `prefilter` or `align --engine gpu --out-aln` on
    `corpus`: the CLI in a process that sees one card, and the CLI over
    `auto_mesh()` (CLI_OVER_MESH) in one that sees all `cards`, in the
    order one, mesh, mesh, one; the files of every run must be equal."""
    from vclust_tpu_torch.io.fasta import FastaRecord, write_fasta
    fasta = work / f'{stage}{len(corpus)}.fna'
    write_fasta(fasta, [FastaRecord(g.name, g.name, g.seqs[0])
                        for g in corpus])
    names = (['fltr.txt'] if stage == 'prefilter' else
             ['ani.tsv', 'ani.ids.tsv', 'ani.aln.tsv'])
    out, files = {'one_card_s': [], 'mesh_s': []}, []
    for i, key in enumerate(('one_card_s', 'mesh_s', 'mesh_s',
                             'one_card_s')):
        d = work / f'{stage}{len(corpus)}_{i}'
        d.mkdir()
        one = key == 'one_card_s'
        visible = '0' if one else ','.join(map(str, range(cards)))
        cmd = ([sys.executable] + (['-m', 'vclust_tpu_torch'] if one else
                                   ['-c', CLI_OVER_MESH])
               + [stage, '-i', str(fasta), '-o', str(d / names[0]), '-v',
                  '0'])
        if stage == 'align':
            cmd += ['--out-aln', str(d / 'ani.aln.tsv'), '--engine', 'gpu']
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=visible,
                   PYTHONPATH=str(REPO))
        t0 = time.perf_counter()
        subprocess.run(cmd, cwd=REPO, env=env, check=True)
        out[key].append(time.perf_counter() - t0)
        files.append([(d / f).read_bytes() for f in names])
    out['equal'] = all(f == files[0] for f in files)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--shards', type=int, default=None,
                    help='shards of cuda:0 (default: one a visible card)')
    ap.add_argument('--parts', default='k1,align,cli,workers,dryrun',
                    help='the parts to run, comma-separated')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit('CUDA is not available: mesh_probe.py needs a GPU')
    import chip_smoke as cs
    from vclust_tpu_torch.entry import dryrun_multichip
    from vclust_tpu_torch.ops import align_gpu as ag
    from vclust_tpu_torch.ops import cuda
    from vclust_tpu_torch.ops import prefilter as pf
    from vclust_tpu_torch.parallel.mesh import make_mesh

    cuda.build()
    dev = torch.device('cuda', 0)
    mesh = (make_mesh() if args.shards is None
            else make_mesh(args.shards, device=dev))
    shards = len(mesh.devices)
    out = dict(part='mesh', cards=torch.cuda.device_count(), shards=shards,
               devices=[str(d) for d in mesh.devices])
    print(json.dumps(out), flush=True)

    def timed(fn, reps=2):
        walls, res = [], None
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            walls.append(time.perf_counter() - t0)
        return res, walls

    def part_k1():
        idx_c = cs.synthetic_index(args.seed)
        ok = True
        for case, idx in (('c', idx_c),
                          ('c x 8', heavier(idx_c, 8, args.seed))):
            one, one_s = timed(lambda: pf.shared_kmer_counts_indexed(
                idx, engine='device', device=dev))
            pf.occupancy_count.launches = 0
            many, many_s = timed(lambda: pf.shared_kmer_counts_indexed(
                idx, mesh=mesh))
            launches = pf.occupancy_count.launches // 2
            equal = bool(np.array_equal(one, many))
            ok &= equal
            del one, many
            # The launches alone: K1's passes into each card's counts, to
            # the sync of every card (the sums and the host copy left out).
            n = idx.n
            _, chunks = pf.device_chunks(idx, dev, shards=shards)
            parts = [pf.k1_split_work(c.work.cpu().numpy(),
                                      c.kb_limbs.cpu().numpy(), shards)
                     for c in chunks]
            runs = {}
            for s_, d in enumerate(mesh.devices):
                runs.setdefault(d, []).extend(
                    pf.k1_shard(c, p[s_], d) for c, p in zip(chunks, parts)
                    if len(p[s_]))
            sums = {d: torch.zeros((n, n), dtype=torch.int32, device=d)
                    for d in runs}
            whole = torch.zeros((n, n), dtype=torch.int32, device=dev)
            one_plan = pf.device_chunks(idx, dev)[1]

            def sync():
                for d in sums:
                    torch.cuda.synchronize(d)

            def launch_mesh():
                for d, sub in runs.items():
                    for c in sub:
                        pf.occupancy_count(sums[d], c)
                sync()

            def launch_one():
                for c in one_plan:
                    pf.occupancy_count(whole, c)
                sync()

            _, one_launch_s = timed(launch_one, 3)
            _, mesh_launch_s = timed(launch_mesh, 3)
            del sums, whole, runs, chunks, one_plan
            print(json.dumps(dict(
                part='k1', case=case, n=idx.n, patterns=int(len(idx.lens)),
                one_card_s=one_s, mesh_s=many_s,
                one_card_launches_s=one_launch_s,
                mesh_launches_s=mesh_launch_s,
                launches_a_run=launches, equal=equal)), flush=True)
            torch.cuda.empty_cache()
        return ok

    def part_align():
        codes, pairs = cs.align_inputs(cs.mutant_corpus())
        single, single_s = timed(lambda: ag.all2all_gpu(
            codes, pairs, keep_alignments=True, device=dev), 3)
        sharded, sharded_s = timed(lambda: ag.all2all_gpu(
            codes, pairs, keep_alignments=True, mesh=mesh), 3)
        ok = bool(np.array_equal(single[0], sharded[0])
                        and np.array_equal(single[1][0], sharded[1][0])
                        and np.array_equal(single[1][1], sharded[1][1]))
        print(json.dumps(dict(
            part='align', corpus='genomes48', pairs=len(pairs),
            one_card_s=single_s, mesh_s=sharded_s,
            pairs_per_s={'one_card': len(pairs) / min(single_s[1:]),
                         'mesh': len(pairs) / min(sharded_s[1:])},
            equal=ok)), flush=True)
        return ok

    def part_cli():
        cards = torch.cuda.device_count()
        print(json.dumps(dict(part='start', cards=cards,
                              **start_walls(cards))), flush=True)
        ok = True
        g48 = cs.mutant_corpus()
        g192 = more_mutants(g48, 4, args.seed)
        with tempfile.TemporaryDirectory(prefix='mesh_probe_') as tmp:
            for stage, corpus in (('align', g48), ('align', g192),
                                  ('prefilter', g192)):
                walls = cli_walls(stage, corpus, pathlib.Path(tmp), cards)
                ok &= walls['equal']
                print(json.dumps(dict(part='cli', stage=stage,
                                      genomes=len(corpus), cards=cards,
                                      **walls)), flush=True)
        return ok

    def part_workers():
        t0 = time.perf_counter()
        lines = cs.run_workers([str(d) for d in mesh.devices], 1)
        print(json.dumps(dict(part='workers', processes=len(lines),
                              seconds=time.perf_counter() - t0,
                              lines=lines)), flush=True)
        return len(lines) == shards

    def part_dryrun():
        t0 = time.perf_counter()
        dryrun_multichip(shards, device=None if args.shards is None else dev)
        print(json.dumps(dict(part='dryrun',
                              seconds=time.perf_counter() - t0)), flush=True)
        return True

    oks = [fn() for name, fn in (
        ('k1', part_k1), ('align', part_align), ('cli', part_cli),
        ('workers', part_workers), ('dryrun', part_dryrun))
        if name in args.parts.split(',')]
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    if not all(oks):
        sys.exit(1)


if __name__ == '__main__':
    main()
