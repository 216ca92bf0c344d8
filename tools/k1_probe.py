#!/usr/bin/env python3
"""Where K1 (vclust_tpu_torch/csrc/occupancy.cu) spends its time on a card.

Times the kernel at chip_smoke.py's k1 c size (16,384 genomes, 65,536
patterns from --seed, one pass) as built and in variants with one part
cut out of its source:
  no_products  the consumers issue no products (loads, ring, fragments
               and epilogue);
  no_loads     the producer issues no copies (products on whatever the
               ring holds, ring and epilogue);
  same_rows    every tile loads the same 4 k-blocks of the same rows, so
               the operands stay in L2 and the loads never reach HBM;
and as built with the weights capped at 65,535 and at 255 (2 and 1 limbs
where the index needs 3). Only the full kernel's counts are checked
(against the plain version).
Each variant is built by nvcc into vclust_tpu_torch/_build/probe/ and run
in its own process with a time limit. Needs one CUDA card:

    python3 tools/k1_probe.py [--seed N] [--reps N]

Prints one JSON line a run: CUDA-event ms of each of two timing runs and
the kernels' device ms by torch.profiler; then the card's name and power
limit (nvidia-smi).
"""

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# (text of csrc/occupancy.cu, its replacement) for each variant.
CUTS = {
    'base': [],
    'no_products': [(
        '        wgmma_u8(acc[l0 + p], a[i][p], b_desc + 2 * s);',
        '        ;')],
    'no_loads': [(
        '        mbar_expect_tx(f, bytes);\n',
        '        mbar_arrive(f);\n        if (false) {\n'), (
        '        bulk_load(sW + stage * WB, wbytes + (int64_t)kb * WB, WB, '
        'f);\n',
        '        bulk_load(sW + stage * WB, wbytes + (int64_t)kb * WB, WB, '
        'f);\n        }\n')],
    'same_rows': [(
        'tma_load(sA + stage * TILE_BYTES, &occ_map, f, kb * KB, i0);',
        'tma_load(sA + stage * TILE_BYTES, &occ_map, f, (kb & 3) * KB, 0);'),
        ('if (!diag) tma_load(sB + stage * TILE_BYTES, &occ_map, f, '
         'kb * KB, j0);',
         'if (!diag) tma_load(sB + stage * TILE_BYTES, &occ_map, f, '
         '(kb & 3) * KB, TILE);')],
}


def build(out_dir: pathlib.Path) -> None:
    from vclust_tpu_torch.ops import cuda
    src = (REPO / 'vclust_tpu_torch/csrc/occupancy.cu').read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cuts in CUTS.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                sys.exit(f'{name}: the source no longer holds {old!r}')
            text = text.replace(old, new)
        (out_dir / f'{name}.cu').write_text(text)
        procs[name] = subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, str(out_dir / f'{name}.cu'),
             '-o', str(out_dir / f'lib{name}.so')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f'nvcc failed for {name}:\n{log}')


# (variant, weight cap) of each run.
RUNS = [(name, None) for name in CUTS] + [('base', 65535), ('base', 255)]


def run(name: str, cap, out_dir: pathlib.Path, seed: int,
        reps: int) -> dict:
    import torch
    import chip_smoke as cs
    from vclust_tpu_torch.ops import cuda
    from vclust_tpu_torch.ops import prefilter as pf
    lib = ctypes.CDLL(str(out_dir / f'lib{name}.so'))
    fn = lib.k1_count_chunk
    fn.argtypes = pf._SIGNATURES['k1_count_chunk']
    fn.restype = ctypes.c_int
    dev = torch.device('cuda')
    index = cs.synthetic_index(seed)
    if cap:
        index.weights = np.minimum(index.weights, cap)
    n_limbs, (p,) = pf.device_chunks(index, dev)
    n, ng, nkb = index.n, p.offs.numel() - 1, p.kb_limbs.numel()
    occ = torch.empty((n, nkb * pf.K1_KBLOCK), dtype=torch.uint8, device=dev)
    counts = torch.zeros((n, n), dtype=torch.int32, device=dev)

    def call():
        rc = fn(cuda.ptr(p.gids), cuda.ptr(p.offs), ng, cuda.ptr(p.wbytes),
                cuda.ptr(p.kb_limbs), nkb, cuda.ptr(p.work),
                p.work.shape[0], int(p.split > 1), p.n_limbs, 0,
                cuda.ptr(occ), n, cuda.ptr(counts), cuda.stream(counts))
        if rc:
            raise RuntimeError(f'{name}: CUDA error {rc}')

    call()
    res = {'variant': name, 'max_weight': int(index.weights.max()),
           'n_limbs': n_limbs}
    if name == 'base':
        plain = torch.zeros_like(counts)
        pf.occupancy_count_plain(plain, p.gids, p.offs, p.weights)
        res['eq_plain'] = torch.equal(plain, counts)
        del plain
    res['ms'] = [cs.time_ms(call, reps) for _ in range(2)]
    res.update(cs.device_ms_item(call, reps))
    res['card'] = torch.cuda.get_device_name(0)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reps', type=int, default=5)
    ap.add_argument('--variant', help=argparse.SUPPRESS)
    ap.add_argument('--cap', type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    from vclust_tpu_torch.utils.build import BUILD_DIR
    out_dir = BUILD_DIR / 'probe'
    if args.variant:
        print(json.dumps(run(args.variant, args.cap, out_dir, args.seed,
                             args.reps)), flush=True)
        return
    build(out_dir)
    failed = False
    for name, cap in RUNS:
        try:
            proc = subprocess.run(
                [sys.executable, __file__, '--variant', name,
                 '--seed', str(args.seed), '--reps', str(args.reps),
                 *(['--cap', str(cap)] if cap else [])],
                capture_output=True, text=True, timeout=120)
            line = proc.stdout.strip().splitlines()[-1:] or [proc.stderr]
            print(line[0] if proc.returncode == 0 else json.dumps(
                {'variant': name, 'error': proc.stderr[-2000:]}), flush=True)
            failed |= proc.returncode != 0
        except subprocess.TimeoutExpired:
            print(json.dumps({'variant': name, 'error': 'timed out'}),
                  flush=True)
            failed = True
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sys.exit(1 if failed else 0)


if __name__ == '__main__':
    main()
