#!/usr/bin/env python3
"""Where K2 and K3 (vclust_tpu_torch/csrc/align_v3.cu) spend their time on
a card.

Times both kernels at chip_smoke.py's B = 26 dispatch shapes at bucket
65,536 on inputs made from --seed, as built and in variants with one part
cut out of the source:
  K2 no_products   the consumers issue no products (loads, ring and
                   epilogue on whatever the accumulators hold);
  K2 no_loads      the producer issues no copies (products on whatever
                   the ring holds, ring and epilogue);
  K2 no_epilogue   no packed maxes (loads, products and the atomics);
  K3 three_planes  every band takes the "is a base" planes, as bands with
                   N do;
  K3 no_stores     the counts are not stored (the election is).
K2's inputs: 26 reference rows x 8 queries over arenas of 48 rows of
2*NQB = 1,024 query half-blocks and NRB = 2,048 reference blocks, H =
2,048 buckets at 3% occupancy. K3's (stages 2-4, the wide rows read in
place): the same 26 x 8 tasks over arenas of 48 rows of wide rows (NRB =
2,048 rows of 384 codes a strand at V3_WQ = 128) and query codes (65,536),
codes 0-3 with N runs of 7 in 3% of the rows and of 4 in 1% of the query
blocks, and candidates g1, g2 drawn at random: 425,984 fine blocks. Only
the built kernels' results are checked (against the plain versions).
Each variant is built by nvcc into
vclust_tpu_torch/_build/probe/ and run in its own process with a time
limit. Needs one CUDA card:

    python3 tools/k23_probe.py [--seed N] [--reps N]

Prints one JSON line a run with the CUDA-event ms of each of two timing
runs; then the card's name and power limit (nvidia-smi).
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

# (text of csrc/align_v3.cu, its replacement) for each variant.
CUTS = {
    'base': [],
    'k2_no_products': [(
        '        wgmma_ss(acc, a_desc + 2 * s, b_desc + 2 * s, kb | s);',
        '        ;')],
    'k2_no_loads': [(
        '          mbar_expect_tx(f, T::A_BYTES + T::B_BYTES);\n',
        '          mbar_arrive(f);\n          if (false) {\n'), (
        '          tma_load_3d(sB + stage * T::B_BYTES, &r_map, f, '
        'kb * K2_KB, n0, rg);\n',
        '          tma_load_3d(sB + stage * T::B_BYTES, &r_map, f, '
        'kb * K2_KB, n0, rg);\n          }\n')],
    'k2_no_epilogue': [(
        '    for (int c8 = 0; c8 < BN / 8; ++c8) {\n',
        '    for (int c8 = 0; c8 < 0; ++c8) {\n')],
    'k3_three_planes': [(
        'if (bases && qv[k] == FULL)', 'if (false)')],
    'k3_no_stores': [(
        '    out[t] = (int8_t)c;\n', '')],
}
# The kernel each variant is timed for.
KERNELS = {'base': ('k2', 'k3')}
KERNELS.update({name: (name[:2],) for name in CUTS if name != 'base'})

H, M2, NRB, G, ROWS, K = 2048, 1024, 2048, 48, 26, 8
LQ = 65536
N_FINE = ROWS * K * (LQ // 32)


def build(out_dir: pathlib.Path) -> None:
    from vclust_tpu_torch.ops import cuda
    src = (REPO / 'vclust_tpu_torch/csrc/align_v3.cu').read_text()
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


def k2_inputs(torch, dev, rng):
    qocc = (rng.random((G, M2, H)) < 0.03).astype(np.int8)
    rocc = (rng.random((G, NRB, H)) < 0.03).astype(np.int8)
    r_rows = rng.integers(0, G, ROWS).astype(np.int32)
    q_rows = rng.integers(0, G, (ROWS, K)).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (qocc, rocc, r_rows,
                                                  q_rows)]


def k3_inputs(torch, dev, rng):
    """The arena (wide rows of both strands, query codes), r_rows, rlens,
    q_rows and stage 1's cnt1, g1, cnt2, g2 of K3 at bucket 65,536."""
    from vclust_tpu_torch.ops import align_gpu as ag
    g3 = ag._v3_geom(LQ, LQ)
    rows = rng.integers(0, 4, (2, G, NRB, g3['ROWW'])).astype(np.int8)
    hit = rng.random((2, G, NRB)) < 0.03
    rows[hit, 100:107] = 4
    fwd = rng.integers(0, 4, (G, LQ)).astype(np.int8)
    blk = fwd.reshape(G, LQ // 32, 32)
    blk[rng.random((G, LQ // 32)) < 0.01, 5:9] = 4
    shape = (ROWS, K, g3['NQB'])
    b = {k: torch.from_numpy(a).to(dev) for k, a in (
        ('roww_f', rows[0]), ('roww_r', rows[1]), ('fwd', fwd))}
    args = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        rng.integers(0, G, ROWS), rng.integers(LQ // 2, LQ + 1, ROWS),
        rng.integers(0, G, (ROWS, K)), rng.integers(0, 12, shape),
        rng.integers(0, NRB, shape), rng.integers(0, 8, shape),
        rng.integers(0, NRB, shape))]
    return b, args, g3


def run(name: str, out_dir: pathlib.Path, seed: int, reps: int) -> list:
    import torch
    import chip_smoke as cs
    from vclust_tpu_torch.ops import align_gpu as ag
    from vclust_tpu_torch.ops import cuda
    lib = ctypes.CDLL(str(out_dir / f'lib{name}.so'))
    for fn, argtypes in cuda.ALIGN_V3_SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    dev = torch.device('cuda')
    rng = np.random.default_rng(seed)
    out = []
    if 'k2' in KERNELS[name]:
        qocc, rocc, r_rows, q_rows = k2_inputs(torch, dev, rng)
        p = torch.zeros((3, ROWS, K, M2 // 2), dtype=torch.int32, device=dev)

        def call():
            p.zero_()
            rc = lib.k2_stage1(
                cuda.ptr(qocc), cuda.ptr(rocc), cuda.ptr(r_rows),
                cuda.ptr(q_rows), ROWS * K, K, G, G, M2, NRB, H,
                cuda.ptr(p[0]), cuda.ptr(p[1]), cuda.ptr(p[2]),
                cuda.stream(p))
            if rc:
                raise RuntimeError(f'{name}: CUDA error {rc}')

        call()
        res = {'variant': name, 'kernel': 'K2'}
        if name == 'base':
            want = ag.stage1_pack_plain(qocc, rocc, r_rows, q_rows)
            res['eq_plain'] = all(torch.equal(p[i], want[i])
                                  for i in range(3))
        res['ms'] = [cs.time_ms(call, reps) for _ in range(2)]
        out.append(res)
        del qocc, rocc, p
    if 'k3' in KERNELS[name]:
        b, args, g3 = k3_inputs(torch, dev, rng)
        NBF = LQ // 32
        cnt = torch.empty((4, ROWS, K, NBF, g3['BAND']), dtype=torch.int8,
                          device=dev)
        best, D = (torch.empty((ROWS, K, NBF), dtype=torch.int32,
                               device=dev) for _ in range(2))
        A, S = (torch.empty((ROWS, K, NBF), dtype=torch.bool, device=dev)
                for _ in range(2))
        tband, smin = ag.V3_TBAND, ag.V3_SMIN

        def call():
            rc = lib.k3_row_bands(
                *(cuda.ptr(t) for t in (b['roww_f'], b['roww_r'], b['fwd'],
                                        *args)),
                ROWS * K, K, g3['NQB'], NRB, g3['FPB'], tband, smin,
                max(smin // 2, 3),
                *(cuda.ptr(t) for t in (cnt, best, A, S, D)),
                cuda.stream(cnt))
            if rc:
                raise RuntimeError(f'{name}: CUDA error {rc}')

        call()
        res = {'variant': name, 'kernel': 'K3'}
        if name == 'base':
            want = ag.bands_v3_plain(b, *args, tband, smin, g3)
            res['eq_plain'] = all(torch.equal(x, want[k]) for k, x in (
                ('cnt', cnt), ('cnt_best', best), ('A', A), ('S', S),
                ('D', D)))
            del want
        res['ms'] = [cs.time_ms(call, reps) for _ in range(2)]
        out.append(res)
    for res in out:
        res['card'] = torch.cuda.get_device_name(0)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reps', type=int, default=10)
    ap.add_argument('--variant', help=argparse.SUPPRESS)
    args = ap.parse_args()
    from vclust_tpu_torch.utils.build import BUILD_DIR
    out_dir = BUILD_DIR / 'probe'
    if args.variant:
        for res in run(args.variant, out_dir, args.seed, args.reps):
            print(json.dumps(res), flush=True)
        return
    build(out_dir)
    failed = False
    for name in CUTS:
        try:
            proc = subprocess.run(
                [sys.executable, __file__, '--variant', name,
                 '--seed', str(args.seed), '--reps', str(args.reps)],
                capture_output=True, text=True, timeout=180)
            if proc.returncode == 0:
                print(proc.stdout.strip(), flush=True)
            else:
                print(json.dumps({'variant': name,
                                  'error': proc.stderr[-2000:]}), flush=True)
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
