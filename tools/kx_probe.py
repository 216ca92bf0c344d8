#!/usr/bin/env python3
"""Where KX (vclust_tpu_torch/csrc/extend.cu) spends its time on a card.

Builds only csrc/extend.cu, as it is and in variants made by text cuts,
into vclust_tpu_torch/_build/probe_kx/, and times KX with CUDA events on
chip_smoke.py's `kx` jobs (65,536 jobs from --seed, aw/am/ar at their
defaults) four ways:
  all         the kx jobs;
  short       the same without the two long edge jobs (the cap job, which
              scans 262,144 positions, and the one across the N run):
              throughput apart from the serial chain;
  cap         the cap job alone: the serial chain;
  a_only      launch A alone on the kx jobs (launch B cut out);
and prints the device time of each launch by torch.profiler. The other
variants time `all` and `cap` with one design choice undone:
  address_per_load  each load computes its 64-bit address (not one pointer
                    and immediate offsets);
  u8, u16           the loads of 8 or 16 steps in flight (not 4);
  first2048, first8192  launch A scans 2,048 or 8,192 positions (not
                    4,096), so more or fewer jobs go on to launch B.
Every variant but a_only is checked against extend_plain. Each runs in its
own process with a time limit. Needs one CUDA card:

    python3 tools/kx_probe.py [--seed N] [--reps N]

Prints one JSON line a variant with the ms of each of two timing runs; then
the card's name and power limit (nvidia-smi). Exits 1 if a variant failed
or the kernel disagreed with extend_plain.
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

# csrc/extend.cu's loads, and the same loads with an address computed for
# each (the kernel before it took immediate offsets).
LOADS = '''\
__device__ __forceinline__ void load_steps(const int32_t* __restrict__ qp,
                                           const int32_t* __restrict__ rp,
                                           int p, int e, int (&a)[U],
                                           int (&b)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = p + 32 * u < e;
    a[u] = in ? __ldg(qp + 32 * u) : 4;
    b[u] = in ? __ldg(rp + 32 * u) : 4;
  }
}'''
LOADS_PER_ADDRESS = '''\
__device__ __forceinline__ void load_steps(const int32_t* __restrict__ q,
                                           const int32_t* __restrict__ r,
                                           int base, int e, int lane,
                                           int (&a)[U], int (&b)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int p = base + 32 * u + lane;
    a[u] = p < e ? __ldg(q + p) : 4;
    b[u] = p < e ? __ldg(r + p) : 4;
  }
}'''

# (text of csrc/extend.cu, its replacement) for each variant.
CUTS = {
    'base': [],
    'a_only': [('  rest_kernel<<<grid_b',
                '  if (false) rest_kernel<<<grid_b')],
    'address_per_load': [(LOADS, LOADS_PER_ADDRESS), (
        '''  const int32_t* qp = q + s + lane;
  const int32_t* rp = r + s + lane;
  load_steps(qp, rp, s + lane, e, a, b);''',
        '  load_steps(q, r, s, e, lane, a, b);'), (
        '''    qp += 32 * U;
    rp += 32 * U;
    load_steps(qp, rp, base + 32 * U + lane, e, na, nb);''',
        '    load_steps(q, r, base + 32 * U, e, lane, na, nb);')],
    'u8': [('constexpr int U = 4; ', 'constexpr int U = 8; ')],
    'u16': [('constexpr int U = 4; ', 'constexpr int U = 16; ')],
    'first2048': [('constexpr int FIRST = 4096;',
                   'constexpr int FIRST = 2048;')],
    'first8192': [('constexpr int FIRST = 4096;',
                   'constexpr int FIRST = 8192;')],
}


def build(out_dir: pathlib.Path) -> dict:
    from vclust_tpu_torch.ops import cuda
    src = (REPO / 'vclust_tpu_torch/csrc/extend.cu').read_text()
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
    logs = {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f'nvcc failed for {name}:\n{logs[name]}')
    return logs


def run(name: str, out_dir: pathlib.Path, seed: int, reps: int) -> list:
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from vclust_tpu_torch.ops import cuda
    from vclust_tpu_torch.ops import extend as kx
    from vclust_tpu_torch.ops.lz_parse_py import AlignParams
    lib = ctypes.CDLL(str(out_dir / f'lib{name}.so'))
    lib.kx_extend.argtypes = kx._SIGNATURES['kx_extend']
    lib.kx_extend.restype = ctypes.c_int
    dev = torch.device('cuda')
    p = AlignParams()
    q, r, qi, ri, _ = cs.kx_jobs(np.random.default_rng(seed))
    nq, nr = len(q), len(r)
    put = [torch.from_numpy(np.ascontiguousarray(a, np.int32).reshape(-1)
                            ).to(dev)
           for a in (kx.pad_codes(q), kx.pad_codes(r), qi, ri)]
    keep = torch.ones(len(qi), dtype=torch.bool, device=dev)
    keep[[0, 2]] = False
    sets = {'all': put[2:], 'short': [put[2][keep], put[3][keep]],
            'cap': [put[2][:1].clone(), put[3][:1].clone()]}
    if name == 'a_only':
        sets = {'all': sets['all']}
    elif name != 'base':
        sets = {'all': sets['all'], 'cap': sets['cap']}
    out = []
    for what, (a, b) in sets.items():
        n = a.numel()
        lens = torch.empty(n, dtype=torch.int32, device=dev)
        matches = torch.empty_like(lens)
        scratch = torch.empty(2 * n + 2, dtype=torch.int32, device=dev)

        def call():
            rc = lib.kx_extend(
                cuda.ptr(put[0]), cuda.ptr(put[1]), cuda.ptr(a), cuda.ptr(b),
                n, nq, nr, p.aw, p.am, p.ar, cuda.ptr(lens),
                cuda.ptr(matches), cuda.ptr(scratch), cuda.stream(lens))
            if rc:
                raise RuntimeError(f'{name}: CUDA error {rc}')

        call()
        res = {'variant': name, 'jobs': what, 'n': n}
        if name != 'a_only':
            want = kx.extend_plain(put[0], put[1], a, b, nq, nr, p.aw, p.am,
                                   p.ar)
            res['eq_plain'] = (torch.equal(lens, want[0])
                               and torch.equal(matches, want[1]))
            res['listed_for_b'] = int(scratch[2 * n])
        res['ms'] = [cs.time_ms(call, reps) for _ in range(2)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        res['device_ms'] = {e.key: e.self_device_time_total / 1e3 / reps
                            for e in prof.key_averages()
                            if e.self_device_time_total}
        res['card'] = torch.cuda.get_device_name(0)
        out.append(res)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--variant', help=argparse.SUPPRESS)
    args = ap.parse_args()
    from vclust_tpu_torch.utils.build import BUILD_DIR
    out_dir = BUILD_DIR / 'probe_kx'
    if args.variant:
        results = run(args.variant, out_dir, args.seed, args.reps)
        for res in results:
            print(json.dumps(res), flush=True)
        sys.exit(0 if all(res.get('eq_plain', True) for res in results)
                 else 1)
    logs = build(out_dir)
    import chip_smoke as cs
    print(json.dumps({'ptxas': cs.ptxas_summary(logs['base'])}), flush=True)
    failed = False
    for name in CUTS:
        try:
            proc = subprocess.run(
                [sys.executable, __file__, '--variant', name,
                 '--seed', str(args.seed), '--reps', str(args.reps)],
                capture_output=True, text=True, timeout=300)
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
