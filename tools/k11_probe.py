#!/usr/bin/env python3
"""K11 (csrc/cc.cu: connected components, wrapper ops/cc.py:_cc_run) alone
on a card on the graphs of chip_smoke.py's phase cc, as built and in
variants with one part of the source changed.

Graphs (chip_smoke.py:cc_graphs, from --seed): 200,000 nodes with 149,114
edges between ids < 64 apart, a 200,000-node path of permuted ids, a star
on the largest id; 2,000,000 nodes with (a) ~1.49 M edges between ids < 64
apart and (b) 8,000,000 random edges.

Variants (each built by nvcc into vclust_tpu_torch/_build/probe/):
  ld_cg       parent read with ld.global.cg (L2 only) in place of the
              plain, L1-cached loads;
  no_halving  the hook's finds walk to the root without stores;
  ctas_4224, ctas_8448, ctas_33792  grid-stride launches of at most
              132 x 32, 64 and 256 CTAs (built: 132 x 128);
  ctas_unbounded  a thread an item.
Every variant's labels are held against the host reference (union-find,
or scipy's components at their least member): a variant that differs
fails the run.

For each graph and each library (built, the variants, and the built one
again last): the device time of one call (chip_smoke.py:device_ms, 10
calls) and the profiler's time of each of the three launches (init,
hook, flatten).

Run it from the root of a checkout, with one CUDA card:

    python3 tools/k11_probe.py [--seed N] [--variants a,b]

Prints one JSON line a graph and library, then the card's name and power
limit (nvidia-smi).
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

VARIANTS = {
    'ld_cg': [('return parent[x];', 'return __ldcg(parent + x);')],
    'no_halving': [('if (gp != p) parent[x] = gp;', '')],
    'ctas_4224': [('MAX_CTAS = 132 * 128;', 'MAX_CTAS = 132 * 32;')],
    'ctas_8448': [('MAX_CTAS = 132 * 128;', 'MAX_CTAS = 132 * 64;')],
    'ctas_33792': [('MAX_CTAS = 132 * 128;', 'MAX_CTAS = 132 * 256;')],
    'ctas_unbounded': [('MAX_CTAS = 132 * 128;', 'MAX_CTAS = 0x7fffffff;')],
}


def build_variants(cuda, names):
    """{name: ctypes library} of each variant of csrc/cc.cu, built in
    parallel."""
    from vclust_tpu_torch.utils.build import BUILD_DIR, CSRC_DIR
    out = BUILD_DIR / 'probe'
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = (CSRC_DIR / 'cc.cu').read_text()
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                sys.exit(f'{name}: the source no longer holds {old!r} once')
            text = text.replace(old, new)
        (out / f'cc_{name}.cu').write_text(text)
        procs[name] = subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, str(out / f'cc_{name}.cu'),
             '-o', str(out / f'libcc_{name}.so')], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f'nvcc failed for {name}:\n{log}')
        libs[name] = load_lib(out / f'libcc_{name}.so')
    return libs


def load_lib(path):
    import ctypes
    from vclust_tpu_torch.ops import cuda
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in cuda.CC_SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.vk_error_string.argtypes = [ctypes.c_int]
    lib.vk_error_string.restype = ctypes.c_char_p
    return lib


def launch_split(torch, run) -> dict:
    """The profiler's device ms of each of K11's kernels in one call."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for part in ('cc_init', 'cc_hook', 'cc_flatten'):
            if part in e.key and e.self_device_time_total > 0:
                out[part] = e.self_device_time_total / 1e3
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--variants', default=','.join(VARIANTS))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit('CUDA is not available: k11_probe.py needs a GPU')
    import chip_smoke as cs
    from vclust_tpu_torch.ops import cc, cuda
    dev = torch.device('cuda')
    names = [v for v in args.variants.split(',') if v]
    t0 = time.perf_counter()
    built = cuda.library('cc', cuda.CC_SIGNATURES)
    libs = {'built': built, **build_variants(cuda, names)}
    order = ['built', *names, 'built']
    emit = cs.emit
    emit(dict(build_s=time.perf_counter() - t0, order=order))
    rng = np.random.default_rng(args.seed)
    recipe = cs.near_id_edges(rng, cs.CC_NODES, cs.CC_EDGE_DRAWS)
    for name, n, edges in cs.cc_graphs(rng, recipe):
        if name.startswith('isolated'):
            continue
        want = (cs.union_find(n, edges) if n <= cs.CC_NODES
                else cs.least_member_labels(n, edges))
        e = torch.from_numpy(np.ascontiguousarray(edges, np.int32)).to(dev)

        def run():
            cc._cc_run(e, n, trusted=True)

        for k, lib_name in enumerate(order):
            cuda._libs['cc'] = libs[lib_name]
            try:
                got = cc._cc_run(e, n, trusted=True).cpu().numpy()
                if not np.array_equal(got, want):
                    sys.exit(f'{lib_name} on {name}: labels != reference')
                ms, why = cs.device_ms(run, 10)
                emit(dict(graph=name, nodes=n, edges=int(len(edges)),
                          lib=lib_name, turn=k, equal=True, device_ms=ms,
                          device_ms_why=why,
                          bound_ms=(4 * e.numel() + 4 * n)
                          / cs.HBM_BYTES_PER_S * 1e3,
                          split=launch_split(torch, run)))
            finally:
                cuda._libs['cc'] = built
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({'seconds': time.perf_counter() - t0}), flush=True)


if __name__ == '__main__':
    main()
