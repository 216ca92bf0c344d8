#!/usr/bin/env python3
"""K11 (csrc/cc.cu: connected components, wrapper ops/cc.py:_cc_run) alone
on a card on the graphs of chip_smoke.py's phase cc, as built, beside
other checkouts' csrc/cc.cu (--baseline), and in variants with one part
of the source changed.

Graphs (chip_smoke.py:cc_graphs, from --seed; --graphs picks some):
200,000 nodes with 149,114 edges between ids < 64 apart, a 200,000-node
path of permuted ids, a star on the largest id, isolated nodes with self
loops and duplicate reversed edges; 2,000,000 nodes with (a) ~1.49 M edges
between ids < 64 apart and (b) 8,000,000 random edges, (b) in `cluster`'s
order (unique pairs i < j, sorted); 16,000,000 nodes with 48,000,000
random pairs in that order (`parent` 64 MB, beyond the 50 MB L2).

Variants (each built by nvcc into vclust_tpu_torch/_build/probe/):
  no_skip         the hook runs once over every edge (no sample, no
                  compress, no skip);
  sample_half, sample_2n  a sample of about n / 2 or 2n edges (built: n);
  no_election     no warp election: each lane CASes its own pair's root
                  from the first turn;
  elect_always    the election wherever a lane owes a union (built: only
                  where two neighbouring lanes share a larger root);
  ttas            parent[hi] read from L2 before each CAS of a lane's own
                  loop, and no CAS where hi is no longer a root;
  seq_find        a lane's two chains walked to their roots in turn, not
                  in step;
  no_evict_first  the edges loaded with __ldg in place of __ldcs;
  no_halving      no halving stores anywhere;
  halve_always    halving in the sample's and the other blocks' finds too
                  (built: only where the hook runs once over every edge);
  no_l2_window    no access-policy window, whatever the edges' bytes;
  persistent      one cooperative launch at residency, the parts split by
                  grid syncs, the compress's and the flatten's loads
                  through L2 (__ldcg: an L1 line from the hook could show a
                  former root as a root), no window;
  ctas_4224, ctas_33792  launches of at most 132 x 32 and 132 x 256 CTAs
                  (built: 132 x 128).
Variants combine with '+', applied in order (say no_election+ttas).
Every library's labels are held against the host reference (union-find,
or scipy's components at their least member): one that differs fails the
run. A variant that does not build is reported and left out.

For each graph, each library in turns (the baselines, built, the
variants, built, the baselines): the device time of one call
(chip_smoke.py:device_ms, --reps calls), its CUDA-event time, and the
profiler's time of each launch (chip_smoke.py:k11_parts).

Run it from the root of a checkout, with one CUDA card:

    python3 tools/k11_probe.py [--baseline FILE] [--variants a,b]
                               [--graphs a,b] [--seed N]

Prints one JSON line a graph and library, then the card's name and power
limit (nvidia-smi).
"""

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# The persistent variant: the kernels become device functions of one
# cooperative kernel; the host launches it at residency.
PERSISTENT_KERNEL = '''
__global__ void __launch_bounds__(THREADS)
    cc_persistent(const int* __restrict__ edges, long long E, int* parent,
                  int n, long long blocks, long long s) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  cc_init(parent, n);
  grid.sync();
  if (s >= 2) {
    const long long sample = (blocks + s - 1) / s;
    cc_hook<SAMPLE>(edges, E, sample, s, parent, n);
    grid.sync();
    cc_compress(parent, n);
    grid.sync();
    cc_hook<REST>(edges, E, blocks - sample, s, parent, n);
  } else {
    cc_hook<ALL>(edges, E, blocks, 1, parent, n);
  }
  grid.sync();
  cc_flatten(parent, n);
}

}  // namespace
'''
PERSISTENT_HOST = '''int k11_cc(const int* edges, long long E, int n, int* labels,
           cudaStream_t stream) {
  if (n <= 0) return cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cc_persistent,
                                                THREADS, 0);
  long long blocks = (E + BLOCK_EDGES - 1) / BLOCK_EDGES;
  long long s = sample_stride(E, n);
  void* args[] = {(void*)&edges, &E, &labels, &n, &blocks, &s};
  return cudaLaunchCooperativeKernel((const void*)cc_persistent,
                                     dim3(sms * per_sm), dim3(THREADS),
                                     args, 0, stream);
}

'''
# The seq_find variant: each chain walked to its root in turn, not in step.
SEQ_FIND = '''template <bool HALVE>
__device__ __forceinline__ void find_roots(int* parent, int (&x)[2],
                                           unsigned live, int n) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!(live >> k & 1)) continue;
    for (int steps = 0;; ++steps) {
      const int p = parent[x[k]];
      if (p == x[k]) break;
      const int gp = parent[p];
      if (HALVE && gp != p) parent[x[k]] = gp;
      x[k] = gp;
      if (steps > n) __trap();
    }
  }
}

'''


def _seq_find(text):
    head, rest = text.split(
        'template <bool HALVE>\n__device__ __forceinline__ void '
        'find_roots(', 1)
    _, tail = rest.split('// Unites each lane', 1)
    return head + SEQ_FIND + '// Unites each lane' + tail


def _persistent(text):
    """The kernels as device functions of one cooperative kernel, which the
    host launches at residency in place of launch() and the window."""
    text = _replace(text, [
        ('#include <stdint.h>',
         '#include <stdint.h>\n#include <cooperative_groups.h>'),
        ('    const int p = parent[x];\n    if (p == x) return x;',
         '    const int p = __ldcg(parent + x);\n    if (p == x) return x;')])
    text = text.replace('__global__ void __launch_bounds__(THREADS)',
                        '__device__ __forceinline__ void')
    head, rest = text.split('void launch(const int* edges', 1)
    _, tail = rest.split('}  // namespace\n', 1)
    text = head + PERSISTENT_KERNEL + tail
    head, rest = text.split('int k11_cc(', 1)
    _, tail = rest.split('const char* vk_error_string', 1)
    return head + PERSISTENT_HOST + 'const char* vk_error_string' + tail


VARIANTS = {
    'no_skip': [('SAMPLE_PER_NODE = 1.0;', 'SAMPLE_PER_NODE = 1e30;')],
    'sample_half': [('SAMPLE_PER_NODE = 1.0;', 'SAMPLE_PER_NODE = 0.5;')],
    'sample_2n': [('SAMPLE_PER_NODE = 1.0;', 'SAMPLE_PER_NODE = 2.0;')],
    'no_election': [('  if (__any_sync(FULL, owe && lane > 0 && left == key)) {',
                     '  if (false) {')],
    'elect_always': [('__any_sync(FULL, owe && lane > 0 && left == key)',
                      '__any_sync(FULL, owe)')],
    'ttas': [('    const int seen = atomicCAS(parent + b, b, a);',
              '    int seen = __ldcg(parent + b);\n'
              '    if (seen == b) seen = atomicCAS(parent + b, b, a);')],
    'seq_find': _seq_find,
    'no_evict_first': [('__ldcs(', '__ldg(')],
    'no_halving': [('HALVE = PHASE == ALL;', 'HALVE = false;')],
    'halve_always': [('HALVE = PHASE == ALL;', 'HALVE = true;')],
    'no_l2_window': [('L2_WINDOW = true;', 'L2_WINDOW = false;')],
    'persistent': _persistent,
    'ctas_4224': [('MAX_CTAS = 132 * 128;', 'MAX_CTAS = 132 * 32;')],
    'ctas_33792': [('MAX_CTAS = 132 * 128;', 'MAX_CTAS = 132 * 256;')],
}


def _replace(text, pairs):
    for old, new in pairs:
        if old not in text:
            raise KeyError(old)
        text = text.replace(old, new)
    return text


def build(cuda, texts):
    """{name: ctypes library} of each source text that builds (nvcc in
    parallel); the others are reported and left out."""
    from vclust_tpu_torch.utils.build import BUILD_DIR
    out = BUILD_DIR / 'probe'
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        stem = 'cc_' + name.replace(':', '_')
        (out / f'{stem}.cu').write_text(text)
        procs[name] = (out / f'lib{stem}.so', subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, str(out / f'{stem}.cu'), '-o',
             str(out / f'lib{stem}.so')], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(json.dumps(dict(lib=name, built=False, log=log[-3000:])),
                  flush=True)
            continue
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in cuda.CC_SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.vk_error_string.argtypes = [ctypes.c_int]
        lib.vk_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--baseline', action='append', default=[],
                    help='another csrc/cc.cu, held and timed beside')
    ap.add_argument('--variants', default=','.join(VARIANTS))
    ap.add_argument('--graphs', default='',
                    help='phase cc graphs to run (default: every one)')
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit('CUDA is not available: k11_probe.py needs a GPU')
    import chip_smoke as cs
    from vclust_tpu_torch.ops import cc, cuda
    from vclust_tpu_torch.utils.build import CSRC_DIR
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    built = cuda.library('cc', cuda.CC_SIGNATURES)
    texts = {}
    for path in args.baseline:
        path = pathlib.Path(path)
        texts[f'base:{path.parent.parent.parent.name}'] = path.read_text()
    source = (CSRC_DIR / 'cc.cu').read_text()
    for name in [v for v in args.variants.split(',') if v]:
        text = source
        for part in name.split('+'):
            change = VARIANTS[part]
            text = (change(text) if callable(change)
                    else _replace(text, change))
        texts[name] = text
    libs = dict(built=built, **build(cuda, texts))
    bases = [n for n in libs if n.startswith('base:')]
    others = [n for n in libs if n != 'built' and n not in bases]
    order = [*bases, 'built', *others, 'built', *bases]
    cs.emit(dict(build_s=time.perf_counter() - t0, order=order,
                 ptxas=cs.ptxas_summary(cuda.build_log.get('cc', ''))))
    pick = [g for g in args.graphs.split(',') if g]
    rng = np.random.default_rng(args.seed)
    recipe = cs.near_id_edges(rng, cs.CC_NODES, cs.CC_EDGE_DRAWS)
    try:
        for name, n, edges in cs.cc_graphs(rng, recipe):
            if pick and name not in pick:
                continue
            want = (cs.union_find(n, edges) if n <= cs.CC_NODES
                    else cs.least_member_labels(n, edges))
            e = torch.from_numpy(np.ascontiguousarray(edges, np.int32)).to(
                dev)

            def run():
                cc._cc_run(e, n, trusted=True)

            bound_ms = (4 * e.numel() + 4 * n) / cs.HBM_BYTES_PER_S * 1e3
            for turn, lib_name in enumerate(order):
                cuda._libs['cc'] = libs[lib_name]
                got = cc._cc_run(e, n, trusted=True).cpu().numpy()
                if not np.array_equal(got, want):
                    sys.exit(f'{lib_name} on {name}: labels != reference')
                ms, why = cs.device_ms(run, args.reps)
                cs.emit(dict(graph=name, nodes=n, edges=int(len(edges)),
                             lib=lib_name, turn=turn, equal=True,
                             device_ms=ms, device_ms_why=why,
                             ms=cs.time_ms(run, args.reps),
                             bound_ms=bound_ms,
                             share_of_bound=bound_ms / ms if ms else None,
                             parts=cs.k11_parts(torch, run)))
            cuda._libs['cc'] = built
            del e
            torch.cuda.empty_cache()
    finally:
        cuda._libs['cc'] = built
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({'seconds': time.perf_counter() - t0}), flush=True)


if __name__ == '__main__':
    main()
