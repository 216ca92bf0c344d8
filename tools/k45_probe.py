#!/usr/bin/env python3
"""K5 (v3 stages 5-6, `_propagate_v3`) and K4 (the back half,
`_blocks_to_measures`) alone on a card, at the dispatch shapes of the
align paths that chip_smoke.py drives.

Points (inputs built from the corpora of chip_smoke.py, query rows drawn
from --seed):
  v3 65536   the 48 genomes at bucket 65,536: B rows x K = 8 queries
             (B = 34, NBF = 2,048), K5 (its windows read from the wide
             rows) and then K4 on K5's outputs;
  v3 4096    contigs128 at bucket 4,096 (B = 546, NBF = 128), the same;
  v2 65536   the 48 genomes' v2 dispatch at 65,536 (B = 45): K4 on the
             v2 front end's flags;
  v2 262144  the v2 corpus of chip_smoke.py at 262,144 (B = 11, NBF =
             8,192): K4.
At each point the kernel's outputs are held against its plain version on
the same tensors (bit for bit); then, unless --check-only, its CUDA-event
time (`ms`, the wrapper's host work included), its device time
(`device_ms`, chip_smoke.py:device_ms), their difference (the host time)
and its bound from chip_smoke.py (`k5_bytes`, `k4_bound`) with the share
of the bound that the device time reaches. K4 runs without and with
records.

With --cuts it times, at the same points, the kernels as built and in
variants with one part cut out of the source (results not checked):
  k5_no_gathers  no candidate table loads (every count -1);
  k5_no_steps    no adoption steps;
  k5_no_flags    no window or query-base loads and no flag rows written;
  k4_no_loads    no flag or per-block loads (words made from the index);
  k4_no_dense    the 15-window density rule replaced by a copy;
  k4_no_lookback the state before a chunk taken as the pair's start
                 (published, not read);
  k4_no_publish  neither published nor read.
Each variant is built by nvcc into vclust_tpu_torch/_build/probe/.

Run it from the root of a checkout (it imports that checkout's
chip_smoke.py and vclust_tpu_torch), with one CUDA card:

    python3 tools/k45_probe.py [--seed N] [--reps N] [--check-only]
                               [--cuts] [--rows B65536,B4096]

Prints one JSON line a point and kernel (and variant), then the card's
name and power limit (nvidia-smi).
"""

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


# (source, [(text of csrc/<source>.cu, its replacement)]) of each variant.
CUTS = {
    'k5_no_gathers': ('align_v3', [(
        'if (g < 0 || g >= K5_TILE || !(s0s[g] & 4)) continue;',
        'continue;')]),
    'k5_no_steps': ('align_v3', [(
        'for (int step = 0; step < 2 * E; ++step) {',
        'for (int step = 0; step < 0; ++step) {')]),
    'k5_no_flags': ('align_v3', [(
        'for (int i0 = i_lo; i0 < i_hi; i0 += 4 * K5_UNROLL) {',
        'for (int i0 = i_hi; i0 < i_hi; i0 += 4 * K5_UNROLL) {')]),
    'k4_no_loads': ('back_half', [(
        '  BlockRaw r;\n',
        '  BlockRaw r{};\n  r.m1a.x = (uint32_t)o * 2654435761u;\n'
        '  if (o != ~(size_t)0) return r;\n')]),
    'k4_no_dense': ('back_half', [(
        'de[i] = dense_ends(mwin[i - 1], mwin[i]);', 'de[i] = mwin[i];')]),
    'k4_no_lookback': ('back_half', [(
        'const State X = c > 0 ? look_back(', 'const State X = false ? '
        'look_back(')]),
    'k4_no_publish': ('back_half', [
        ('const State X = c > 0 ? look_back(', 'const State X = false ? '
         'look_back('),
        ('if (later && tid == 0) publish(a, unit, sm, epoch, 1);', ''),
        ('if (later) publish(a, unit, Y, epoch, 2);', '')]),
}


def build_cuts(cuda):
    """Every variant's library, built in parallel: {name: ctypes lib}."""
    from vclust_tpu_torch.utils.build import BUILD_DIR, CSRC_DIR
    out = BUILD_DIR / 'probe'
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, cuts) in CUTS.items():
        text = (CSRC_DIR / f'{src}.cu').read_text()
        for old, new in cuts:
            if text.count(old) != 1:
                sys.exit(f'{name}: the source no longer holds {old!r}')
            text = text.replace(old, new)
        (out / f'{name}.cu').write_text(text)
        procs[name] = subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, str(out / f'{name}.cu'), '-o',
             str(out / f'lib{name}.so')], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f'nvcc failed for {name}:\n{log}')
        src = CUTS[name][0]
        sigs = (cuda.ALIGN_V3_SIGNATURES if src == 'align_v3'
                else cuda.BACK_HALF_SIGNATURES)
        lib = ctypes.CDLL(str(out / f'lib{name}.so'))
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.vk_error_string.argtypes = [ctypes.c_int]
        lib.vk_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def variants(cuda, ag, cut_libs, kernel):
    """(name, swap-in) for the built kernel and each variant of `kernel`;
    swap-in puts the variant's library in the wrappers' place (and K4 a
    fresh scratch buffer)."""
    src = 'align_v3' if kernel == 'K5' else 'back_half'
    built = cuda.library(src, cuda.ALIGN_V3_SIGNATURES if src == 'align_v3'
                         else cuda.BACK_HALF_SIGNATURES)

    def use(lib):
        def swap():
            cuda._libs[src] = lib
            ag._K4_SCRATCH.clear()
        return swap
    yield 'built', use(built)
    for name, lib in cut_libs.items():
        if name.startswith(kernel.lower()):
            yield name, use(lib)
    use(built)()


def v3_inputs(torch, dev, ag, cs, corpus, kb, seed, rows=None):
    """One full v3 dispatch at bucket kb: K5's inputs (the `_bands_v3`
    dict; the arena, r_rows, rlens, q_rows, g1, g2; the geometry) and the
    rows' reference lengths."""
    import numpy as np
    codes, pairs = cs.align_inputs(corpus)
    lens = [len(c) for c in codes]
    gids = sorted({g for i, j in pairs.tolist() for g in (i, j)
                   if max(ag._pad_bucket(lens[i]),
                          ag._pad_bucket(lens[j])) == kb})
    b = ag.GenomeIndex(codes, device=dev).ensure_v3(kb, gids)
    g3 = ag._v3_geom(kb, kb)
    K = ag.K_QUERIES
    B = rows or ag._dispatch_rows(kb, K, dev, False)
    rng = np.random.default_rng(seed)
    long_ = [g for g in b['rows'] if ag._pad_bucket(len(codes[g])) == kb]
    refs = [long_[w % len(long_)] for w in range(B)]
    r_rows = torch.tensor([b['rows'][g] for g in refs], dtype=torch.int32,
                          device=dev)
    rlens = torch.tensor([len(codes[g]) for g in refs], dtype=torch.int32,
                         device=dev)
    q_rows = torch.from_numpy(rng.integers(
        0, len(b['rows']), (B, K)).astype(np.int32)).to(dev)
    s1 = ag._stage1_v3(b['qocc'], b['rocc'], r_rows, q_rows)
    el = ag._bands_v3(b, r_rows, rlens, q_rows, *s1, ag.V3_TBAND,
                      ag.V3_SMIN, g3)
    args = (b, r_rows, rlens, q_rows, s1[1], s1[3])
    rl = rlens[:, None].expand(B, K).reshape(B * K)
    return el, args, g3, rl, f'v3 bucket {kb}: B={B} x K={K}, NBF={kb // 32}'


def v2_dispatch(torch, dev, ag, cs, corpus, kb, seed):
    """One full v2 dispatch at bucket kb of the corpus's pairs: the arena,
    B rows of K queries drawn from `seed` (r_rows, rlens, q_rows, qlens)
    and its label."""
    import numpy as np
    codes, pairs = cs.align_inputs(corpus)
    lens = [len(c) for c in codes]
    gids = sorted({g for i, j in pairs.tolist() for g in (i, j)
                   if max(ag._pad_bucket(lens[i]),
                          ag._pad_bucket(lens[j])) == kb})
    b = ag.GenomeIndex(codes, device=dev).ensure(kb, gids)
    K = ag.K_QUERIES
    B = ag._dispatch_rows_v2(kb, K, False)
    rng = np.random.default_rng(seed)
    refs = [gids[w % len(gids)] for w in range(B)]

    def put(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    r_rows = put([b['rows'][g] for g in refs])
    rlens = put([len(codes[g]) for g in refs])
    qg = rng.choice(gids, (B, K))
    q_rows = put([[b['rows'][g] for g in row] for row in qg])
    qlens = put([[len(codes[g]) for g in row] for row in qg])
    return (b, r_rows, rlens, q_rows, qlens,
            f'v2 bucket {kb}: B={B} x K={K}, NBF={kb // 32}')


def v2_inputs(torch, dev, ag, cs, corpus, kb, seed):
    """One full v2 dispatch at bucket kb: K4's inputs from the v2 front
    end."""
    b, r_rows, rlens, q_rows, qlens, at = v2_dispatch(torch, dev, ag, cs,
                                                      corpus, kb, seed)
    C = ag.SEEDS_PER_BLOCK
    A, S, D = ag._votes_elect_v2(b, r_rows, q_rows, Lq=kb, Lr=kb, C=C)[:3]
    flags = ag._propagate_v2(b, r_rows, rlens, q_rows, qlens, A, S, D, Lr=kb)
    B, K = q_rows.shape
    flat = [x.reshape((B * K,) + x.shape[2:]) for x in flags]
    rl = rlens[:, None].expand(B, K).reshape(B * K)
    return flat, rl, at


def timed(cs, fn, reps, check_only):
    if check_only:
        return {}
    ms = cs.time_ms(fn, reps)
    dev = cs.device_ms_item(fn, reps)
    dms = dev['device_ms']
    return dict(ms=ms, **dev, host_ms=None if dms is None else ms - dms)


def same(got, want, what):
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not bool(
                (g == w).all()):
            raise AssertionError(f'{what}: kernel != plain')


def cut_times(cs, cuda, ag, cut_libs, kernel, fn, at, reps, **extra):
    """Device ms of fn (a call of `kernel`'s wrapper) as built and in each
    variant."""
    out = dict(kernel=kernel, at=at, **extra)
    for name, swap in variants(cuda, ag, cut_libs, kernel):
        swap()
        out[name] = cs.device_ms(fn, reps)[0]
    print(json.dumps(out), flush=True)


def k5_point(torch, ag, cs, el, args, g3, at, reps, check_only):
    got = ag._propagate_v3(el, *args, g3)
    same(got, ag.propagate_v3_plain(el, *args, g3), f'K5 at {at}')
    out = dict(kernel='K5', at=at, eq_plain=True,
               **timed(cs, lambda: ag._propagate_v3(el, *args, g3), reps,
                       check_only))
    if not check_only:
        out['bound_ms'] = cs.k5_bytes(torch, ag, el, args, g3) \
            / cs.HBM_BYTES_PER_S * 1e3
        if out['device_ms']:
            out['share_of_bound'] = out['bound_ms'] / out['device_ms']
    print(json.dumps(out), flush=True)
    return got


def k4_point(torch, ag, cs, flat, rl, Lq, at, reps, check_only):
    p = ag.AlignParams()
    kw = dict(Lq=Lq, mqd=p.mqd, mrd=p.mrd, reg=p.reg)
    for alns in (False, True):
        def run(fn, alns=alns):
            return fn(*flat, rl, with_alns=alns, **kw)
        got = run(ag._blocks_to_measures)
        want = run(ag.blocks_to_measures_plain)
        same(got if alns else (got,), want if alns else (want,),
             f'K4 at {at} (records {alns})')
        out = dict(kernel='K4', at=at, records=alns, eq_plain=True,
                   **timed(cs, lambda: run(ag._blocks_to_measures), reps,
                           check_only))
        if not check_only:
            out.update(cs.k4_bound(rl.shape[0], Lq,
                                   got[1].shape[1] if alns else 0))
            if out['device_ms']:
                out['share_of_bound'] = out['bound_ms'] / out['device_ms']
        print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--check-only', action='store_true',
                    help='compare with the plain versions, time nothing')
    ap.add_argument('--cuts', action='store_true',
                    help='time the variants with a part cut out')
    ap.add_argument('--rows', default='',
                    help='B at 65,536 and at 4,096, as "B1,B2" (default: '
                         'the live-bytes budget\'s)')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit('k45_probe.py needs a CUDA card')
    import chip_smoke as cs
    from vclust_tpu_torch.ops import align_gpu as ag
    from vclust_tpu_torch.ops import cuda
    dev = torch.device('cuda')
    secs = cuda.build(('align_v3', 'back_half'))
    print(json.dumps(dict(build_s=secs, ptxas={
        k: cs.ptxas_summary(v) for k, v in cuda.build_log.items()})),
        flush=True)
    reps, chk = args.reps, args.check_only
    cut_libs = build_cuts(cuda) if args.cuts else None
    p = ag.AlignParams()
    kw = dict(mqd=p.mqd, mrd=p.mrd, reg=p.reg)

    def k4(flat, rl, kb, at):
        if cut_libs is None:
            k4_point(torch, ag, cs, flat, rl, kb, at, reps, chk)
            return
        for alns in (False, True):
            cut_times(cs, cuda, ag, cut_libs, 'K4', lambda: (
                ag._blocks_to_measures(*flat, rl, Lq=kb, with_alns=alns,
                                       **kw)), at, reps, records=alns)

    rows = [int(x) for x in args.rows.split(',')] if args.rows else [0, 0]
    for (corpus, kb), B in zip(((cs.mutant_corpus(), 65536),
                                (cs.contig_corpus(), 4096)), rows):
        el, k5_args, g3, rl, at = v3_inputs(torch, dev, ag, cs, corpus, kb,
                                            args.seed, B)
        outs = k5_point(torch, ag, cs, el, k5_args, g3, at, reps,
                        chk or cut_libs is not None)
        if cut_libs is not None:
            cut_times(cs, cuda, ag, cut_libs, 'K5',
                      lambda: ag._propagate_v3(el, *k5_args, g3), at, reps)
        N = rl.shape[0]
        flat = [x.reshape((N,) + x.shape[2:]) for x in outs]
        del el, outs, k5_args
        k4(flat, rl, kb, at)
        del flat
        torch.cuda.empty_cache()
    for corpus, kb in ((cs.mutant_corpus(), 65536),
                       (cs.v2_corpus(), 262144)):
        flat, rl, at = v2_inputs(torch, dev, ag, cs, corpus, kb, args.seed)
        k4(flat, rl, kb, at)
        del flat
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == '__main__':
    main()
