#!/usr/bin/env python3
"""K10 (the v2 index build, csrc/index.cu, wrapper
ops/align_gpu.py:_index_block) alone on a card at the three v2 arenas of
chip_smoke.py's align paths, each launch timed apart, beside another
checkout's K10 in the same call.

Arenas (codes padded as GenomeIndex lays them out, k = SEED_K):
  65536 C16   24 genomes of the 48-genome corpus (ids 0-23) at bucket
              65,536, C = 16, 32-bit packs (the hybrid's v2 arena);
  262144 C16  the 8 genomes of the v2 corpus at 262,144, C = 16, 64-bit
              packs (align_v2's arena);
  262144 C8   the same at C = 8 (its PHASE1_C arena).

At each arena every library's arena is held against index_block_plain,
every array bit for bit, written into arrays filled with a poison byte
(0x5A) so that an element the kernel leaves unwritten shows, `--checks`
times (a library that differs fails the run, naming the arrays and the
elements that differ and how many hold the poison, but for the variants
with a part cut out, whose arenas are not compared); then, for
each library in turns (base, built, built, base), its CUDA-event time of
one wrapper call (`ms`: output allocation and host work included, 20
calls), its device time (chip_smoke.py:device_ms, 20 calls) and the
profiler's device time of each of its launches by kernel name. Beside
them the arena's bytes bound (chip_smoke.py:v2_index_build's count) and
the event time of torch.sort(stable=True) of both strands' selected
values (chip_smoke.py's library_ms).

--baseline FILE (given once or more) builds another csrc/index.cu (say
the parent commit's, from git show into an ignored directory), named
`base:` and its directory's name; a source whose K10 has the earlier C
interface (k10_scratch_rows, k10_meta_ints: a scratch and a meta array a
call) is called through that interface.
--variants a,b builds the built source with one part changed (see
VARIANTS), held and timed the same way.

Run it from the root of a checkout, with one CUDA card:

    python3 tools/k10_probe.py [--baseline FILE] [--variants a,b]
                               [--reps N]

Prints one JSON line an arena and library, then the card's name and power
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

# {name: [(text of csrc/index.cu, its replacement)]}, each text found once.
VARIANTS = {
    # the look-back reads one word at a time
    'look_1': [('constexpr int LOOK = 8;', 'constexpr int LOOK = 1;')],
    # the look-back polls without a pause
    'spin_no_sleep': [('        __nanosleep(SPIN_NS);\n', '')],
    # the passes' digit peers from __match_any_sync, not 9 ballots
    'match_any': [('      const unsigned peers = digit_peers(d);',
                   '      const unsigned peers = __match_any_sync(FULL, d);')],
    # the passes' CTAs held to 3 or 4 an SM (registers capped to fit)
    'pass_lb3': [('__launch_bounds__(K10_THREADS)\nindex_v2_pass(',
                  '__launch_bounds__(K10_THREADS, 3)\nindex_v2_pass(')],
    'pass_lb4': [('__launch_bounds__(K10_THREADS)\nindex_v2_pass(',
                  '__launch_bounds__(K10_THREADS, 4)\nindex_v2_pass(')],
    # the selection's CTAs held to 6 an SM
    'sel_lb6': [('__launch_bounds__(K10_THREADS)\nindex_v2_select(',
                 '__launch_bounds__(K10_THREADS, 6)\nindex_v2_select(')],
    # tiles of 2,048 items (8 a lane)
    'ipt_8': [('constexpr int K10_IPT = 16;', 'constexpr int K10_IPT = 8;')],
    # selection CTAs of 128 fine blocks (16 a warp)
    'sel_bpw_16': [('constexpr int SEL_BPW = 8;',
                    'constexpr int SEL_BPW = 16;')],
    # Parts cut out (their arenas differ from the plain version's and are
    # not held against it; every store stays inside its row):
    # the selection's bitonic network,
    'cut_sel_sort': [(
        '        const int other = __shfl_xor_sync(FULL, key, stride);\n'
        '        key = keep_min >> st & 1 ? min(key, other) : max(key, other);'
        '\n', '')],
    # its k-mer values (v from two codes),
    'cut_sel_kmer': [(
        '    const int v = kmer_doubling<K>(cd[j], cd[j + 1], lane);',
        '    const int v = cd[j] + cd[j + 1];')],
    # its digit counts (the totals stay 0: the tiles overlap at the row's
    # start, and the second pass takes no item),
    'cut_sel_counts': [(
        '          atomicAdd(&hist[q * DIGITS + ((vv[j] >> 8 * q) & 255)], '
        '1);',
        '          ;')],
    # its window rows,
    'cut_sel_rows': [(
        'for (int c = threadIdx.x; c < 4 * (nb + 1); c += K10_THREADS) {',
        'for (int c = threadIdx.x; c < 0; c += K10_THREADS) {')],
    # the passes' look-back (each tile placed as the row's first),
    'cut_pass_lookback': [
        ('      excl = look_back(st, tile, epoch);', '      excl = 0;'),
        ('      dst[gofs[digit_of(x, pass)] + i] = x;',
         '      dst[min((long long)gofs[digit_of(x, pass)] + i, a.NQ - 1)] = '
         'x;')],
    # the passes' stores.
    'cut_pass_store': [('      dst[gofs[digit_of(x, pass)] + i] = x;',
                        '      if (x == 12345u) dst[i] = x;')],
}
# The earlier C interface of K10: {function: argtypes}.
_P, _I = ctypes.c_void_p, ctypes.c_int
EARLIER = {
    'k10_scratch_rows': [_I, _I],
    'k10_meta_ints': [_I, _I],
    'k10_index_v2': [_P] * 2 + [_I] * 6 + [_P] * 12,
}


def build(cuda, texts):
    """{name: ctypes library} of each source text, nvcc in parallel."""
    from vclust_tpu_torch.utils.build import BUILD_DIR
    out = BUILD_DIR / 'probe'
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        stem = 'index_' + name.replace(':', '_')
        (out / f'{stem}.cu').write_text(text)
        procs[name] = (out / f'lib{stem}.so', subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, str(out / f'{stem}.cu'), '-o',
             str(out / f'lib{stem}.so')], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f'nvcc failed for {name}:\n{log}')
        lib = ctypes.CDLL(str(path))
        sigs = (EARLIER if hasattr(lib, 'k10_meta_ints')
                else cuda.INDEX_SIGNATURES)
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.vk_error_string.argtypes = [ctypes.c_int]
        lib.vk_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def caller(torch, ag, cuda, lib, fwd, rc, C, pb):
    """A call of K10 from `lib` as its wrapper makes it: the outputs
    allocated (or `out`), then the kernel (the built wrapper, or the
    earlier interface's scratch and meta a call)."""
    k = ag.SEED_K
    if not hasattr(lib, 'k10_meta_ints'):
        def run(out=None):
            cuda._libs['index'] = lib
            return ag._index_block(fwd, rc, k, pb, C, out=out)
        return run
    G, Lp = fwd.shape
    NQ = Lp // ag.FINE * C
    dev = fwd.device

    def run(out=None):
        out = out or ag.index_v2_empty(G, Lp, pb, C, dev)
        rows = lib.k10_scratch_rows(G, NQ)
        scratch = torch.empty((rows, NQ), dtype=torch.int64, device=dev)
        meta = torch.empty(lib.k10_meta_ints(rows, NQ), dtype=torch.int32,
                           device=dev)
        rc_ = lib.k10_index_v2(
            cuda.ptr(fwd), cuda.ptr(rc), G, Lp, k, C, pb, rows,
            *(cuda.ptr(t) for t in out), cuda.ptr(scratch), cuda.ptr(meta),
            cuda.stream(fwd))
        cuda.check(lib, rc_, 'k10_index_v2')
        return out
    return run


def host_us(torch, fn, n=100) -> float:
    """The host's microseconds a call of fn (n calls queued, then one
    synchronize)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def host_split(torch, ag, cuda, lib, fwd, rc, C, pb) -> dict:
    """The built wrapper's host microseconds a call, and of its parts: the
    argument checks, the outputs' allocation, the entry point's call (its
    launches) with its arguments made."""
    G, Lp = fwd.shape
    k = ag.SEED_K
    out = ag.index_v2_empty(G, Lp, pb, C, fwd.device)
    ag._index_block(fwd, rc, k, pb, C, out=out)
    key = (fwd.device.index,
           torch.cuda.current_stream(fwd.device).cuda_stream)
    state, items = ag._K10_STATE[key], ag._K10_ITEMS[key]
    args = [t.data_ptr() for t in (fwd, rc)] + [G, Lp, k, C, pb] + [
        t.data_ptr() for t in out] + [
        state.data_ptr(), 4 * state.numel(), items.data_ptr(),
        4 * items.numel(), torch.cuda.current_stream().cuda_stream]
    return dict(
        wrapper=host_us(torch, lambda: ag._index_block(fwd, rc, k, pb, C)),
        wrapper_out=host_us(torch, lambda: ag._index_block(fwd, rc, k, pb,
                                                           C, out=out)),
        checks=host_us(torch, lambda: ag._index_codes(fwd, rc, 'K10')),
        outputs=host_us(torch, lambda: ag.index_v2_empty(G, Lp, pb, C,
                                                         fwd.device)),
        entry=host_us(torch, lambda: lib.k10_index_v2(*args)))


def check(torch, ag, run, want, G, Lp, pb, C, dev) -> list:
    """One call of `run` into poisoned arrays: [] where every array equals
    `want`, else each differing array's name, count of differing elements
    and how many of those still hold the poison."""
    out = ag.index_v2_empty(G, Lp, pb, C, dev)
    for t in out:
        t.view(torch.int8).fill_(0x5A)
    poison = {t.dtype: t.flatten()[0].clone() for t in out}
    run(out)
    torch.cuda.synchronize()
    bad = []
    for key, g, w in zip(ag._V2_KEYS, out, want):
        if not torch.equal(g, w):
            ne = g != w
            bad.append([key, int(ne.sum()),
                        int((g[ne] == poison[g.dtype]).sum())])
    return bad


def launch_split(torch, run) -> dict:
    """The profiler's device ms of each of K10's kernels in one call, by
    name (summed over a kernel's launches), and their count."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if 'index_v2' in e.key and e.self_device_time_total > 0:
            name = e.key.split('index_v2_')[1].split('<')[0].split('(')[0]
            out[name] = [e.self_device_time_total / 1e3, e.count]
    return out


def arenas(torch, ag, cs, dev):
    """(label, fwd, rc, C, pack bits, bytes bound's bytes) of each arena."""
    from vclust_tpu_torch.core.seq import revcomp_codes
    import numpy as np
    for corpus, kb, G, Cs in ((cs.mutant_corpus(), 65536, 24, (16,)),
                              (cs.v2_corpus(), 262144, 8, (16, 8))):
        codes = cs.align_inputs(corpus)[0][:G]
        fwd = np.full((len(codes), kb), 4, np.int8)
        rc = fwd.copy()
        for r, c in enumerate(codes):
            fwd[r, :len(c)] = c
            rc[r, :len(c)] = revcomp_codes(c)
        fwd, rc = (torch.from_numpy(x).to(dev) for x in (fwd, rc))
        pb = ag._pack_bits(kb)
        for C in Cs:
            NQ = kb // ag.FINE * C
            nbytes = (2 * G * kb + G * NQ * (16 + 8 * (4 if pb == 32 else 2))
                      + G * 2 * (kb // ag.FINE + 1) * 64)
            yield (f'{kb} C{C}: {G} genomes, {pb}-bit packs', fwd, rc, C,
                   pb, nbytes)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--baseline', action='append', default=[],
                    help='another csrc/index.cu, held and timed beside')
    ap.add_argument('--variants', default='',
                    help=f'variants of the built source, of {list(VARIANTS)}')
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--checks', type=int, default=1,
                    help='calls of each library held against the plain '
                         'version at each arena')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit('k10_probe.py needs a CUDA card')
    import chip_smoke as cs
    from vclust_tpu_torch.ops import align_gpu as ag
    from vclust_tpu_torch.ops import cuda
    from vclust_tpu_torch.utils.build import CSRC_DIR
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    built = cuda.library('index', cuda.INDEX_SIGNATURES)
    texts = {}
    for path in args.baseline:
        path = pathlib.Path(path)
        texts[f'base:{path.parent.name}'] = path.read_text()
    for name in [v for v in args.variants.split(',') if v]:
        text = (CSRC_DIR / 'index.cu').read_text()
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                sys.exit(f'{name}: the source no longer holds {old!r} once')
            text = text.replace(old, new)
        texts[name] = text
    libs = dict(built=built, **build(cuda, texts))
    bases = [n for n in libs if n.startswith('base:')]
    others = [n for n in libs if n != 'built' and n not in bases]
    order = [*bases, 'built', *others, 'built', *bases]
    cs.emit(dict(build_s=time.perf_counter() - t0, order=order,
                 ptxas={k: v for k, v in cs.ptxas_summary(
                     cuda.build_log.get('index', '')).items()
                     if 'index_v2' in k}))
    try:
        for at, fwd, rc, C, pb, nbytes in arenas(torch, ag, cs, dev):
            want = ag.index_block_plain(fwd, rc, ag.SEED_K, pb, C)
            sel_r = ag.index_block_plain(rc, rc, ag.SEED_K, pb, C)[0]
            keys = torch.cat([torch.where(x < 0, ag.BIG, x)
                              for x in (want[0], sel_r)]).contiguous()
            library_ms = cs.time_ms(
                lambda: torch.sort(keys, dim=1, stable=True), args.reps)
            cs.emit(dict(at=at, host_us=host_split(torch, ag, cuda, built,
                                                   fwd, rc, C, pb)))
            G, Lp = fwd.shape
            for turn, name in enumerate(order):
                run = caller(torch, ag, cuda, libs[name], fwd, rc, C, pb)
                try:
                    for _ in range(args.checks):
                        bad = check(torch, ag, run, want, G, Lp, pb, C, dev)
                        if bad:
                            break
                    equal = not bad
                    if bad and not name.startswith('cut_'):
                        cs.emit(dict(at=at, lib=name, turn=turn, differ=bad))
                        sys.exit(f'{name} at {at}: the arena != plain')
                    ms = cs.time_ms(run, args.reps)
                    dms, why = cs.device_ms(run, args.reps)
                    cs.emit(dict(
                        at=at, lib=name, turn=turn, equal=equal, ms=ms,
                        device_ms=dms, device_ms_why=why,
                        launches=launch_split(torch, run),
                        bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
                        share_of_bound=(nbytes / cs.HBM_BYTES_PER_S * 1e3
                                        / dms if dms else None),
                        library_ms=library_ms))
                finally:
                    cuda._libs['index'] = built
            del want, sel_r, keys
            torch.cuda.empty_cache()
    finally:
        cuda._libs['index'] = built
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({'seconds': time.perf_counter() - t0}), flush=True)


if __name__ == '__main__':
    main()
