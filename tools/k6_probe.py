#!/usr/bin/env python3
"""K6 (K8 fused in: the v2 seed votes and their two-scale election,
`_votes_elect_v2`) alone on a card at the v2 dispatch shapes of the align
paths that chip_smoke.py drives, whole and with parts cut out.

Points (inputs built from the corpora of chip_smoke.py by
tools/k45_probe.py:v2_dispatch, query rows drawn from --seed):
  v2 65536   the 48 genomes at bucket 65,536: B = 45 rows x K = 8
             queries on an 80 GB card, C = 16, 32-bit packs;
  v2 262144  the v2 corpus of chip_smoke.py at 262,144: B = 11, 64-bit
             packs (the directory samples every 8th value).
At each point the kernel's election, and its votes output, are held
against the plain pair (`votes_elect_v2_plain`) on the same tensors, bit
for bit; then its CUDA-event time (`ms`, the wrapper's host work
included), its device time by torch.profiler (`device_ms`), the device
time with the votes output, and the event time of torch.searchsorted of
the same seeds in the same rows (both strands, the search alone). Then
the kernel's device time as built and in variants with one part cut out
of the source or one constant changed (results not checked):
  k6_search_only  the election cut: each lane's votes summed and written;
  k6_no_counts    no window counts (the sorts, reductions and writes
                  stay);
  k6_no_search    no descents, segments or pack loads (each seed's votes
                  made from its value: the sorts and counts run on data);
  k6_rows_interleaved  the same CTAs, consecutive ones on different rows
                  (every row read at once: what L2 residency is worth);
  k6_runs_of_512, k6_runs_of_128  runs of at least 512 or 128 items a CTA
                  (256 built);
  k6_dir_8192     a directory of 8,192 samples a strand (16,384 built:
                  s doubles at 262,144);
  k6_l2_24mb      the resident CTAs' rows within 24 MB (8 built);
  k6_warps8       three CTAs of 8 warps an SM (two of 16 built).
Each variant is built by nvcc into vclust_tpu_torch/_build/probe/.

Run it from the root of a checkout (it imports that checkout's
chip_smoke.py and vclust_tpu_torch), with one CUDA card:

    python3 tools/k6_probe.py [--seed N] [--reps N]

Prints one JSON line a point, then the card's name and power limit
(nvidia-smi).
"""

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from k45_probe import v2_dispatch  # noqa: E402

# [(text of csrc/align_v2.cu, its replacement)] of each variant.
CUTS = {
    'k6_search_only': [(
        '  sort_lane(x);\n',
        '  {\n    int t = 0;\n    for (int i = 0; i < V; ++i) t += x[i];\n'
        '    a.vb[(size_t)n * 4 * a.NBC + f] = t;\n    return;\n  }\n')],
    'k6_no_counts': [(
        '    const int c = xi < BIG ? 1 + count_le(nx, i, xi + GAP_DIAG) '
        ': 0;\n    eq[i] = xi < BIG ? 1 + count_le(nx, i, xi) : 0;\n',
        '    const int c = xi < BIG;\n    eq[i] = c;\n')],
    'k6_no_search': [
        ('for (int lvl = 0; lvl < a.H; ++lvl)',
         'for (int lvl = 0; lvl < 0; ++lvl)'),
        ('      if (vv < 0 || vv == TOP || seg0[j] + o >= a.NR || cnt[j] < o)'
         ' continue;\n', '      if (true) continue;\n'),
        ('    m1[j] = m0[j] = 0;\n    if (!eqc[j]) continue;\n',
         '    m1[j] = m0[j] = 0;\n    if (v[j >> 1] < 0) continue;\n'
         '    eqc[j] = 1;\n    m1[j] = m0[j] = (long long)v[j >> 1] << 16 '
         '| (v[j >> 1] & 1023) + 1;\n    continue;\n')],
    'k6_rows_interleaved': [(
        '  const int r = blockIdx.x / a.chunks;\n'
        '  const int lo = (blockIdx.x - r * a.chunks) * a.per_cta;\n',
        '  const int r = blockIdx.x % (gridDim.x / a.chunks);\n'
        '  const int lo = blockIdx.x / (gridDim.x / a.chunks) * '
        'a.per_cta;\n')],
    'k6_runs_of_512': [('constexpr int K6_MIN_ITEMS = 256;',
                        'constexpr int K6_MIN_ITEMS = 512;')],
    'k6_runs_of_128': [('constexpr int K6_MIN_ITEMS = 256;',
                        'constexpr int K6_MIN_ITEMS = 128;')],
    'k6_dir_8192': [('constexpr int DIR_SAMPLES = 16384;',
                     'constexpr int DIR_SAMPLES = 8192;')],
    'k6_l2_24mb': [('constexpr long long K6_L2_BYTES = 8LL << 20;',
                    'constexpr long long K6_L2_BYTES = 24LL << 20;')],
    'k6_warps8': [('constexpr int K6_WARPS = 16;',
                   'constexpr int K6_WARPS = 8;'),
                  ('__launch_bounds__(K6_WARPS * 32, SPL <= 2 ? 2 : 1)',
                   '__launch_bounds__(K6_WARPS * 32, SPL <= 2 ? 3 : 2)')],
}


def build_cuts(cuda):
    """Every variant's library, built in parallel: {name: ctypes lib}."""
    from vclust_tpu_torch.utils.build import BUILD_DIR, CSRC_DIR
    out = BUILD_DIR / 'probe'
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cuts in CUTS.items():
        text = (CSRC_DIR / 'align_v2.cu').read_text()
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
        lib = ctypes.CDLL(str(out / f'lib{name}.so'))
        for fn, argtypes in cuda.ALIGN_V2_SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.vk_error_string.argtypes = [ctypes.c_int]
        lib.vk_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def point(torch, cuda, ag, cs, cut_libs, b, r_rows, q_rows, kb, at, reps):
    C = ag.SEEDS_PER_BLOCK
    kw = dict(Lq=kb, Lr=kb, C=C)
    got = ag._votes_elect_v2(b, r_rows, q_rows, want_votes=True, **kw)
    want = ag.votes_elect_v2_plain(b, r_rows, q_rows, want_votes=True, **kw)
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not bool(
                (g == w).all()):
            raise AssertionError(f'K6 at {at}: kernel != plain')
    del got, want

    def run():
        return ag._votes_elect_v2(b, r_rows, q_rows, **kw)

    R, K = q_rows.shape
    NQ = kb // ag.FINE * C
    rr = r_rows.long()
    sv2 = torch.cat([b['sv_f'][rr], b['sv_r'][rr]]).contiguous()
    vals = b['qsv'][q_rows.long()].reshape(R, K * NQ)
    vals2 = torch.cat([vals, vals]).contiguous()
    out = dict(kernel='K6', at=at, C=C, pack_bits=b['pack_bits'],
               eq_plain=True, ms=cs.time_ms(run, reps),
               device_ms=cs.device_ms(run, reps),
               votes_output_device_ms=cs.device_ms(
                   lambda: ag._votes_elect_v2(b, r_rows, q_rows,
                                              want_votes=True, **kw), reps),
               searchsorted_ms=cs.time_ms(
                   lambda: torch.searchsorted(sv2, vals2, right=True), reps))
    del sv2, vals, vals2
    built = cuda.library('align_v2', cuda.ALIGN_V2_SIGNATURES)
    for name, lib in (('built', built), *cut_libs.items()):
        cuda._libs['align_v2'] = lib
        out[name] = cs.device_ms(run, reps)
    cuda._libs['align_v2'] = built
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit('k6_probe.py needs a CUDA card')
    import chip_smoke as cs
    from vclust_tpu_torch.ops import align_gpu as ag
    from vclust_tpu_torch.ops import cuda
    dev = torch.device('cuda')
    secs = cuda.build(('align_v2',))
    print(json.dumps(dict(build_s=secs, ptxas={
        k: cs.ptxas_summary(v) for k, v in cuda.build_log.items()})),
        flush=True)
    cut_libs = build_cuts(cuda)
    for corpus, kb in ((cs.mutant_corpus(), 65536),
                       (cs.v2_corpus(), 262144)):
        b, r_rows, _, q_rows, _, at = v2_dispatch(torch, dev, ag, cs,
                                                  corpus, kb, args.seed)
        point(torch, cuda, ag, cs, cut_libs, b, r_rows, q_rows, kb, at,
              args.reps)
        del b
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == '__main__':
    main()
