#!/usr/bin/env python3
"""K6 (K8 fused in: the v2 seed votes and their two-scale election,
`_votes_elect_v2`) and K7 (the v2 propagation and flags, `_propagate_v2`)
alone on a card at the v2 dispatch shapes of the align paths that
chip_smoke.py drives, whole and with parts cut out.

Points (inputs built from the corpora of chip_smoke.py by
tools/k45_probe.py:v2_dispatch, query rows drawn from --seed):
  v2 65536   the 48 genomes at bucket 65,536: B = 45 rows x K = 8
             queries on an 80 GB card, C = 16, 32-bit packs;
  v2 262144  the v2 corpus of chip_smoke.py at 262,144: B = 11, 64-bit
             packs (the directory samples every 8th value).
K7 runs on the election K6 makes at the point.

At each point each kernel's outputs are held against its plain version on
the same tensors, bit for bit (K6: the election, and its votes output,
against the plain pair `votes_elect_v2_plain`; K7: all nine outputs
against `propagate_v2_plain`); then its CUDA-event time (`ms`, the
wrapper's host work included) and its device time (`device_ms`,
chip_smoke.py:device_ms: the stream's busy time while a spin kernel holds
the calls queued), with K6's votes output and, beside K6, the event time
of torch.searchsorted of the same seeds in the same rows (both strands,
the search alone); beside K7 its bound (chip_smoke.py:k7_least) and, on
the election, the masks a table of every candidate would evaluate
(`k7_tasks`: a block's assigned runs of one state in [i - EXT_ITERS - 1,
i + EXT_ITERS] whose state is not its own). Then each kernel's device time
as built and in variants with one part cut out of the source or one
constant changed (results not checked):
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
  k6_warps8       three CTAs of 8 warps an SM (two of 16 built);
  K7_CUTS's variants (see there).
Each variant is built by nvcc into vclust_tpu_torch/_build/probe/.

--baseline FILE (given once or more) builds another csrc/align_v2.cu (say
the parent commit's, from git show into an ignored directory), named
`base:` and the name of its directory, and holds and times its K6 and K7
at each point beside the built ones, in the same call.
--trace-check N takes N torch.profiler traces of K6, its votes output and
K7 at each point and prints, by kernel name, the events' count and their
total, least and largest duration beside the calls' device time: what the
profiler's sums (as chip_smoke.py's device_ms once took them) may lose.

Run it from the root of a checkout (it imports that checkout's
chip_smoke.py and vclust_tpu_torch), with one CUDA card:

    python3 tools/k6_probe.py [--seed N] [--reps N] [--kernels k6,k7]
                              [--baseline FILE] [--trace-check N]

Prints one JSON line a point, kernel and check, then the card's name and
power limit (nvidia-smi).
"""

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from k45_probe import same, v2_dispatch  # noqa: E402

# [(text of csrc/align_v2.cu, its replacement)] of each variant, the text
# found once; (text, replacement, n): found n times, each replaced.
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
# K7's variants:
#   k7_no_flags    the flag rows (m1, m0) not written (the states are);
#   k7_no_steps    no adoption steps (nor the masks listed before them);
#   k7_no_tasks    the listed masks at a neighbour's state not evaluated
#                  (no window loads or compares: the table holds the entry);
#   k7_no_own      no own masks (a count made from the diagonal);
#   k7_own_only    no mask at a neighbour's state evaluated and no steps:
#                  the own masks and the outputs;
#   k7_outputs_only  no own masks either: the states read and the query
#                  staged, the outputs written;
#   k7_warps8      8 warps a CTA, 3 CTAs an SM (4 warps, 6 CTAs built);
#   k7_ctas4, k7_ctas8  4 or 8 CTAs of 4 warps an SM the registers allow
#                  (6 built: 24 warps);
#   k7_tile128     tiles of 128 blocks, 4 a lane (64, 2 a lane built).
K7_CUTS = {
    'k7_no_flags': [(
        '        if (ib < i_lo || ib >= i_hi) continue;',
        '        if (true) continue;')],
    'k7_no_steps': [(
        'step < 2 * E && quiet < 2; ++step) {',
        'step < 0 && quiet < 2; ++step) {')],
    'k7_no_tasks': [(
        'tile.tab[tile.slot(i, g) * K7_TILE + i] = mask_at(i, g);',
        'tile.tab[tile.slot(i, g) * K7_TILE + i] = (uint32_t)e;')],
    'k7_no_own': [(
        'own[j] = (asg0 >> j) & 1u ? k7_match(w[j], qx) : 0u;',
        'own[j] = (asg0 >> j) & 1u ? (uint32_t)d0[j] * 2654435761u : 0u;')],
    'k7_own_only': [
        ('if (T) run(T);', '(void)T;', 2),
        ('step < 2 * E && quiet < 2; ++step) {',
         'step < 0 && quiet < 2; ++step) {')],
    'k7_outputs_only': [
        ('own[j] = (asg0 >> j) & 1u ? k7_match(w[j], qx) : 0u;',
         'own[j] = (asg0 >> j) & 1u ? (uint32_t)d0[j] * 2654435761u : 0u;'),
        ('if (T) run(T);', '(void)T;', 2),
        ('step < 2 * E && quiet < 2; ++step) {',
         'step < 0 && quiet < 2; ++step) {')],
    'k7_warps8': [('constexpr int K7_WARPS = 4;',
                   'constexpr int K7_WARPS = 8;'),
                  ('constexpr int K7_MIN_CTAS = 6;',
                   'constexpr int K7_MIN_CTAS = 3;')],
    'k7_ctas4': [('constexpr int K7_MIN_CTAS = 6;',
                  'constexpr int K7_MIN_CTAS = 4;')],
    'k7_ctas8': [('constexpr int K7_MIN_CTAS = 6;',
                  'constexpr int K7_MIN_CTAS = 8;')],
    'k7_tile128': [('constexpr int K7_BPT = 2;', 'constexpr int K7_BPT = 4;')],
}
CUTS.update(K7_CUTS)


def load_lib(cuda, path):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in cuda.ALIGN_V2_SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.vk_error_string.argtypes = [ctypes.c_int]
    lib.vk_error_string.restype = ctypes.c_char_p
    return lib


def build_cuts(cuda, kernels, baselines=()):
    """The library of every variant of `kernels` (and of each baseline
    source), built in parallel: {name: ctypes lib}; the ptxas report of
    each."""
    from vclust_tpu_torch.utils.build import BUILD_DIR, CSRC_DIR
    out = BUILD_DIR / 'probe'
    out.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name, cuts in CUTS.items():
        if name.split('_')[0] not in kernels:
            continue
        text = (CSRC_DIR / 'align_v2.cu').read_text()
        for old, new, *n in cuts:
            if text.count(old) != (n[0] if n else 1):
                sys.exit(f'{name}: the source no longer holds {old!r} '
                         f'{n[0] if n else 1} times')
            text = text.replace(old, new)
        texts[name] = text
    for path in baselines:
        path = pathlib.Path(path)
        texts[f'base:{path.parent.name}'] = path.read_text()
    procs = {}
    for name, text in texts.items():
        (out / f'{name}.cu').write_text(text)
        procs[name] = subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, str(out / f'{name}.cu'), '-o',
             str(out / f'lib{name}.so')], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f'nvcc failed for {name}:\n{logs[name]}')
        libs[name] = load_lib(cuda, out / f'lib{name}.so')
    return libs, logs


def with_lib(cuda, lib, fn):
    """fn() with `lib` in the place of the built align_v2 library."""
    built = cuda.library('align_v2', cuda.ALIGN_V2_SIGNATURES)
    cuda._libs['align_v2'] = lib
    try:
        return fn()
    finally:
        cuda._libs['align_v2'] = built


def k7_tasks(torch, A, S, D, iters):
    """The masks a table of every candidate state would evaluate beyond
    each block's own: for block i, the assigned runs of one state (a run's
    first block, or the window's first) among [i - E - 1, i + E] whose
    state is not block i's own (where block i is assigned), E =
    EXT_ITERS; tiles ignored. Their mean a block, the share of blocks with
    one, and the share of 128-block windows without any."""
    NBF = A.shape[-1]
    a = A.reshape(-1, NBF)
    key = D.reshape(-1, NBF).long() * 2 + S.reshape(-1, NBF).long()
    same_prev = torch.zeros_like(a)
    same_prev[:, 1:] = a[:, :-1] & a[:, 1:] & (key[:, 1:] == key[:, :-1])
    start = a & ~same_prev
    tasks = torch.zeros(a.shape, dtype=torch.int32, device=a.device)

    def at(x, o, fill):          # x[:, i + o]
        y = torch.full_like(x, fill)
        if o >= 0:
            y[:, :NBF - o] = x[:, o:]
        else:
            y[:, -o:] = x[:, :NBF + o]
        return y

    for o in range(-iters - 1, iters + 1):
        ag_, st, kg = at(a, o, False), at(start, o, False), at(key, o, -1)
        cand = ag_ & (st | (o == -iters - 1))
        tasks += (cand & ~(a & (kg == key))).int()
    win = tasks[:, :NBF // 128 * 128].reshape(-1, 128)
    return dict(tasks_per_block=float(tasks.float().mean()),
                blocks_with_tasks=float((tasks > 0).float().mean()),
                windows_without=float((win.sum(dim=1) == 0).float().mean()))


def trace_check(torch, fn, reps, tries):
    """`tries` torch.profiler traces of `reps` calls of fn (device
    activity only, as chip_smoke.py's device_ms once took them):
    by kernel name, its events' count, total, least and largest duration
    (ms), and what key_averages() summed."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type.name != 'CUDA':
                continue
            d = by.setdefault(e.name[:40], [0, 0.0, None, 0.0])
            us = e.time_range.elapsed_us()
            d[0] += 1
            d[1] += us / 1e3
            d[2] = us / 1e3 if d[2] is None else min(d[2], us / 1e3)
            d[3] = max(d[3], us / 1e3)
        ka = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        out.append(dict(
            events=by, key_averages_ms=sum(
                e.self_device_time_total for e in ka) / 1e3 / reps,
            key_averages_counts={e.key[:40]: e.count for e in ka}))
    return out


def k6_point(torch, cuda, ag, cs, libs, b, r_rows, q_rows, kb, at, reps):
    C = ag.SEEDS_PER_BLOCK
    kw = dict(Lq=kb, Lr=kb, C=C)
    want = ag.votes_elect_v2_plain(b, r_rows, q_rows, want_votes=True, **kw)
    for name, lib in libs.items():
        if name == 'built' or name.startswith('base:'):
            got = with_lib(cuda, lib, lambda: ag._votes_elect_v2(
                b, r_rows, q_rows, want_votes=True, **kw))
            same(got, want, f'K6 ({name}) at {at}')
    del got, want

    def run():
        return ag._votes_elect_v2(b, r_rows, q_rows, **kw)

    R, K = q_rows.shape
    rr = r_rows.long()
    sv2 = torch.cat([b['sv_f'][rr], b['sv_r'][rr]]).contiguous()
    vals = b['qsv'][q_rows.long()].reshape(R, -1)
    vals2 = torch.cat([vals, vals]).contiguous()
    out = dict(kernel='K6', at=at, C=C, pack_bits=b['pack_bits'],
               eq_plain=True, ms=cs.time_ms(run, reps),
               **cs.device_ms_item(run, reps),
               votes_output_device_ms=cs.device_ms(
                   lambda: ag._votes_elect_v2(b, r_rows, q_rows,
                                              want_votes=True, **kw),
                   reps)[0],
               searchsorted_ms=cs.time_ms(
                   lambda: torch.searchsorted(sv2, vals2, right=True), reps))
    del sv2, vals, vals2
    for name, lib in libs.items():
        if name.startswith(('k6', 'base:')) or name == 'built':
            out[name] = with_lib(cuda, lib,
                                 lambda: cs.device_ms(run, reps)[0])
    print(json.dumps(out), flush=True)


def k7_point(torch, cuda, ag, cs, libs, b, r_rows, rlens, q_rows, qlens, kb,
             at, reps):
    C = ag.SEEDS_PER_BLOCK
    A, S, D = ag._votes_elect_v2(b, r_rows, q_rows, Lq=kb, Lr=kb, C=C)[:3]
    args = (b, r_rows, rlens, q_rows, qlens, A, S, D)
    want = ag.propagate_v2_plain(*args, Lr=kb)
    for name, lib in libs.items():
        if name == 'built' or name.startswith('base:'):
            got = with_lib(cuda, lib, lambda: ag._propagate_v2(*args, Lr=kb))
            same(got, want, f'K7 ({name}) at {at}')
    del got, want

    def run():
        return ag._propagate_v2(*args, Lr=kb)

    nbytes, slots = cs.k7_least(torch, b, r_rows, q_rows, kb)
    bound = max(nbytes / cs.HBM_BYTES_PER_S, slots / cs.INT32_SLOTS_PER_S) \
        * 1e3
    out = dict(kernel='K7', at=at, eq_plain=True, ext_iters=ag.EXT_ITERS,
               ms=cs.time_ms(run, reps), **cs.device_ms_item(run, reps),
               bound_ms=bound, bytes=nbytes,
               **k7_tasks(torch, A, S, D, ag.EXT_ITERS))
    if out['device_ms']:
        out['share_of_bound'] = bound / out['device_ms']
    for name, lib in libs.items():
        if name.startswith(('k7', 'base:')) or name == 'built':
            out[name] = with_lib(cuda, lib,
                                 lambda: cs.device_ms(run, reps)[0])
    print(json.dumps(out), flush=True)
    return run


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--kernels', default='k6,k7',
                    help='the kernels to probe, of k6 and k7')
    ap.add_argument('--baseline', action='append', default=[],
                    help='another align_v2.cu, held and timed beside')
    ap.add_argument('--trace-check', type=int, default=0,
                    help='profiler traces a kernel and point to print')
    args = ap.parse_args()
    kernels = set(args.kernels.split(','))
    import torch
    if not torch.cuda.is_available():
        sys.exit('k6_probe.py needs a CUDA card')
    import chip_smoke as cs
    from vclust_tpu_torch.ops import align_gpu as ag
    from vclust_tpu_torch.ops import cuda
    dev = torch.device('cuda')
    secs = cuda.build(('align_v2',))
    libs, logs = build_cuts(cuda, kernels, args.baseline)
    # The probed kernels' register and spill lines of each build.
    names = [n for k, n in (('k6', 'front_kernel'),
                            ('k7', 'propagate_v2_kernel')) if k in kernels]
    print(json.dumps(dict(build_s=secs, ptxas={
        lib: {k: v for k, v in cs.ptxas_summary(log).items()
              if any(n in k for n in names)}
        for lib, log in dict(built=cuda.build_log.get('align_v2', ''),
                             **logs).items()})), flush=True)
    libs = dict(built=cuda.library('align_v2', cuda.ALIGN_V2_SIGNATURES),
                **libs)
    for corpus, kb in ((cs.mutant_corpus(), 65536),
                       (cs.v2_corpus(), 262144)):
        b, r_rows, rlens, q_rows, qlens, at = v2_dispatch(
            torch, dev, ag, cs, corpus, kb, args.seed)
        if 'k6' in kernels:
            k6_point(torch, cuda, ag, cs, libs, b, r_rows, q_rows, kb, at,
                     args.reps)
        if 'k7' in kernels:
            run7 = k7_point(torch, cuda, ag, cs, libs, b, r_rows, rlens,
                            q_rows, qlens, kb, at, args.reps)
        if args.trace_check:
            kw = dict(Lq=kb, Lr=kb, C=ag.SEEDS_PER_BLOCK)
            fns = dict(
                K6=lambda: ag._votes_elect_v2(b, r_rows, q_rows, **kw),
                K6_votes=lambda: ag._votes_elect_v2(
                    b, r_rows, q_rows, want_votes=True, **kw))
            if 'k7' in kernels:
                fns['K7'] = run7
            for name, fn in fns.items():
                print(json.dumps(dict(
                    check='profiler', kernel=name, at=at, reps=5,
                    ms=cs.time_ms(fn, 5), **cs.device_ms_item(fn, 5),
                    traces=trace_check(torch, fn, 5, args.trace_check))),
                    flush=True)
        del b
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == '__main__':
    main()
