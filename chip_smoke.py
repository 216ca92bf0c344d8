#!/usr/bin/env python3
"""GPU smoke run of the torch port (vclust_tpu_torch) on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py [--seed N]`.

Phases, each printing one JSON line; any failure exits non-zero:
  1. build  - nvcc builds every kernel of csrc/ (one process per source,
              all at once) and the build seconds are printed;
  2. kx     - the extension kernel through its entry point `batched_extend`
              on ~65,536 jobs over related example genomes plus edge cases
              (sequence ends, an N run, an identical run longer than one
              span, one longer than the 262,144-base cap); kernel == plain
              bit for bit, and both == ops/lz_parse_py._extend on a sample;
  3. k1     - the occupancy-count kernel on (a) the replicated example
              corpus (1,536 genomes), (b) a weighted corpus with weights
              above 255, (c) a synthetic index of 16,384 genomes from
              --seed; kernel == host count on (a) and (b), == plain on all.
              Each K1 line gives the limb products issued (one per k-block
              and limb of its class) against the index-wide limb count on
              every k-block, the split-K factor, and the kernel's own
              device time (`device_ms`: CUDA events, the calls queued
              behind a spin kernel) beside its event time; (c) also
              times one launch a chunk (`ms_per_chunk`) against one a
              pass of chunks (`ms`: counts added once);
  4. cc     - device connected components, K11 (csrc/cc.cu, wrapper
              ops/cc.py:_cc_run), through single linkage on 200,000 nodes
              (launches counted from 0, labels == host union-find); then
              K11 == cc_plain on the card == a host reference (union-find,
              or scipy's components at their least member above 200,000
              nodes) on that graph, a 200,000-node path of permuted ids (the
              plain version's rounds printed), a star on the largest id,
              isolated nodes with self loops and duplicate reversed edges,
              and at IMG/VR scale 2,000,000 nodes: (a) 1,500,000 draws of
              edges between ids < 64 apart, (b) 8,000,000 random edges,
              (b) in `cluster`'s order (unique pairs i < j, sorted), and
              beyond L2 16,000,000 nodes with 48,000,000 random pairs in
              that order; each with ms, device_ms, each launch's device
              ms (`parts`), plain_ms, bound and share;
     cluster_cli - the `cluster` CLI (single linkage, --metric tani --tani
              0.95) on a synthetic ani.tsv of 60,000 objects and 200,000
              directed rows from --seed: K11 launched once, clusters.tsv ==
              the same CLI run with VCLUST_TORCH_DEVICE=cpu (cc_plain);
  5. main   - the CLI main path on the card: prefilter on 48 genomes (K1
              must launch; fltr.txt == a host-backend run byte for byte;
              K1 on the same index == plain and == the full host count
              matrix), align --filter, cluster; then the example corpus, whose
              fltr.txt and clusters.tsv must equal example/output/; then
              the batched prefilter (`prefilter --batch-size`, the path of
              every CLI prefilter above 16,384 genomes): the CLI on the 48
              genomes at 2 and 3 batches, fltr.txt == the unbatched one,
              and run_prefilter on k1 a's 1,536 sets at 3 batches ==
              unbatched == the exact host count's, K1's launches on each;
  6. align_engine - the device align engine from the CLI: `align --engine
              gpu --out-aln` over the 66 pairs of example/multifasta.fna:
              ani.tsv, ani.ids.tsv and ani.aln.tsv == tests/golden_torch/
              engine_tpu/ (the JAX CLI's `--engine tpu`) byte for byte; then
              `--filter --filter-threshold 0.7 --engine gpu` and cluster,
              whose clusters.tsv must equal example/output/clusters.tsv.
              Prints the hard pairs re-aligned on v2, the launches, the
              seconds and dispatches in v3 and in v2, the seconds on the
              host, warm pairs/s and the tANI of the 8 truth pairs;
  7. align_v3 - the v3 align pipe (ops/align_gpu.py:_all2all_single(...,
              pipe='v3')) on bench.py's 48-genome corpus (1,128 pairs,
              buckets 49,152 and 65,536) and its contig corpus (128 x 3,500
              bases, 8,128 pairs, bucket 4,096): the arenas built by K9
              (the v3 index, csrc/index.cu; once a chunk of genomes) ==
              index_block_v3_plain on the same codes, key by key, K9
              alone on each (ms, device_ms, plain_ms, bytes bound), the
              index seconds split into the host's padding, reverse
              complements and uploads and K9's device ms; aggregates and
              records == the same function with the plain K2, K3, K5 and
              K4, bit for bit; warm pairs/s, peak device memory and a
              profiler breakdown of one warm run; the max |dtANI| against
              the native C++ engine (printed, not held); then K2 and K3
              (stages 2-4, the wide rows read in place: cnt, cnt_best, A,
              S and D) alone on one full dispatch at 65,536 and at 4,096,
              and K5 and K4 (without and with records) alone there (each
              == plain, with ms, device_ms, plain_ms, bound; library_ms for
              K2), and the time of each stage of the 65,536 dispatch, the
              row core's time and peak device bytes at this budget's B and
              at the B = 26 of the budget that held stage 2's windows;
  8. align_hybrid - the engine's default all2all_gpu (v3, then v2 on the
              hard pairs) on the 48 genomes: hard pairs, the dispatches of
              each pipe, warm pairs/s with and without the hybrid, busy
              share and top device entries under the profiler, max |dtANI|
              against the native engine; with records == the all-plain
              run; on one v2 dispatch at 65,536, K6 (K8 fused in: its
              election against the plain pair, and with its votes output
              against votes_v2_plain), K7 and K4 alone against their plain
              versions (ms, device_ms, host_ms, bound, share_of_bound;
              library_ms for K6 and K8, torch.searchsorted of the same
              seeds in the same call), each stage's time, the row core's
              with the plain kernels, and K10 (the v2 index build,
              csrc/index.cu) on the bucket's arena == index_block_plain,
              with its bytes bound and torch.sort(stable=True) of the
              same rows' keys;
  9. align_v2 - the v2 pipe alone above V3_MAX_BUCKET: 4 genomes of
              158-249 kb concatenated from example genomes plus a 5% mutant
              each (buckets 196,608 and 262,144, 64-bit packs), all 28
              pairs with records: == the all-plain run, and == the port on
              the CPU for two pairs; pairs/s, peak bytes, B, each stage's
              time on one dispatch (K6, K7 and K4 alone against plain, K10
              against plain at C = 16 and 8), and the live
              bytes a query position holds (peaks at 1 and 2 rows, C = 16
              and 8) against `_dispatch_rows_v2`'s constants;
 10. mesh   - the port's mesh paths (vclust_tpu_torch/parallel/) on the
              card, each driven with the launch counts set to 0 just before
              it and read just after (a path that launched none of its
              kernels fails): K1's work lists cut among 2 and 3 shards of
              one card on k1 (a) and (c) == K1 unsharded; the unweighted
              count (`shared_kmer_counts_device`) of (a)'s 1,536 sets == the
              host count; its row panels of 512 and 300 genomes (K1 in
              window mode) == the dense rows; K1 on the unweighted count's
              passes and K1's window mode alone at one panel of 4,096 x
              16,384 (case c's patterns) == plain, each with its ms, the
              plain ms, the bound and the time of a bf16 torch.matmul of
              the same counts; the sharded all2all_gpu (2 shards, the
              dispatches dealt to them) on the 48 genomes == the single
              device and == its all-plain run, records included, with the
              align kernels' launches and pairs/s beside the unsharded run;
              two processes on this card over gloo (`python -m
              vclust_tpu_torch.parallel.worker`) both print MULTIHOST_OK;
              `entry()` == the int product; and `dryrun_multichip` on every
              visible card, or on 2 shards of cuda:0 when one is visible;
 11. the `kernels` line: every kernel (KX, K1, K9, K10, K2, K3, K4, K5,
     K8, K6, K7, K11) with its launches on its path, error against its
     plain version, times, bound and share of it; K8 is fused into K6 (one
     launch: row k8 is its votes output, row k6 its election).
On every align path (phases 6-10) K9, K10, K2, K3, K5, K4, K6 and K7 are
counted from 0 around the run: each chunk of genomes of a v3 or v2 arena
the path builds launches K9 or K10 once, each v3 dispatch K2, K3, K5 and
K4 once, each v2 dispatch K6, K7 and K4 once, and any other count fails;
the plain versions launch none.
The card's name and power limit (nvidia-smi) precede the last line, which
is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import contextlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate and the rates the
# bounds below use. The data sheet's 67 TFLOP/s float32 rate outside the
# tensor cores counts 128 fp32 lanes per SM; an SM has 64 int32 lanes, so
# its int32 rate is half of that.
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
INT32_SIMT_OPS_PER_S = 33.5e12
# Issue slots of the int32 pipe: 64 lanes per SM x 132 SMs x 1.98 GHz, one
# instruction per lane and clock (a population count takes 4 slots: 16 per
# SM and clock).
INT32_SLOTS_PER_S = INT32_SIMT_OPS_PER_S / 2
# Issue slots a lane of the cheapest KX warp step of 32 positions (counted
# in phase_kx).
KX_SLOTS_PER_STEP = 23


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise AssertionError(msg)


def ptxas_summary(log: str) -> dict:
    """Each kernel's register and spill lines from nvcc's `-Xptxas -v`
    output, and its wgmma performance warnings (C75xx, e.g. products
    serialized for want of registers), by entry-function name."""
    out, name = {}, None
    for ln in log.splitlines():
        if 'Compiling entry function' in ln:
            name = ln.split("'")[1]
        elif '(C75' in ln and "'" in ln:
            out.setdefault(ln.split("'")[1], []).append(
                ln.split(':', 1)[-1].strip().split(' for the function')[0])
        elif name and ('Used ' in ln or 'spill' in ln):
            out.setdefault(name, []).append(ln.split(':', 1)[-1].strip())
    return out


def time_ms(fn, reps: int) -> float:
    """CUDA-event time of `fn`, the mean of `reps` calls after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Clock cycles that torch.cuda._sleep spins a millisecond at most (an H100
# SXM's SM clock peaks at 1.98 GHz; at a lower clock it spins longer).
SPIN_CYCLES_PER_MS = 1.98e6


def device_ms(fn, reps: int, tries: int = 3) -> tuple:
    """(device time of `fn`, None), or (None, the reason). The time is the
    mean of `reps` calls after a warm-up, timed by CUDA events on the stream
    while a spin kernel queued before them (torch.cuda._sleep) holds it
    busy, so that every launch of the calls is queued before the first one
    starts and the host's time between launches never enters: the stream's
    busy time, its kernels, memsets and the gaps between them on the card.
    Held only where the spin still ran when the last call was queued (the
    start event not yet reached); else taken again with a spin four times as
    long, up to `tries` times, and None where none held (fn waits on the
    device). (No torch.profiler sums: a trace can lose a kernel's events or
    their time; tools/k6_probe.py --trace-check shows them beside this.)"""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = 2 * queued_ms + 1.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(tries):
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps, None
        spin_ms *= 4
    return None, (f'not held: a spin of {spin_ms / 4:.1f} ms ended before '
                  f'{reps} calls were queued (the calls wait on the device)')


def device_ms_item(fn, reps: int) -> dict:
    """{'device_ms': device_ms(fn, reps)'s time}, with 'device_ms_why', its
    reason, where the time is None."""
    ms, why = device_ms(fn, reps)
    return dict(device_ms=ms) if ms is not None else dict(
        device_ms=None, device_ms_why=why)


def with_shares(d: dict) -> dict:
    """d (with ms, device_ms and bound_ms) with the share of the bound the
    device time reaches and the wrapper's host time, ms - device_ms."""
    if d.get('device_ms'):
        d['share_of_bound'] = d['bound_ms'] / d['device_ms']
        d['host_ms'] = d['ms'] - d['device_ms']
    return d


# --------------------------------------------------------------------------
# Phase 2: KX
# --------------------------------------------------------------------------

RELATED = [('NC_010807', 'NC_010807.alt1'), ('NC_010807', 'NC_010807.alt2'),
           ('NC_010807', 'NC_010807.alt3'), ('NC_005091', 'NC_005091.alt1'),
           ('NC_005091', 'NC_005091.alt2'), ('NC_025457', 'NC_025457.alt1'),
           ('NC_025457', 'NC_025457.alt2'), ('NC_002486', 'NC_002486.alt')]
IDENT_LEN = 300_000
N_RUN_AT = 150_000
ORACLE_JOBS = 4000   # random jobs also checked against the host oracle


def kx_jobs(rng, n_jobs: int = 65536):
    """(q, r, qi, ri, edge): q and r concatenate related genome pairs of
    example/fna (joined by N runs) and end with one shared 300,000-base
    segment (with a 7-base N run in q's copy); jobs start at shared 16-mer
    seeds of the pairs, at random offsets, and at the edge cases."""
    import numpy as np
    from vclust_tpu_torch.core.kmers import _window_values
    from vclust_tpu_torch.core.seq import encode
    from vclust_tpu_torch.io.fasta import read_fasta
    from vclust_tpu_torch.utils.data import example_dir
    fna = example_dir() / 'fna'

    def codes(name):
        return np.concatenate([encode(r.seq)
                               for r in read_fasta(fna / f'{name}.fna')])

    gap = np.full(64, 4, np.int8)
    q_parts, r_parts, seeds = [], [], []
    qo = ro = 0
    for a, b in RELATED:
        ca, cb = codes(a), codes(b)
        va = _window_values(np.where(ca < 4, ca, 0), 16)
        vb = _window_values(np.where(cb < 4, cb, 0), 16)
        ub, first_b = np.unique(vb, return_index=True)
        hit = np.isin(va, ub)
        pa = np.flatnonzero(hit)
        pb = first_b[np.searchsorted(ub, va[pa])]
        seeds.append(np.stack([pa + qo, pb + ro], axis=1))
        q_parts += [ca, gap]
        r_parts += [cb, gap]
        qo += len(ca) + len(gap)
        ro += len(cb) + len(gap)
    ident = rng.integers(0, 4, IDENT_LEN).astype(np.int8)
    q_ident = ident.copy()
    q_ident[N_RUN_AT:N_RUN_AT + 7] = 4
    q = np.concatenate(q_parts + [q_ident])
    r = np.concatenate(r_parts + [ident])
    qs, rs = qo, ro                       # start of the shared segment
    nq, nr = len(q), len(r)
    edge = np.array([
        [qs, rs],                                   # hits the cap
        [qs + IDENT_LEN - 2500, rs + IDENT_LEN - 2500],  # > 1 span, to end
        [qs + N_RUN_AT - 500, rs + N_RUN_AT - 500],     # across the N run
        [nq - 10, nr - 10], [nq - 1, rs], [qs, nr - 1], [0, 0],
        [nq, 0], [0, nr],                           # empty extensions
    ], dtype=np.int64)
    seeds = np.concatenate(seeds)
    n_seeded = (n_jobs - len(edge)) * 3 // 4
    pick = rng.choice(len(seeds), n_seeded, replace=len(seeds) < n_seeded)
    n_rand = n_jobs - len(edge) - n_seeded
    rand = np.stack([rng.integers(0, qs, n_rand),
                     rng.integers(0, rs, n_rand)], axis=1)
    jobs = np.concatenate([edge, seeds[pick], rand]).astype(np.int32)
    return q, r, jobs[:, 0].copy(), jobs[:, 1].copy(), len(edge)


def union_len(starts, lens) -> int:
    """Positions covered by the intervals [start, start + len)."""
    import numpy as np
    keep = lens > 0
    s, e = starts[keep], starts[keep] + lens[keep]
    if not len(s):
        return 0
    order = np.argsort(s)
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    grp = np.cumsum(new) - 1
    lo = s[new]
    hi = np.zeros(len(lo), np.int64)
    np.maximum.at(hi, grp, e)
    return int((hi - lo).sum())


def kx_evaluated(kx, sc, lim) -> int:
    """Positions KX compares, at most, for jobs that need `sc` positions
    within limits `lim` (the ranges of ops/extend.py:kernel_ranges): whole
    steps of 32 up to each range's first violation, one look-back step a
    range of launch B, and every range of a job's last round (a range
    after the one that stops the job may stop early at its own
    violation)."""
    import numpy as np

    def steps(n):
        return (n + 31) // 32 * 32

    total = int(steps(np.minimum(sc, kx.FIRST)).sum())
    for need, limit in zip(sc[sc > kx.FIRST].tolist(),
                           lim[sc > kx.FIRST].tolist()):
        for rd in kx.kernel_ranges(limit)[1:]:
            total += sum(steps(min(e, need) if s < need else e) - s + 32
                         for s, e in rd)
            if rd[-1][1] >= need:
                break
    return total


def phase_kx(torch, dev, rng):
    import numpy as np
    from vclust_tpu_torch.ops import cuda
    from vclust_tpu_torch.ops import extend as kx
    from vclust_tpu_torch.ops.lz_parse_py import AlignParams, _extend
    p = AlignParams()
    q, r, qi, ri, n_edge = kx_jobs(rng)
    nq, nr = len(q), len(r)
    q2d, r2d = kx.pad_codes(q), kx.pad_codes(r)

    # The path: the library entry point, counted from 0.
    kx.extend.launches = 0
    lens, matches = kx.batched_extend(q2d, r2d, qi, ri, nq, nr,
                                      p.aw, p.am, p.ar, device=dev)
    launches = kx.extend.launches

    # Kernel against plain, on the same device tensors.
    args = [torch.from_numpy(np.ascontiguousarray(a, np.int32).reshape(-1)
                             ).to(dev) for a in (q2d, r2d, qi, ri)]
    k_len, k_match = kx.extend(*args, nq, nr, p.aw, p.am, p.ar)
    pl_len, pl_match, scanned = kx.extend_plain(
        *args, nq, nr, p.aw, p.am, p.ar, return_scanned=True)
    torch.cuda.synchronize()
    err = max(int((k_len - pl_len).abs().max()),
              int((k_match - pl_match).abs().max()))
    if err or not (np.array_equal(lens, pl_len.cpu().numpy())
                   and np.array_equal(matches, pl_match.cpu().numpy())):
        fail(f'KX kernel != plain (max abs err {err})')
    cap = kx.CAP
    if (int(lens[0]), int(matches[0])) != (cap, cap - 7):
        fail(f'KX cap job gave {(int(lens[0]), int(matches[0]))}')

    # Both against the host oracle on a sample (the cap job excluded: the
    # oracle has no cap).
    sample = np.concatenate([np.arange(1, n_edge), rng.choice(
        np.arange(n_edge, len(qi)), ORACLE_JOBS, replace=False)])
    t0 = time.perf_counter()
    for k in sample:
        exp = _extend(q, r, int(qi[k]), int(ri[k]), 0, p)
        if (int(lens[k]), int(matches[k])) != exp:
            fail(f'KX job {k} ({qi[k]}, {ri[k]}): kernel '
                 f'{(int(lens[k]), int(matches[k]))} != oracle {exp}')
    oracle_s = time.perf_counter() - t0

    ms = time_ms(lambda: kx.extend(*args, nq, nr, p.aw, p.am, p.ar), 5)
    # Without the two long edge jobs (the cap job, 0, and the one across
    # the N run, 2): the throughput apart from the serial chain.
    keep = torch.ones(len(qi), dtype=torch.bool, device=dev)
    keep[[0, 2]] = False
    short = args[:2] + [args[2][keep], args[3][keep]]
    ms_short = time_ms(lambda: kx.extend(*short, nq, nr, p.aw, p.am, p.ar),
                       5)
    plain_ms = time_ms(
        lambda: kx.extend_plain(*args, nq, nr, p.aw, p.am, p.ar), 1)
    sc = scanned.cpu().numpy()
    lim = np.minimum(np.minimum(nq - qi.astype(np.int64),
                                nr - ri.astype(np.int64)), cap)
    # Least work. Bytes: the distinct code bytes the jobs read (int32
    # codes, each input read once; 5.4 MB, which then stay in the 50 MB
    # L2) plus the job arrays and outputs. Operations: int32 issue slots,
    # one a lane and instruction of the cheapest warp step of 32 positions,
    # times the steps the jobs need (ceil(scanned / 32) a job):
    #   2  compare the codes (equal, and below 4)
    #   1  ballot of the matches M
    #   1  funnel shift of (previous M, M): each lane's last 32 positions
    #   6  matches in its window of aw: LOP3, population count (4 slots),
    #      compare with aw - am
    #   1  ballot of the violations V
    #   2  run of ar matches ending at the lane: LOP3, compare
    #   1  ballot of the run ends R
    #   2  run ends before the first violation: R & (V - 1) & ~V
    #   5  keep the last step holding one: test, 4 selects (its base,
    #      candidates, M and the lane's match count before it)
    #   1  the lane's match count: add
    #   1  stop test (V != 0)
    # 23 slots (the cut is taken from the kept step once a range). The 8
    # bytes a position the jobs read (L2 traffic: the windows of the jobs
    # overlap) have no rate in the data sheet, so they form no bound and
    # are printed beside it (`l2_bytes`).
    nbytes = 4 * (union_len(qi.astype(np.int64), sc)
                  + union_len(ri.astype(np.int64), sc)) + 16 * len(qi)
    warp_steps = int(((sc + 31) // 32).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = KX_SLOTS_PER_STEP * 32.0 * warp_steps / INT32_SLOTS_PER_S * 1e3
    by_len = np.sort(sc)
    row = dict(
        name='extend', route='cuda', source='vclust_tpu_torch/csrc/extend.cu',
        replaces='vclust_tpu/ops/extend_pallas.py:68',
        launches=launches, max_abs_err=err, ms=ms,
        **device_ms_item(
            lambda: kx.extend(*args, nq, nr, p.aw, p.am, p.ar), 5),
        plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by='bytes' if t_bytes >= t_ops else 'operations',
        library_ms=None)
    emit(dict(phase='kx', jobs=int(len(qi)), nq=nq, nr=nr,
              bases_scanned=int(sc.sum()), l2_bytes=8 * int(sc.sum()),
              warp_steps=warp_steps, longest=int(by_len[-1]),
              second_longest=int(by_len[-2]),
              scanned_p50_p90_p999=np.percentile(
                  sc, [50, 90, 99.9]).tolist(),
              cap_job=[cap, cap - 7],
              kernel_eq_plain=True, oracle_jobs=int(len(sample)),
              oracle_eq=True, oracle_seconds=oracle_s, path_launches=launches,
              ms=ms, ms_without_long=ms_short, plain_ms=plain_ms,
              bound_ms=row['bound_ms'],
              positions_evaluated_at_most=kx_evaluated(kx, sc, lim),
              positions_needed=int(sc.sum()),
              registers=ptxas_summary(cuda.build_log.get('extend', '')),
              bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
              int32_slots=KX_SLOTS_PER_STEP * 32 * warp_steps))
    return row


# --------------------------------------------------------------------------
# Phase 3: K1
# --------------------------------------------------------------------------

def bench_sets():
    """bench.py:187-199: the example k-mer sets replicated 128 times with
    offsets (1,536 genomes)."""
    import numpy as np
    from vclust_tpu_torch.models.input import load_genomes
    from vclust_tpu_torch.models.prefilter import genome_kmer_set
    from vclust_tpu_torch.utils.data import example_path
    genomes, _ = load_genomes(example_path('multifasta.fna'))
    base = [genome_kmer_set(g, 25, 1.0) for g in genomes]
    sets = []
    for rep in range(128):
        off = np.uint64(rep * 1_000_003)
        sets += [(s + off) if rep else s for s in base]
    return sets


def weighted_sets():
    """bench.py:124-134: 6 genomes with dense sharing, weights above 255."""
    import numpy as np
    rng = np.random.default_rng(7)
    universe = np.unique(rng.integers(0, 2 ** 50, 20000).astype(np.uint64))
    return [np.sort(np.unique(rng.choice(universe, 16000)))
            for _ in range(6)]


def synthetic_index(seed: int, n: int = 16384, n_patterns: int = 65536):
    """A random pattern index: n genomes, patterns of 2-256 distinct
    genomes, weights 1-70,000."""
    import numpy as np
    from vclust_tpu_torch.ops.prefilter import index_from_numpy
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 257, n_patterns).astype(np.int32)
    gids = np.concatenate([np.sort(rng.choice(n, ln, replace=False))
                           for ln in lens]).astype(np.int32)
    weights = rng.integers(1, 70001, n_patterns).astype(np.int64)
    occ_w = np.bincount(gids, weights=np.repeat(weights, lens), minlength=n)
    sizes = occ_w.astype(np.int64) + rng.integers(0, 1000, n)
    return index_from_numpy(n, sizes, gids, lens, weights)


def k1_case(torch, dev, name, index, host=None, per_chunk=False):
    import numpy as np
    from vclust_tpu_torch.ops import prefilter as pf
    n = index.n
    n_limbs, passes = pf.device_chunks(index, dev)
    counts = torch.zeros((n, n), dtype=torch.int32, device=dev)

    def run_kernel(passes=passes, counts=counts):
        counts.zero_()
        for c in passes:
            pf.occupancy_count(counts, c)

    def run_plain():
        out = torch.zeros((n, n), dtype=torch.int32, device=dev)
        for c in passes:
            pf.occupancy_count_plain(out, c.gids, c.offs, c.weights)
        return out

    run_kernel()
    plain = run_plain()
    torch.cuda.synchronize()
    err = int((counts.long() - plain.long()).abs().max()) if n else 0
    if err:
        fail(f'K1 {name}: kernel != plain (max abs err {err})')
    got = counts.cpu().numpy().astype(np.int64)
    np.fill_diagonal(got, index.sizes)
    del plain
    # Limb products the kernel issues (one per k-block and limb of its
    # class) against the index-wide limb count on every k-block.
    n_kblocks = sum(int(c.kb_limbs.numel()) for c in passes)
    splits = sorted({c.split for c in passes})
    res = dict(case=name, n=n, patterns=int(len(index.lens)),
               nnz=int(len(index.gids)),
               chunks=sum(len(c.parts) for c in passes), passes=len(passes),
               n_limbs=n_limbs, k_blocks=n_kblocks,
               limb_products=sum(int(c.kb_limbs.sum()) for c in passes),
               limb_products_without_classes=n_limbs * n_kblocks,
               split=splits[0] if len(splits) == 1 else splits,
               tiles=int(len(pf.k1_tiles(n))),
               tiles_full_square=(-(-n // pf.K1_TILE)) ** 2,
               max_abs_err=err)
    if host is not None:
        ok = host(got)
        res['host_eq'] = ok
        if not ok:
            fail(f'K1 {name}: kernel != host count')
    reps = 2 if n >= 4096 else 20
    ms = time_ms(run_kernel, reps)
    if per_chunk:
        # What adding counts once a pass saves: one launch a chunk, as
        # with passes of one chunk each (== the result above).
        pass_bytes, pf._K1_PASS_BYTES = pf._K1_PASS_BYTES, 0
        try:
            each = pf.device_chunks(index, dev)[1]
        finally:
            pf._K1_PASS_BYTES = pass_bytes
        apart = torch.zeros_like(counts)
        run_kernel(each, apart)
        if not torch.equal(apart, counts):
            fail(f'K1 {name}: one launch a chunk != passes')
        res['ms_per_chunk'] = time_ms(lambda: run_kernel(each, apart), reps)
        del apart, each
    # The kernel's own device time (counts are not zeroed in between: the
    # sums above are already checked).
    res.update(device_ms_item(
        lambda: [pf.occupancy_count(counts, c) for c in passes], reps))
    plain_ms = time_ms(run_plain, 1)
    pairs = n * (n - 1) / 2
    rows = sum(int(c.weights.numel()) for c in passes)
    nbytes = 4 * (len(index.gids) + rows + len(passes) + rows) + 8 * n * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * k1_least_products(rows, n, n) / INT8_TENSOR_OPS_PER_S * 1e3
    res.update(ms=ms, pairs_per_s=pairs / (ms / 1e3), plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by='bytes' if t_bytes >= t_ops else 'operations',
               library_ms=k1_library_ms(torch, dev, n, passes, n_limbs,
                                        reps))
    return res


def k1_library_ms(torch, dev, n, passes, n_limbs, reps, window=None):
    """Yardstick only, never called by the port: torch.matmul on the bf16
    occupancy, one product per pass and weight byte (of the window's
    (row0, rows) genome rows against all n, else all n against all n),
    with the reduced-precision bf16 reduction switched off, each timed
    over `reps` calls as the kernel is. Operand building is not timed."""
    row0, rows = window or (0, n)
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    total = 0.0
    try:
        for c in passes:
            ng = c.weights.numel()
            pat = torch.repeat_interleave(
                torch.arange(ng, device=dev), (c.offs[1:] - c.offs[:-1]).long())
            occ = torch.zeros((ng, n), dtype=torch.bfloat16, device=dev)
            occ[pat, c.gids.long()] = 1
            occ_t = occ.T[row0:row0 + rows]
            ops = [(occ * ((c.weights >> (8 * l)) & 255).to(
                torch.bfloat16)[:, None]) for l in range(n_limbs)]
            for b in ops:
                total += time_ms(lambda: torch.matmul(occ_t, b), reps)
            del occ, ops
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            prev
    return total


def k1_least_products(patterns: int, n: int, rows: int) -> float:
    """The u8 products of the least work for a rows x n block of counts
    whose rows are genomes of the n columns: the counts are symmetric, so
    the block's rows x rows square on the diagonal holds rows (rows - 1) / 2
    entries twice; n (n + 1) / 2 entries for the whole square."""
    return float(patterns) * (rows * n - rows * (rows - 1) / 2)


def phase_k1(torch, dev, seed: int):
    import numpy as np
    from vclust_tpu_torch.ops import prefilter as pf
    rng = np.random.default_rng(seed)

    sets = bench_sets()
    idx_a = pf.PrefilterIndex(sets)
    n = len(sets)
    sample = np.concatenate([
        np.stack(np.triu_indices(24, 1), axis=1),
        rng.integers(0, n, (3000, 2))])

    def host_a(got):
        # The host count from the index, exact for every pair, and the
        # sort-merge intersection on a sample of pairs.
        if not np.array_equal(got, pf._counts_from_index_host(idx_a)):
            return False
        return all(got[i, j] == len(np.intersect1d(
            sets[i], sets[j], assume_unique=True)) if i != j
            else got[i, i] == len(sets[i]) for i, j in sample)

    w_sets = weighted_sets()
    idx_b = pf.PrefilterIndex(w_sets)
    if idx_b.weights.max() <= 255:
        fail('weighted corpus must exceed one byte limb')

    def host_b(got):
        return np.array_equal(got, pf.shared_kmer_counts_host(w_sets))

    a = k1_case(torch, dev, 'a_bench_1536', idx_a, host_a)
    emit(dict(phase='k1', **a))
    b = k1_case(torch, dev, 'b_weighted', idx_b, host_b)
    emit(dict(phase='k1', **b))
    idx_c = synthetic_index(seed)
    c = k1_case(torch, dev, 'c_synthetic_16384', idx_c, per_chunk=True)
    emit(dict(phase='k1', **c))
    return (c, max(a['max_abs_err'], b['max_abs_err'], c['max_abs_err']),
            (sets, idx_a, idx_c))


# --------------------------------------------------------------------------
# Phase 4: device connected components (K11) and the cluster CLI on them
# --------------------------------------------------------------------------

CC_NODES = 200_000
CC_EDGE_DRAWS = 150_000
# IMG/VR scale (SURVEY.md:541): 2,000,000 nodes, (a) the recipe above x 10,
# (b) 8,000,000 random edges (one giant component plus stragglers).
CC_BIG_NODES = 2_000_000
CC_BIG_DRAWS = 1_500_000
CC_BIG_RANDOM_EDGES = 8_000_000
# Beyond L2: 16,000,000 nodes (`parent` 64 MB, above the 50 MB L2) and
# 48,000,000 random pairs, in the form `cluster` passes them.
CC_HUGE_NODES = 16_000_000
CC_HUGE_PAIRS = 48_000_000
# The plain version's rounds each read a flag on the host: a call slower
# than this is timed once, by its check.
CC_PLAIN_ONCE_MS = 1000.0


def union_find(n: int, edges):
    """Host union-find labels: the smallest member id of each component."""
    import numpy as np
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges.tolist():
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return np.array([find(i) for i in range(n)])


def least_member_labels(n: int, edges):
    """scipy's connected components, each mapped to its least member id:
    the host reference above 200,000 nodes."""
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    m = coo_matrix((np.ones(len(edges), np.int8), (edges[:, 0], edges[:, 1])),
                   shape=(n, n))
    _, comp = connected_components(m, directed=False)
    least = np.full(comp.max() + 1, n, dtype=np.int64)
    np.minimum.at(least, comp, np.arange(n))
    return least[comp]


def near_id_edges(rng, n: int, draws: int):
    """Unique edges between ids less than 64 apart (many small
    components)."""
    import numpy as np
    a = rng.integers(0, n, draws)
    b = a + rng.integers(1, 64, len(a))
    return np.unique(np.stack([a, b], axis=1)[b < n], axis=0)


def build_edges_order(n: int, edges):
    """`edges` as `cluster`'s build_edges passes them to K11
    (models/cluster.py): self loops dropped, each pair (i, j) with i < j,
    unique, sorted. The keys i * n + j are sorted and equal neighbours
    dropped: np.unique's result, where numpy 2.3.5's np.unique took 91.6 s
    on 48,000,000 keys against 0.79 s for np.sort (on an H100 host)."""
    import numpy as np
    lo = np.minimum(edges[:, 0], edges[:, 1]).astype(np.int64)
    hi = np.maximum(edges[:, 0], edges[:, 1]).astype(np.int64)
    key = np.sort((lo * n + hi)[lo != hi])
    key = key[np.concatenate([key[:1] == key[:1], key[1:] != key[:-1]])]
    return np.stack([key // n, key % n], axis=1)


def cc_graphs(rng, recipe):
    """(name, n, edges) of phase cc beyond the recipe graph: the shapes
    that are hard for propagation or for the atomics, two graphs at IMG/VR
    scale, (b) again in `cluster`'s order, and one beyond L2 in that
    order."""
    import numpy as np
    n = CC_NODES
    perm = rng.permutation(n)
    live = rng.choice(n, n // 2, replace=False)
    pairs = live[rng.integers(0, len(live), (n // 4, 2))]
    loops = rng.choice(n, n // 8, replace=False)
    mixed = np.concatenate([pairs, pairs[:, ::-1],
                            np.stack([loops, loops], axis=1)])
    mixed = mixed[rng.permutation(len(mixed))]
    a = near_id_edges(rng, CC_BIG_NODES, CC_BIG_DRAWS)
    b = rng.integers(0, CC_BIG_NODES, (CC_BIG_RANDOM_EDGES, 2))
    return [
        ('recipe_200k', n, recipe),
        ('path_permuted_200k', n, np.stack([perm[:-1], perm[1:]], axis=1)),
        ('star_on_largest_200k', n, np.stack(
            [np.full(n - 1, n - 1), np.arange(n - 1)], axis=1)),
        ('isolated_loops_duplicates_200k', n, mixed),
        ('a_recipe_2m', CC_BIG_NODES, a),
        ('b_random_2m', CC_BIG_NODES, b),
        ('b_sorted_2m', CC_BIG_NODES, build_edges_order(CC_BIG_NODES, b)),
        ('c_beyond_l2_16m', CC_HUGE_NODES, build_edges_order(
            CC_HUGE_NODES, rng.integers(0, CC_HUGE_NODES,
                                        (CC_HUGE_PAIRS, 2)))),
    ]


def k11_parts(torch, run) -> dict:
    """{launch: device ms} of one K11 call (`run`) by torch.profiler, after
    a warm-up call: cc_init, cc_hook<0> (every block) or cc_hook<1> (the
    sample), cc_compress and cc_hook<2> (the other blocks), cc_flatten (an
    earlier csrc/cc.cu's or a variant's kernels by their own names). A
    trace can lose a kernel's events: taken again, up to three times,
    where it lacks the init or the flatten."""
    import re
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                run()
                torch.cuda.synchronize()
                prof.step()
        parts = {}
        for e in prof.key_averages():
            m = re.search(r'cc_\w+(<\d+>)?', e.key)
            if m and e.self_device_time_total > 0:
                parts[m.group(0)] = (parts.get(m.group(0), 0.0)
                                     + e.self_device_time_total / 1e3)
        if ('cc_init' in parts and 'cc_flatten' in parts) \
                or 'cc_persistent' in parts:
            break
    return parts


def cc_case(torch, dev, name: str, n: int, edges) -> dict:
    """K11 (ops/cc.py:_cc_run on the card) == cc_plain on the card == the
    host reference on one graph; K11's ms, device ms and each launch's
    device ms, the plain version's ms and rounds, and the bytes bound: the
    int32 edges read once, the int32 labels written once."""
    import numpy as np
    from vclust_tpu_torch.ops import cc
    t_case = time.perf_counter()
    e = torch.from_numpy(np.ascontiguousarray(edges, np.int32)).to(dev)
    e64 = e.long()
    got = cc._cc_run(e, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = cc.cc_plain(e64, n)
    torch.cuda.synchronize()
    plain_once_ms = (time.perf_counter() - t0) * 1e3
    rounds = cc.cc_plain.rounds
    t0 = time.perf_counter()
    want = (union_find(n, edges) if n <= CC_NODES
            else least_member_labels(n, edges))
    ref_s = time.perf_counter() - t0
    k, p = got.cpu().numpy().astype(np.int64), plain.cpu().numpy()
    err = int(np.abs(k - p).max())
    if got.dtype != torch.int32 or err or not np.array_equal(k, want) \
            or not np.array_equal(p, want):
        fail(f'cc {name}: K11, cc_plain and the host reference differ '
             f'(K11 - plain max abs err {err})')
    del plain

    def run():
        cc._cc_run(e, n, trusted=True)

    plain_ms = (plain_once_ms if plain_once_ms > CC_PLAIN_ONCE_MS
                else time_ms(lambda: cc.cc_plain(e64, n), 3))
    sizes = np.bincount(want, minlength=n)
    return with_shares(dict(
        graph=name, nodes=n, edges=int(len(edges)),
        components=int((sizes > 0).sum()), largest_component=int(sizes.max()),
        max_abs_err=err, ms=time_ms(run, 10), **device_ms_item(run, 10),
        parts=k11_parts(torch, run), plain_ms=plain_ms, plain_rounds=rounds,
        bound_ms=(4 * e.numel() + 4 * n) / HBM_BYTES_PER_S * 1e3,
        bound_by='bytes', library_ms=None,
        reference='union_find' if n <= CC_NODES else 'scipy',
        reference_s=ref_s, seconds=time.perf_counter() - t_case))


def phase_cc(torch, dev, seed: int):
    """K11 on the path single linkage takes from 50,000 objects up
    (models/cluster.py:40, `_single`): 200,000 nodes, ~150,000 edges
    between ids less than 64 apart, launches counted, labels == the host
    union-find's; then K11 == cc_plain == a host reference on that graph,
    a permuted path, a star, isolated nodes with self loops and duplicate
    reversed edges, two graphs of 2,000,000 nodes, the random one again in
    `cluster`'s order, and 16,000,000 nodes in that order."""
    import numpy as np
    from vclust_tpu_torch.models import cluster as mc
    from vclust_tpu_torch.ops import cc
    rng = np.random.default_rng(seed)
    n = CC_NODES
    edges = near_id_edges(rng, n, CC_EDGE_DRAWS)
    if n < mc._DEVICE_SINGLE_MIN_NODES:
        fail('the cc graph is below the device path\'s size')
    cc._cc_run.launches = 0
    t0 = time.perf_counter()
    labels = np.asarray(mc._single(n, edges, None, None, mc.ClusterParams(),
                                   dev))
    path_s = time.perf_counter() - t0
    launches = cc._cc_run.launches
    if launches != 1:
        fail(f'single linkage on {n} nodes launched K11 {launches} times')
    if not np.array_equal(labels, union_find(n, edges)):
        fail('device connected components != host union-find')
    cases = []
    t0 = time.perf_counter()
    graphs = cc_graphs(rng, edges)
    graphs_s = time.perf_counter() - t0
    for name, gn, ge in graphs:
        cases.append(cc_case(torch, dev, name, gn, ge))
        emit(dict(phase='cc', **cases[-1]))
    del graphs
    torch.cuda.empty_cache()
    res = dict(phase='cc', path='models/cluster.py:_single', nodes=n,
               edges=int(len(edges)), path_s=path_s, path_launches=launches,
               labels_eq_union_find=True,
               graphs_eq_plain_and_reference=[c['graph'] for c in cases],
               graphs_s=graphs_s,
               # b_sorted_2m and c_beyond_l2_16m: their cases, and the
               # making of every graph (most of it theirs).
               added_s=graphs_s + sum(c['seconds'] for c in cases if c[
                   'graph'] in ('b_sorted_2m', 'c_beyond_l2_16m')))
    emit(res)
    return res, cases


CLI_OBJECTS = 60_000
CLI_ROWS = 200_000
CLI_HEADER = ('qidx', 'ridx', 'query', 'reference', 'tani', 'gani', 'ani',
              'qcov', 'rcov', 'num_alns', 'len_ratio')


def cluster_inputs(work: pathlib.Path, seed: int):
    """A synthetic ani.tsv and ani.ids.tsv from `seed`: CLI_OBJECTS objects,
    length-descending, and CLI_ROWS directed rows between objects less than
    64 apart, tANI uniform in [0.9, 1) (about half below 0.95)."""
    import numpy as np
    rng = np.random.default_rng(seed + 16)
    n = CLI_OBJECTS
    lens = np.sort(rng.integers(5_000, 200_000, n))[::-1]
    names = [f'obj{i:05d}' for i in range(n)]
    ids = work / 'ani.ids.tsv'
    ids.write_text('id\tseq_len\tno_parts\n' + ''.join(
        f'{nm}\t{ln}\t1\n' for nm, ln in zip(names, lens.tolist())))
    q = rng.integers(0, n, CLI_ROWS)
    r = np.clip(q + rng.integers(-63, 64, CLI_ROWS), 0, n - 1)
    tani = rng.random(CLI_ROWS) * 0.1 + 0.9
    cov = rng.random(CLI_ROWS) * 0.2 + 0.8
    ani = work / 'ani.tsv'
    ani.write_text('\t'.join(CLI_HEADER) + '\n' + ''.join(
        f'{a}\t{b}\t{names[a]}\t{names[b]}\t{t:.6f}\t{t * c:.6f}\t{t:.6f}\t'
        f'{c:.6f}\t{c:.6f}\t1\t{lens[b] / lens[a]:.6f}\n'
        for a, b, t, c in zip(q.tolist(), r.tolist(), tani.tolist(),
                              cov.tolist())))
    keep = (tani >= 0.95) & (q != r)
    passing = len(np.unique(np.stack([np.minimum(q, r), np.maximum(q, r)],
                                     axis=1)[keep], axis=0))
    return ani, ids, passing


def phase_cluster_cli(work: pathlib.Path, seed: int) -> dict:
    """The `cluster` CLI on the card above the device size: single linkage
    (the default) over 60,000 objects, K11 launched, clusters.tsv == the
    same CLI run on the CPU (VCLUST_TORCH_DEVICE=cpu: cc_plain)."""
    from vclust_tpu_torch.models import cluster as mc
    from vclust_tpu_torch.ops import cc
    work.mkdir()
    ani, ids, passing = cluster_inputs(work, seed)
    if CLI_OBJECTS < mc._DEVICE_SINGLE_MIN_NODES:
        fail('the cluster_cli corpus is below the device path\'s size')
    args = ['cluster', '-i', ani, '--ids', ids, '--metric', 'tani',
            '--tani', 0.95, '-v', 0]
    cc._cc_run.launches = 0
    t0 = time.perf_counter()
    cli(*args, '-o', work / 'clusters.tsv')
    card_s = time.perf_counter() - t0
    launches = cc._cc_run.launches
    if launches != 1:
        fail(f'cluster CLI launched K11 {launches} times')
    os.environ['VCLUST_TORCH_DEVICE'] = 'cpu'
    try:
        t0 = time.perf_counter()
        cli(*args, '-o', work / 'clusters_cpu.tsv')
        cpu_s = time.perf_counter() - t0
    finally:
        os.environ['VCLUST_TORCH_DEVICE'] = 'cuda'
    if cc._cc_run.launches != launches:
        fail('the CPU cluster run launched K11')
    out = (work / 'clusters.tsv').read_bytes()
    if out != (work / 'clusters_cpu.tsv').read_bytes():
        fail('cluster CLI: clusters.tsv on the card != on the CPU')
    clusters = len({ln.split(b'\t')[1] for ln in out.splitlines()[1:]})
    res = dict(phase='cluster_cli', objects=CLI_OBJECTS, rows=CLI_ROWS,
               edges_passing=passing, clusters=clusters,
               clusters_tsv_eq_cpu=True, k11_launches=launches,
               seconds=card_s, cpu_seconds=cpu_s)
    emit(res)
    return res


# --------------------------------------------------------------------------
# Phase 5: the CLI main path
# --------------------------------------------------------------------------

def mutant_corpus():
    """bench.py:33-45: the 12 example genomes plus 3 mutants of each at 5%
    substitutions (48 genomes)."""
    import numpy as np
    from vclust_tpu_torch.models.input import Genome, load_genomes
    from vclust_tpu_torch.utils.data import example_path
    genomes, _ = load_genomes(example_path('multifasta.fna'))
    rng = np.random.default_rng(0)
    acgt = np.frombuffer(b'ACGT', dtype='S1')
    corpus = list(genomes)
    for rep in range(1, 4):
        for g in genomes:
            s = np.frombuffer(g.seqs[0], dtype='S1').copy()
            mask = rng.random(len(s)) < 0.05
            s[mask] = acgt[rng.integers(0, 4, mask.sum())]
            corpus.append(Genome(name=f'{g.name}.r{rep}', seqs=[s.tobytes()]))
    return corpus


def cli(*argv):
    from vclust_tpu_torch.cli import main
    main([str(a) for a in argv])


@contextlib.contextmanager
def prefilter_sets(sets, host_counts=False):
    """Inside: run_prefilter takes `sets` (fresh lists, by genome) as the
    genomes' k-mer sets; with host_counts its unbatched count is the exact
    host count from the index (`_counts_from_index_host`, which phase k1
    holds K1 to) in place of the device count."""
    from vclust_tpu_torch.models import prefilter as mp
    from vclust_tpu_torch.ops import prefilter as pf
    saved = mp.build_kmer_sets, mp.shared_kmer_counts
    mp.build_kmer_sets = lambda genomes, *a, **k: list(sets)
    if host_counts:
        mp.shared_kmer_counts = lambda kmer_sets, **k: \
            pf._counts_from_index_host(pf.PrefilterIndex(kmer_sets))
    try:
        yield
    finally:
        mp.build_kmer_sets, mp.shared_kmer_counts = saved


def batched_prefilter(torch, work: pathlib.Path, fasta, fltr, sets) -> dict:
    """G2, the batched prefilter on the card (`_batched_entries`,
    `BatchIndexStore.pair_block`: the path of `prefilter --batch-size` and
    of every CLI prefilter above 16,384 genomes): the CLI on the 48 genomes
    at 2 and 3 batches, fltr.txt == the unbatched run's (itself == the host
    backend's); run_prefilter on k1 a's 1,536 sets at 3 batches ==
    unbatched == the host count's. K1's launches on each batched run (a
    block of at most 32 genomes counts on the host); any run that should
    have launched K1 and did not fails."""
    from vclust_tpu_torch.io.formats import write_fltr
    from vclust_tpu_torch.models.input import Genome
    from vclust_tpu_torch.models.prefilter import run_prefilter
    from vclust_tpu_torch.ops import prefilter as pf
    out = {}
    for bs in (24, 20):
        got = work / f'fltr_batch{bs}.txt'
        pf.occupancy_count.launches = 0
        t0 = time.perf_counter()
        cli('prefilter', '-i', fasta, '-o', got, '--batch-size', bs, '-v',
            '0')
        seconds = time.perf_counter() - t0
        launches = pf.occupancy_count.launches
        if got.read_bytes() != fltr.read_bytes():
            fail(f'prefilter --batch-size {bs}: fltr.txt != the unbatched '
                 f'run')
        if not launches:      # the block of batches 0 and 1 holds > 32
            fail(f'prefilter --batch-size {bs} launched no K1')
        out[f'cli_48_batch_size_{bs}'] = dict(
            batches=-(-48 // bs), k1_launches=launches, seconds=seconds,
            fltr_eq_unbatched=True)
    n = len(sets)
    bs = -(-n // 3)
    if n != 1536 or -(-n // bs) != 3:
        fail(f'batched prefilter: {n} sets, not k1 a\'s 1,536 in 3 batches')
    genomes = [Genome(name=f'g{i}', seqs=[b'']) for i in range(n)]
    files = {}
    for name, kw, host in (('unbatched', {}, False), ('batched', dict(
            batch_size=bs), False), ('host_count', {}, True)):
        pf.occupancy_count.launches = 0
        t0 = time.perf_counter()
        with prefilter_sets(sets, host):
            fm = run_prefilter(genomes, **kw)
        seconds = time.perf_counter() - t0
        files[name] = work / f'fltr_1536_{name}.txt'
        write_fltr(files[name], fm)
        if len(fm.names) != n:
            fail(f'run_prefilter ({name}): {len(fm.names)} rows for {n} sets')
        out[f'run_prefilter_1536_{name}'] = dict(
            k1_launches=pf.occupancy_count.launches, seconds=seconds,
            pairs=len(fm.entries), **({'batch_size': bs} if kw else {}))
    # 3 batches: 6 blocks of 512-1,024 genomes, each at least one pass.
    if out['run_prefilter_1536_batched']['k1_launches'] < 6:
        fail('run_prefilter on 1,536 sets in 3 batches launched K1 fewer '
             'times than its 6 blocks')
    want = files['host_count'].read_bytes()
    for name in ('unbatched', 'batched'):
        if files[name].read_bytes() != want:
            fail(f'run_prefilter on 1,536 sets ({name}) != the host count')
    return out


def phase_main(torch, dev, work: pathlib.Path, k1a_sets):
    import numpy as np
    from vclust_tpu_torch.io.fasta import FastaRecord, write_fasta
    from vclust_tpu_torch.io.formats import write_fltr
    from vclust_tpu_torch.models.prefilter import (build_kmer_sets,
                                                   run_prefilter)
    from vclust_tpu_torch.ops import extend as kx
    from vclust_tpu_torch.ops import prefilter as pf
    from vclust_tpu_torch.utils.data import example_dir
    corpus = mutant_corpus()
    fasta = work / 'corpus48.fna'
    write_fasta(fasta, [FastaRecord(g.name, g.name, g.seqs[0])
                        for g in corpus])
    fltr, ani, ids, clusters = (work / f for f in (
        'fltr.txt', 'ani.tsv', 'ani.ids.tsv', 'clusters.tsv'))

    pf.occupancy_count.launches = 0
    kx.extend.launches = 0
    t0 = time.perf_counter()
    cli('prefilter', '-i', fasta, '-o', fltr, '-v', '0')
    t_prefilter = time.perf_counter() - t0
    launches = {'occupancy_count': pf.occupancy_count.launches,
                'extend': kx.extend.launches}
    if launches['occupancy_count'] < 1:
        fail('the CLI prefilter did not launch K1')
    host = work / 'fltr_host.txt'
    write_fltr(host, run_prefilter(corpus, backend='host'))
    if fltr.read_bytes() != host.read_bytes():
        fail('fltr.txt (device) != fltr.txt (host backend)')

    # K1 at the shape the CLI gave it (the same index, chunked the same
    # way), held against its plain version and against the full host count
    # matrix: fltr.txt keeps only the pairs above its cuts.
    sets = build_kmer_sets(corpus, 25, 1.0)
    idx = pf.PrefilterIndex(sets)
    by_index = pf._counts_from_index_host(idx)
    k1_main = k1_case(torch, dev, 'main_cli_48', idx, lambda got: (
        np.array_equal(got, by_index)
        and np.array_equal(got, pf.shared_kmer_counts_host(sets))))
    emit(dict(phase='k1', **k1_main))

    t0 = time.perf_counter()
    cli('align', '-i', fasta, '-o', ani, '--filter', fltr,
        '--filter-threshold', '0.7', '-v', '0')
    cli('cluster', '-i', ani, '--ids', ids, '-o', clusters,
        '--metric', 'tani', '--tani', '0.95', '-v', '0')
    t_align_cluster = time.perf_counter() - t0
    n_pairs = sum(1 for _ in open(ani)) - 1
    n_clusters = len({ln.split('\t')[1] for ln in
                      clusters.read_text().splitlines()[1:]})

    ex = example_dir()
    gold = ex / 'output'
    efltr, eani, eids, eclu = (work / f for f in (
        'ex_fltr.txt', 'ex_ani.tsv', 'ex_ani.ids.tsv', 'ex_clusters.tsv'))
    cli('prefilter', '-i', ex / 'multifasta.fna', '-o', efltr, '-v', '0')
    cli('align', '-i', ex / 'multifasta.fna', '-o', eani, '--filter', efltr,
        '--filter-threshold', '0.7', '-v', '0')
    cli('cluster', '-i', eani, '--ids', eids, '-o', eclu, '--metric', 'tani',
        '--tani', '0.95', '-v', '0')
    if efltr.read_bytes() != (gold / 'fltr.txt').read_bytes():
        fail('example fltr.txt != example/output/fltr.txt')
    if eclu.read_bytes() != (gold / 'clusters.tsv').read_bytes():
        fail('example clusters.tsv != example/output/clusters.tsv')
    batched = batched_prefilter(torch, work, fasta, fltr, k1a_sets)
    emit(dict(phase='main', genomes=len(corpus), path_launches=launches,
              fltr_eq_host=True, ani_rows=n_pairs, clusters=n_clusters,
              prefilter_s=t_prefilter, align_cluster_s=t_align_cluster,
              example_fltr_eq_golden=True, example_clusters_eq_golden=True,
              batched_prefilter=batched))
    return launches, k1_main


# --------------------------------------------------------------------------
# Phase 7: the v3 align pipe, K2 and K3
# --------------------------------------------------------------------------

def contig_corpus(n: int = 128, length: int = 3500, families: int = 16):
    """bench.py:94-109: `families` random base contigs, each with variants
    at 2-10% substitutions (128 contigs of 3,500 bases)."""
    import numpy as np
    from vclust_tpu_torch.models.input import Genome
    rng = np.random.default_rng(3)
    acgt = np.frombuffer(b'ACGT', dtype='S1')
    bases = [acgt[rng.integers(0, 4, length)] for _ in range(families)]
    corpus = []
    for i in range(n):
        s = bases[i % families].copy()
        mask = rng.random(length) < rng.uniform(0.02, 0.10)
        s[mask] = acgt[rng.integers(0, 4, mask.sum())]
        corpus.append(Genome(name=f'c{i}', seqs=[s.tobytes()]))
    return corpus


def align_inputs(corpus):
    """Codes in ids order and all pairs (i < j), as bench.py's
    bench_align_tpu builds them."""
    import numpy as np
    from vclust_tpu_torch.models.align import _genome_codes, order_objects
    codes = [_genome_codes(corpus[i]) for i in order_objects(corpus)]
    n = len(codes)
    pairs = np.array([(i, j) for i in range(n) for j in range(i + 1, n)],
                     dtype=np.int32)
    return codes, pairs


# The align kernels' wrappers in ops/align_gpu.py (K2, K3, K5, K4, K6 with
# K8 fused in, K7; also the names of their rows in the kernels line) and
# their plain versions.
ALIGN_KERNELS = (('stage1_pack', 'stage1_pack_plain'),
                 ('_bands_v3', 'bands_v3_plain'),
                 ('_propagate_v3', 'propagate_v3_plain'),
                 ('_blocks_to_measures', 'blocks_to_measures_plain'),
                 ('_votes_elect_v2', 'votes_elect_v2_plain'),
                 ('_propagate_v2', 'propagate_v2_plain'))


@contextlib.contextmanager
def plain_kernels(ag):
    """Inside: the align pipes call the plain versions of K2, K3, K5, K4,
    K6 (the plain pair of K8 and K6) and K7 (same tensors, same device)
    instead of the kernels."""
    saved = {k: getattr(ag, k) for k, _ in ALIGN_KERNELS}
    for k, plain in ALIGN_KERNELS:
        setattr(ag, k, getattr(ag, plain))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(ag, k, fn)


# The index builds' wrappers (K9, K10; rows index_v3 and index_v2 of the
# kernels line) and their plain versions.
INDEX_KERNELS = (('_index_block_v3', 'index_block_v3_plain'),
                 ('_index_block', 'index_block_plain'))


def zero_align_launches(ag) -> None:
    for k, _ in ALIGN_KERNELS + INDEX_KERNELS:
        getattr(ag, k).launches = 0


def align_launches(ag) -> dict:
    return {k: getattr(ag, k).launches
            for k, _ in ALIGN_KERNELS + INDEX_KERNELS}


def check_align_launches(path: str, launches: dict, st: dict,
                         index_only: bool = False):
    """Each v3 dispatch launches K2, K3, K5 and K4 once, each v2 dispatch
    K6 (K8 fused in), K7 and K4 once, each chunk of genomes of a v3 or v2
    arena build (st from pipe_timer) K9 or K10 once; a path that launched
    none of its kernels fails (index_only: none of K9 and K10)."""
    v3, v2 = st['v3']['dispatches'], st['v2']['dispatches']
    c3, c2 = st['v3']['index_chunks'], st['v2']['index_chunks']
    want = {'stage1_pack': v3, '_bands_v3': v3, '_propagate_v3': v3,
            '_blocks_to_measures': v3 + v2, '_votes_elect_v2': v2,
            '_propagate_v2': v2, '_index_block_v3': c3, '_index_block': c2}
    if launches != want or not (c3 + c2 if index_only else v3 + v2):
        fail(f'{path}: launches {launches} for {v3} v3 and {v2} v2 '
             f'dispatches and {c3} v3 and {c2} v2 index chunks (want '
             f'{want})')


@contextlib.contextmanager
def no_launches(ag, what: str):
    """Inside: plain versions run; no align or index kernel may launch."""
    before = align_launches(ag)
    yield
    if align_launches(ag) != before:
        fail(f'{what}: a kernel launched while the plain version ran')


def same_records(path: str, got, want) -> None:
    """Aggregates, record counts and records equal, bit for bit."""
    for what, a, b in (('aggregates', got[0], want[0]),
                       ('record counts', got[1][1], want[1][1]),
                       ('records', got[1][0], want[1][0])):
        if a.shape != b.shape or not (a == b).all():
            fail(f'{path}: {what}, kernels != plain')


def profile_breakdown(torch, fn, top: int = 10, warm: bool = False,
                      expect: tuple = ()) -> dict:
    """One call of `fn` under torch.profiler (device activity only): its
    wall time, the device time of its kernels and memory operations, their
    share of the wall time (the device's busy share) and the largest
    entries by device time. `warm`: a call of `fn` in a warm-up step of
    the profiler first, its events dropped. `expect`: names of kernels
    the call launches; a trace can lose events (the first device
    operation it records, or all of them), so where it lacks one it is taken
    again, up to three times, and `tries` and `lost` (what the last trace
    still lacked) are given."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for tries in range(1, 4):
        torch.cuda.synchronize()
        kw = dict(schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                  ) if warm else {}
        with profile(activities=[ProfilerActivity.CUDA], **kw) as prof:
            if warm:
                fn()
                torch.cuda.synchronize()
                prof.step()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if warm:
                prof.step()
        ka = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        lost = [n for n in expect if not any(n in e.key for e in ka)]
        if not lost:
            break
    dev_us = sum(e.self_device_time_total for e in ka)
    ka.sort(key=lambda e: -e.self_device_time_total)
    return dict(wall_ms=wall * 1e3, device_ms=dev_us / 1e3,
                busy_share=dev_us / 1e6 / wall if wall else None,
                top=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
                     for e in ka[:top]],
                **(dict(tries=tries, lost=lost) if expect else {}))


def arena_rc(torch, b, codes, kb):
    """The reverse-complement codes (G, kb) of arena b's genomes on its
    device, as GenomeIndex._build lays them out (the arena keeps only the
    forward codes)."""
    import numpy as np
    from vclust_tpu_torch.core.seq import revcomp_codes
    rc = np.full(tuple(b['fwd'].shape), 4, np.int8)
    for g, row in b['rows'].items():
        rc[row, :len(codes[g])] = revcomp_codes(codes[g])
    return torch.from_numpy(rc).to(b['fwd'].device)


def same_arena(path, got, want, keys) -> None:
    """Arrays equal key by key (dtype, shape, values), or fail."""
    import torch
    torch.cuda.synchronize()
    for key, g, w in zip(keys, got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            fail(f'{path}: {key} != the plain version')


K9_DESIGN = ('a warp a coarse block of V3_WQ positions: a lane the hashes '
             'of positions 32 f + lane from one coalesced load of a block '
             'of 32 and the next, the k-mer\'s later codes by shuffles; an '
             'H-byte row a warp in shared memory, zero between rows: the '
             'lanes set their hashes\' bytes, the warp stores the row in '
             'lane-owned 16-byte chunks, the lanes clear the bytes; FPB '
             'rocc rows and 2 qocc rows from the lane\'s FPB hashes; the '
             'wide rows as 16-byte copies of codes or pads; one wave of '
             'CTAs, warps taking coarse blocks in turn')


def k9_alone(torch, ag, b, codes, kb) -> dict:
    """K9 on arena b's genomes (its codes; bucket kb) == the arena (built
    by K9 through GenomeIndex) == index_block_v3_plain on the same codes,
    key by key (the plain version launching nothing); K9's ms, device_ms,
    plain_ms and bytes bound (both strands' codes read once, the
    occupancies and window rows written once)."""
    fwd = b['fwd']
    rc = arena_rc(torch, b, codes, kb)
    at = f'v3 index, bucket {kb}: {fwd.shape[0]} genomes'

    def run():
        return ag._index_block_v3(fwd, rc, ag.SEED_K, kb)

    def plain():
        return ag.index_block_v3_plain(fwd, rc, ag.SEED_K, kb)

    keys = ag._V3_KEYS
    same_arena(at, run(), [b[k] for k in keys], keys)
    with no_launches(ag, at):
        same_arena(at, [b[k] for k in keys], plain(), keys)
        plain_ms = time_ms(plain, 2)
    nbytes = 2 * fwd.numel() + sum(b[k].numel() for k in keys)
    return with_shares(dict(
        genomes=int(fwd.shape[0]), bucket=kb, max_abs_err=0,
        ms=time_ms(run, 5), **device_ms_item(run, 5), plain_ms=plain_ms,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by='bytes',
        bytes=nbytes, at=at))


def align_v3_corpus(torch, dev, name, corpus, ag, reps: int = 3):
    import numpy as np
    codes, pairs = align_inputs(corpus)
    lens = [len(c) for c in codes]
    members = {}
    for i, j in pairs.tolist():
        kb = max(ag._pad_bucket(lens[i]), ag._pad_bucket(lens[j]))
        members.setdefault(kb, set()).update((i, j))
    # The index build (K9 a chunk of genomes), counted from 0.
    zero_align_launches(ag)
    with pipe_timer(ag) as bst:
        t0 = time.perf_counter()
        idx = ag.GenomeIndex(codes, device=dev)
        for kb, gids in sorted(members.items()):
            idx.ensure_v3(kb, gids)
        torch.cuda.synchronize()
        index_s = time.perf_counter() - t0
    index_launches = align_launches(ag)
    check_align_launches(f'align_v3 {name}: the index', index_launches, bst,
                         index_only=True)
    # The index's least bytes: both strands' codes read once, the padded
    # codes, occupancies and window rows written once.
    index_bytes = sum(idx.bucket[(kb, 'v3')][k].numel() for kb in members
                      for k in ('fwd', 'qocc', 'rocc', 'roww_f', 'roww_r')) \
        + sum(2 * kb * len(g) for kb, g in members.items())
    # K9 against its plain version on each bucket's arena, and alone.
    k9 = {kb: k9_alone(torch, ag, idx.bucket[(kb, 'v3')], codes, kb)
          for kb in sorted(members)}

    # The path, counted from 0.
    torch.cuda.reset_peak_memory_stats()
    zero_align_launches(ag)
    with pipe_timer(ag) as st:
        t0 = time.perf_counter()
        got = ag._all2all_single(codes, pairs, index=idx,
                                 keep_alignments=True, pipe='v3')
        first_s = time.perf_counter() - t0
    launches = align_launches(ag)
    peak = torch.cuda.max_memory_allocated()
    dispatches = {p: st[p]['dispatches'] for p in st}
    check_align_launches(f'align_v3 {name}', launches, st)

    # The same function with the plain K2, K3, K5 and K4.
    with plain_kernels(ag):
        want = ag._all2all_single(codes, pairs, index=idx,
                                  keep_alignments=True, pipe='v3')
    same_records(f'align_v3 {name}', got, want)
    out = got[0]
    if out.shape != (len(pairs), 6) or (out < 0).any():
        fail(f'align_v3 {name}: malformed aggregates')

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        agg = ag._all2all_single(codes, pairs, index=idx, pipe='v3')
        walls.append(time.perf_counter() - t0)
    if not np.array_equal(agg, out):
        fail(f'align_v3 {name}: aggregates differ between runs')
    prof = profile_breakdown(
        torch, lambda: ag._all2all_single(codes, pairs, index=idx,
                                          pipe='v3'))
    return dict(phase='align_v3', corpus=name, genomes=len(codes),
                pairs=int(len(pairs)), buckets=sorted(members),
                index_s=index_s, index_prep_s=idx.prep_s,
                index_k9_device_ms=sum(r['device_ms'] or 0
                                       for r in k9.values()),
                index_launches=index_launches,
                index_bound_ms=index_bytes / HBM_BYTES_PER_S * 1e3,
                k9=k9,
                first_run_s=first_s, warm_s=walls,
                pairs_per_s=len(pairs) / min(walls), path_launches=launches,
                dispatches=dispatches, peak_mem_gib=peak / 2 ** 30,
                aligned_pairs=int((out[:, 0] + out[:, 3] > 0).sum()),
                records=int(len(got[1][0])), kernels_eq_plain=True,
                profile=prof), codes, pairs, idx, out


def native_dtani(codes, pairs, out) -> dict:
    """|tANI(out) - tANI(native C++ engine)| over the pairs: its max, the
    pair where it is largest (with both tANIs), and the pairs above 0.01;
    over the pairs at native tANI >= 0.7 (the example workflow's filter
    threshold), the max and the pairs above 0.007 (the accuracy contract
    of tests/test_align_tpu.py)."""
    import numpy as np
    from vclust_tpu_torch.ops import lz_native
    from vclust_tpu_torch.ops.lz_parse_py import AlignParams
    agg, _ = lz_native.all2all_native(codes, pairs, AlignParams(),
                                      n_threads=os.cpu_count() or 1)
    lens = np.array([len(c) for c in codes], np.float64)
    den = lens[pairs[:, 0]] + lens[pairs[:, 1]]
    t_v3 = (out[:, 1] + out[:, 4]) / den
    t_nat = (agg[:, 1] + agg[:, 4]) / den
    d = np.abs(t_v3 - t_nat)
    k = int(d.argmax())
    return dict(max_abs_dtani_vs_native=float(d[k]),
                worst_pair=[int(pairs[k, 0]), int(pairs[k, 1])],
                worst_tani_and_native=[float(t_v3[k]), float(t_nat[k])],
                pairs_dtani_over_0_01=int((d > 0.01).sum()),
                pairs_native_tani_ge_0_7=int((t_nat >= 0.7).sum()),
                max_abs_dtani_native_tani_ge_0_7=float(
                    d[t_nat >= 0.7].max(initial=0.0)),
                pairs_dtani_over_0_007_native_tani_ge_0_7=int(
                    (d[t_nat >= 0.7] > 0.007).sum()))


def cpu_reference_check(dev, ag, codes, pairs, out, n: int = 8) -> dict:
    """The pipe on the card against the same pipe on the CPU (plain K2 and
    K3; equal to the JAX package's by tests/test_torch_align_v3.py) for the
    pairs among the first `n` genomes, aggregates and records; the card's
    aggregates there also equal the full run's."""
    import numpy as np
    keep = (pairs[:, 0] < n) & (pairs[:, 1] < n)
    sub = pairs[keep]
    gpu = ag._all2all_single(codes[:n], sub, device=dev,
                             keep_alignments=True, pipe='v3')
    cpu = ag._all2all_single(codes[:n], sub, device='cpu',
                             keep_alignments=True, pipe='v3')
    if not (np.array_equal(gpu[0], cpu[0]) and np.array_equal(gpu[0],
                                                              out[keep])
            and np.array_equal(gpu[1][1], cpu[1][1])
            and np.array_equal(gpu[1][0], cpu[1][0])):
        fail(f'align_v3: the card != the CPU on {len(sub)} pairs')
    return dict(cpu_eq_pairs=int(len(sub)), cpu_eq_records=int(
        len(cpu[1][0])))


K2_DESIGN = ('wgmma m64n256k32 u8 (two consumer warpgroups, a 128 x 256 '
             'tile; one warpgroup on 64 x 128 at 2*NQB <= 64, NRB <= 128) '
             'from a 4-stage TMA ring; a 5-D map of the query arena puts '
             'half rows 2q and 2q+1 in one thread, so the packed maxes need '
             'no shuffle; persistent CTAs in (row, reference tile, query, '
             'query tile) order; atomicMax epilogue')
K3_DESIGN = ('stages 2-4 in one launch, the wide rows read in place (no '
             'window tensor): a warp a coarse block, each band\'s row built '
             'once into bit planes (low, high, is-a-base) with __ballot_sync '
             'and each fine block\'s window taken from them, a lane a shift: '
             'funnel shifts, the match mask, __popc; bands without N skip '
             'the is-a-base planes; the election in registers, one '
             '__reduce_max_sync a fine block, decoded by lane k (count, '
             'strand, diagonal, gate and threshold); no shared memory')
K4_DESIGN = ('positions as bits, 32 a word (a word a fine block); a CTA a '
             'chunk of 512 words of one pair (fewer threads on shorter pairs; '
             'N * ceil(NBF / 512) CTAs, taken in order from an atomic '
             'ticket), 2 consecutive words a thread with 3 words of halo '
             'each side for the runs, the +-39 dilations and the 15-windows '
             '(a carry-save count); a summary of each chunk from its own '
             'words by three block-wide scans (forward aggregate; segment '
             'starts found a word at a time with masks, all but the first '
             'anchored match; the segments they close); one decoupled '
             'look-back applies the predecessors\' summaries to the nearest '
             'published state; the last chunk closes the last segment, '
             'writes the aggregates and the -1 rows')
K5_DESIGN = ('tiles of 128 blocks of one pair, a warp each (4 a CTA), the '
             'first from block 0, the others with EXT_ITERS + 1 blocks of '
             'halo left, EXT_ITERS right; blocks lane + 32 j; a candidate '
             'table of each block\'s counts at the initial states of the '
             'assigned blocks of its cone, gathered up front (a block\'s '
             'candidates on neighbouring lanes, runs of one state loaded '
             'once); the steps by shuffles, carrying source blocks; then the '
             'flags 4 blocks at a time, 8 lanes a block and a word a lane, '
             'the windows read from the wide rows K3 read, 16 blocks\' '
             'loads in flight')
NO_LIBRARY = {
    '_blocks_to_measures': 'none: no PyTorch call computes the segmentation '
                           '(its plain version is some 80 torch ops)',
    '_propagate_v3': 'none: no PyTorch call computes the neighbour adoption '
                     '(its plain version is some 100 torch ops)',
    'connected_components': 'none: no PyTorch call computes connected '
                            'components'}

# Int32 issue slots a word of 32 positions needs in the least bit-parallel
# sequence of the back half (K4's operation bound):
#   32  pack the two flag arrays to bits: 8 words of 4 bytes each, a
#       multiply and a shift-or into place
#    2  the switch refinement: a select under the mask below the switch
#       point (the point's own search, on switchable blocks only, is left
#       out)
#   18  runs of MSL = 7: 6 funnel shifts and 3 LOP3 for the starts, as many
#       for the fill
#   30  runs of MAL = 11: 10 and 5, twice
#   24  the +-39 dilations: 5 doubling steps of a shift and an OR each way,
#       and the steps of 8
#   44  the 15-wide density rule: a 4-bit sum of 15 shifted copies (14
#       funnel shifts, 11 full adders of 2 LOP3; >= 8 is the top bit) and
#       the fill 14 ahead (4 doubling steps)
#    2  the anchored matches
#   10  what the scans carry: the population count of m (4 slots), the
#       last set bit of the anchored matches, breaks and MAL runs
K4_SLOTS_PER_WORD = 162


def k4_bound(n: int, Lq: int, width: int = 0) -> dict:
    """K4's least time on n pairs: the bytes (the two flag arrays, 13 bytes
    a block of per-block inputs, rlen, the aggregates and counts and, with
    records, `width` rows of 24 bytes a pair) and the int32 slots."""
    words = n * (Lq // 32)
    nbytes = 2 * n * Lq + 13 * words + 20 * n + 24 * n * width
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = K4_SLOTS_PER_WORD * words / INT32_SLOTS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                bound_bytes_ms=t_bytes, bound_ops_ms=t_ops, bytes=nbytes,
                int32_slots=K4_SLOTS_PER_WORD * words)


def k4_alone(torch, ag, flat, rl, Lq: int, kw: dict, at: str) -> dict:
    """K4 alone on one dispatch's back-half inputs, without and with
    records, each against its plain version on the same tensors: error,
    ms, device_ms, plain_ms and the bound."""
    out = dict(at=at)
    for alns in (False, True):
        def run(fn, alns=alns):
            return fn(*flat, rl, Lq=Lq, with_alns=alns, **kw)
        got, want = run(ag._blocks_to_measures), \
            run(ag.blocks_to_measures_plain)
        torch.cuda.synchronize()
        got, want = (got, want) if alns else ((got,), (want,))
        if any(g.shape != w.shape for g, w in zip(got, want)):
            fail(f'K4 at {at}: shapes differ from plain')
        err = max(int((g - w).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        if err:
            fail(f'K4 != plain at {at} (records {alns}; max abs err {err})')
        out['records' if alns else 'aggregates'] = with_shares(dict(
            max_abs_err=err, ms=time_ms(lambda: run(ag._blocks_to_measures),
                                        5),
            **device_ms_item(lambda: run(ag._blocks_to_measures), 5),
            plain_ms=time_ms(lambda: run(ag.blocks_to_measures_plain), 3),
            **k4_bound(rl.shape[0], Lq, got[1].shape[1] if alns else 0)))
    return out


def band_rows(rlens, g1, g2, NRB) -> list:
    """Each band's reference block of every coarse block, as K3 and K5 read
    them: g1 and g2 forward, their mirrors on the reverse strand."""
    rl = rlens.view(-1, 1, 1)

    def mirror(g):
        return ((rl - 32 * g - 32) >> 5).clamp(0, NRB - 1)
    return [g1, mirror(g1), g2, mirror(g2)]


def v3_row_bytes(torch, r_rows, rlens, g1, g2, g3) -> int:
    """Bytes of the distinct wide rows that a dispatch's bands read, each
    once (forward and reverse strand)."""
    NRB = g3['NRB']
    rr = r_rows.long().view(-1, 1, 1) * NRB
    gs = band_rows(rlens, g1, g2, NRB)
    return g3['ROWW'] * sum(
        len(torch.unique(torch.cat([(rr + gs[i]).flatten(),
                                    (rr + gs[i + 2]).flatten()])))
        for i in (0, 1))


def k3_slots(torch, b, r_rows, rlens, q_rows, g1, g2, g3) -> float:
    """K3's least int32 issue slots on a dispatch, with bases as bit planes
    (low bit, high bit, is-a-base), 32 a word, a lane a shift. Each fine
    block, band and shift: 2 LOP3 give the match mask (a query block's
    is-a-base plane folds into the first at no cost), a population count
    (4 slots), and the packed election's pack ((count << 12) + the band's
    tag and shift, a constant of the lane: 1) and max (1): 8 slots; 1 LOP3
    more where the reference window holds a code other than 0-3. The
    funnel shifts that align a window depend only on the row's word k + j
    and the lane, so each coarse block, band and lane shifts each of its
    row's 2 FPB + 2 words once a plane: the low and high planes always,
    the is-a-base plane at the words of the windows that need it. Counts
    this dispatch's data."""
    WIN, FPB, NRB, BAND = g3['WIN'], g3['FPB'], g3['NRB'], g3['BAND']
    R, K, NQB = g1.shape
    rr = r_rows.long().view(R, 1, 1)
    words = 2 * FPB + 2
    k = torch.arange(FPB, device=g1.device)[:, None]
    c = torch.arange(words, device=g1.device)
    reach = (c >= k) & (c <= k + FPB + 2)                    # (FPB, words)
    odd_windows = odd_words = 0
    for i, g in enumerate(band_rows(rlens, g1, g2, NRB)):
        rows = b['roww_r' if i & 1 else 'roww_f'][rr, g.long()]
        bad = (rows < 0) | (rows > 3)
        odd = torch.stack([bad[..., 16 + 32 * k:16 + 32 * k + WIN].any(-1)
                           for k in range(FPB)], dim=-1)    # (R, K, NQB, FPB)
        odd_windows += int(odd.sum())
        odd_words += int((odd[..., None] & reach).any(-2).sum())
    windows = 4 * R * K * NQB * FPB
    return float(BAND * (8 * windows + odd_windows)
                 + 32 * (2 * words * windows // FPB + odd_words))


def k5_bytes(torch, ag, el, args, g3) -> int:
    """The least bytes of stages 5-6 on `el`: the 32-byte sectors its
    gathers need, each read once (a step's count of each block whose
    neighbour differs, at the neighbour's diagonal in the bands of its
    strand that hold it, and those blocks' candidates g1, g2; the query
    codes and the row bytes of each flag's window in the bands that hold
    it), the per-block election read once and every output written once.
    args: (b, r_rows, rlens, q_rows, g1, g2). Replays the plain version's
    steps to find them."""
    _, r_rows, rlens, q_rows, g1, g2 = args
    BAND, FPB, WQ = g3['BAND'], g3['FPB'], g3['WQ']
    NRB, ROWW = g3['NRB'], g3['ROWW']
    R, K, NBF = el['A'].shape
    N, NQB = R * K, NBF // FPB
    dev = el['A'].device
    fc = torch.arange(NBF, device=dev) // FPB
    gs = [g.reshape(N, NQB)[:, fc].long()
          for g in band_rows(rlens, g1, g2, NRB)]
    base = [32 * g - (fc + 1) * WQ - 16 for g in gs]
    cnt = el['cnt'].reshape(4, N, NBF, BAND)
    A, S, D = (el[k].reshape(N, NBF) for k in ('A', 'S', 'D'))
    cc = torch.where(A, el['cnt_best'].reshape(N, NBF), -1)
    blk = torch.arange(N * NBF, device=dev).view(N, NBF)
    cblk = (torch.arange(N, device=dev)[:, None] * NQB + fc) * 4 // 32
    rr = r_rows.long().repeat_interleave(K)[:, None] * NRB
    in_row = 16 + 32 * (torch.arange(NBF, device=dev) % FPB)
    reads = {'cnt': [], 'g': [], 'rows_f': [], 'rows_r': [], 'q': []}

    def gather(Sx, Dx, need, flags=False):
        out = torch.full((N, NBF), -1, dtype=torch.int32, device=dev)
        for i, is_rc in enumerate(ag._BAND_IS_RC):
            mine = need & (Sx if is_rc else ~Sx)
            reads['g'].append((i // 2) * N * NQB * 4 // 32 + cblk[mine])
            tn = Dx - base[i]
            ok = mine & (tn >= 0) & (tn < BAND)
            if flags:
                at = ((rr + gs[i]) * ROWW + in_row + tn)[ok]
                reads['rows_r' if is_rc else 'rows_f'] += [at // 32,
                                                           (at + 31) // 32]
            else:
                at = (i * N * NBF + blk[ok]) * BAND + tn[ok]
                reads['cnt'].append(at // 32)
            cv = torch.gather(cnt[i], -1, tn.clamp(0, BAND - 1).long()[
                ..., None])[..., 0].int()
            out = torch.maximum(out, torch.where(ok, cv, -1))
        return out

    for _ in range(ag.EXT_ITERS):
        for shf in (ag._sh_r, ag._sh_l):
            Dn, Sn, An = shf(D, 1, 0), shf(S, 1, False), shf(A, 1, False)
            need = An & ((Dn != D) | (Sn != S))
            cn = torch.where(need, gather(Sn, Dn, need), -1)
            better = (cn >= ag.EXT_MIN) & (cn > cc + ag.EXT_MARGIN)
            adopt = better | (A & (cn >= ag.EXT_MIN)
                              & (cn + ag.V3_CONT >= cc) & (cn <= cc))
            D, S = torch.where(adopt, Dn, D), torch.where(adopt, Sn, S)
            A, cc = A | better, torch.where(adopt, cn, cc)
    Ap, Sp, Dp = ag._sh_r(A, 1, False), ag._sh_r(S, 1, False), \
        ag._sh_r(D, 1, 0)
    sw = A & Ap & ((D != Dp) | (S != Sp))
    gather(S, D, A, flags=True)
    gather(Sp, Dp, sw, flags=True)
    # A block's query codes are one aligned sector of its query's row.
    qsec = q_rows.long().reshape(N, 1) * NBF + torch.arange(NBF, device=dev)
    reads['q'].append(qsec[A | sw])
    sectors = sum(len(torch.unique(torch.cat(v))) for v in reads.values()
                  if v)
    blocks = N * NBF
    return 32 * sectors + 10 * blocks + 2 * blocks * 32 + 13 * blocks


def k5_alone(torch, ag, el, args, g3, at: str) -> dict:
    """K5 alone on one dispatch's stage-4 results, against its plain
    version on the same tensors: error, ms, device_ms, plain_ms, bound.
    args: (b, r_rows, rlens, q_rows, g1, g2)."""
    def run(fn):
        return fn(el, *args, g3)
    got, want = run(ag._propagate_v3), run(ag.propagate_v3_plain)
    torch.cuda.synchronize()
    err = max(int((g.int() - w.int()).abs().max()) for g, w in zip(got, want))
    if err or any(g.dtype != w.dtype for g, w in zip(got, want)):
        fail(f'K5 != plain at {at} (max abs err {err})')
    del got, want
    nbytes = k5_bytes(torch, ag, el, args, g3)
    return with_shares(dict(
        name='_propagate_v3', route='cuda',
        source='vclust_tpu_torch/csrc/align_v3.cu',
        replaces='vclust_tpu/ops/align_tpu.py:1235', design=K5_DESIGN,
        max_abs_err=err, ms=time_ms(lambda: run(ag._propagate_v3), 5),
        **device_ms_item(lambda: run(ag._propagate_v3), 5),
        plain_ms=time_ms(lambda: run(ag.propagate_v3_plain), 3),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by='bytes',
        library_ms=None, library=NO_LIBRARY['_propagate_v3'], at=at,
        bytes=nbytes))


def k2_k3_alone(torch, dev, ag, b, codes, seed: int, kb: int):
    """K2 and K3 alone on one full dispatch at bucket `kb` (B rows of K
    queries from the path's arena `b`), each against its plain version,
    with ms, device_ms, plain_ms, bound and (K2) library_ms. Returns the
    two rows and the dispatch's inputs."""
    import numpy as np
    g3 = ag._v3_geom(kb, kb)
    K = ag.K_QUERIES
    B = ag._dispatch_rows(kb, K, dev, False)
    rng = np.random.default_rng(seed)
    long_ = [g for g in b['rows'] if ag._pad_bucket(len(codes[g])) == kb]
    refs = [long_[w % len(long_)] for w in range(B)]
    r_rows = torch.tensor([b['rows'][g] for g in refs], dtype=torch.int32,
                          device=dev)
    rlens = torch.tensor([len(codes[g]) for g in refs], dtype=torch.int32,
                         device=dev)
    q_rows = torch.from_numpy(rng.integers(
        0, len(b['rows']), (B, K)).astype(np.int32)).to(dev)
    s1 = (b['qocc'], b['rocc'], r_rows, q_rows)
    tasks = B * K
    M2, H = b['qocc'].shape[1:]
    NRB = b['rocc'].shape[1]

    # K2
    got = ag.stage1_pack(*s1)
    want = ag.stage1_pack_plain(*s1)
    torch.cuda.synchronize()
    k2_err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    if k2_err:
        fail(f'K2 != plain at bucket {kb} (max abs err {k2_err})')
    cnt1, g1, cnt2, g2 = ag._stage1_v3(*s1)
    with plain_kernels(ag):
        if not all(torch.equal(x, y) for x, y in zip(
                (cnt1, g1, cnt2, g2), ag._stage1_v3(*s1))):
            fail(f'K2 at bucket {kb}: cnt1, g1, cnt2, g2 != plain')
    k2_ms = time_ms(lambda: ag.stage1_pack(*s1), 5)
    k2_dev = device_ms_item(lambda: ag.stage1_pack(*s1), 5)
    k2_plain = time_ms(lambda: ag.stage1_pack_plain(*s1), 1)
    ops = 2.0 * tasks * M2 * NRB * H
    # The arena rows the dispatch reads, each once, and the three outputs.
    nbytes = (len(torch.unique(q_rows)) * M2 * H
              + len(torch.unique(r_rows)) * NRB * H
              + 3 * tasks * (M2 // 2) * 4)
    t_ops = ops / INT8_TENSOR_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    k2 = dict(name='stage1_pack', route='cuda',
              source='vclust_tpu_torch/csrc/align_v3.cu',
              replaces='vclust_tpu/ops/align_tpu.py:1108', design=K2_DESIGN,
              max_abs_err=k2_err, ms=k2_ms, **k2_dev,
              plain_ms=k2_plain, bound_ms=max(t_ops, t_bytes),
              bound_by='operations' if t_ops >= t_bytes else 'bytes',
              library_ms=k2_library_ms(torch, *s1),
              at=f'bucket {kb}: B={B} rows x K={K}, 2*NQB={M2}, NRB={NRB}, '
                 f'H={H}', int8_ops=ops)

    # K3: stages 2-4 on the rows in place, against bands_v3_plain (stage 2's
    # windows, the band counts, the election).
    k3_args = (b, r_rows, rlens, q_rows, cnt1, g1, cnt2, g2, ag.V3_TBAND,
               ag.V3_SMIN, g3)
    got = ag._bands_v3(*k3_args)
    want = ag.bands_v3_plain(*k3_args)
    torch.cuda.synchronize()
    outs = ('cnt', 'cnt_best', 'A', 'S', 'D')
    k3_err = max(int((got[k].int() - want[k].int()).abs().max())
                 for k in outs)
    if k3_err or any(got[k].dtype != want[k].dtype for k in outs):
        fail(f'K3 != plain at bucket {kb} (max abs err {k3_err})')
    del got, want
    k3_ms = time_ms(lambda: ag._bands_v3(*k3_args), 5)
    k3_dev = device_ms_item(lambda: ag._bands_v3(*k3_args), 5)
    k3_plain = time_ms(lambda: ag.bands_v3_plain(*k3_args), 1)
    n = tasks * (kb // ag.FINE)
    band = g3['BAND']
    # Operations: k3_slots. Bytes: the distinct wide rows and the queries'
    # codes read once, stage 1's four (tasks, NQB) int32 read, the counts
    # and the election (cnt_best, D, A, S: 10 bytes a fine block) written.
    ops = k3_slots(torch, b, r_rows, rlens, q_rows, g1, g2, g3)
    nbytes = (v3_row_bytes(torch, r_rows, rlens, g1, g2, g3)
              + len(torch.unique(q_rows)) * kb + 16 * tasks * g3['NQB']
              + len(ag.BAND_TAGS) * n * band + 10 * n)
    t_ops = ops / INT32_SLOTS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    k3 = with_shares(dict(
        name='_bands_v3', route='cuda',
        source='vclust_tpu_torch/csrc/align_v3.cu',
        replaces='vclust_tpu/ops/align_tpu.py:1162', design=K3_DESIGN,
        max_abs_err=k3_err, ms=k3_ms, **k3_dev, plain_ms=k3_plain,
        bound_ms=max(t_ops, t_bytes),
        bound_by='operations' if t_ops >= t_bytes else 'bytes',
        library_ms=None,
        at=f'bucket {kb}: B={B} rows x K={K}, {n} fine blocks x 4 bands x '
           f'{band} shifts',
        int32_slots=ops, bytes=nbytes, bound_bytes_ms=t_bytes))
    return k2, k3, (s1, rlens, (cnt1, g1, cnt2, g2), B, K, g3)


def k5_k4_alone(torch, ag, b, inputs, kb: int):
    """K5 alone on the stage-4 results of one dispatch at bucket `kb` (the
    inputs k2_k3_alone returns) and K4 alone on K5's outputs, without and
    with records, each against its plain version (k5_alone, k4_alone)."""
    s1, rlens, (cnt1, g1, cnt2, g2), B, K, g3 = inputs
    r_rows, q_rows = s1[2:]
    N = B * K
    at = f'bucket {kb}: B={B} rows x K={K}, NBF={kb // ag.FINE}'
    p = ag.AlignParams()
    el = ag._bands_v3(b, r_rows, rlens, q_rows, cnt1, g1, cnt2, g2,
                      ag.V3_TBAND, ag.V3_SMIN, g3)
    args = (b, r_rows, rlens, q_rows, g1, g2)
    k5 = k5_alone(torch, ag, el, args, g3, at)
    flat = [x.reshape((N,) + x.shape[2:])
            for x in ag._propagate_v3(el, *args, g3)]
    del el
    rl = rlens[:, None].expand(B, K).reshape(N)
    k4 = k4_alone(torch, ag, flat, rl, kb,
                  dict(mqd=p.mqd, mrd=p.mrd, reg=p.reg), at)
    return k5, k4


def peak_bytes(torch, fn) -> int:
    """Device bytes one call of fn holds at its peak above those allocated
    before it (torch.cuda.max_memory_allocated)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def align_v3_dispatch(torch, dev, ag, idx, codes, seed: int, kb=65536):
    """K2 and K3 alone on one full dispatch at bucket `kb` (k2_k3_alone);
    K5 alone on its stage-4 results and K4 alone on its stage-5-6 results
    (without and with records), each against its plain version
    (k5_k4_alone); then the time of each stage of that dispatch, and the
    row core's time and peak bytes."""
    b = idx.bucket[(kb, 'v3')]
    k2, k3, inputs = k2_k3_alone(torch, dev, ag, b, codes, seed, kb)
    s1, rlens, (cnt1, g1, cnt2, g2), B, K, g3 = inputs
    r_rows, q_rows = s1[2:]
    at = f'bucket {kb}: B={B} rows x K={K}, NBF={kb // ag.FINE}'
    k5, k4 = k5_k4_alone(torch, ag, b, inputs, kb)
    p = ag.AlignParams()
    kw = dict(mqd=p.mqd, mrd=p.mrd, reg=p.reg)
    tb, sm = ag.V3_TBAND, ag.V3_SMIN

    def row_core(**extra):
        return lambda: ag._row_core_v3(b, r_rows, rlens, q_rows, tb, sm,
                                       Lq=kb, Lr=kb, K=K, **kw, **extra)

    stages = dict(
        stage1_ms=time_ms(lambda: ag._stage1_v3(*s1), 3),
        bands_ms=time_ms(lambda: ag._bands_v3(
            b, r_rows, rlens, q_rows, cnt1, g1, cnt2, g2, tb, sm, g3), 3),
        propagate_ms=k5['ms'], propagate_plain_ms=k5['plain_ms'],
        back_half_ms=k4['aggregates']['ms'],
        back_half_records_ms=k4['records']['ms'],
        back_half_plain_ms=k4['aggregates']['plain_ms'],
        back_half_records_plain_ms=k4['records']['plain_ms'],
        row_core_ms=time_ms(row_core(), 3),
        row_core_records_ms=time_ms(row_core(with_alns=True), 3),
        row_core_peak_bytes=peak_bytes(torch, row_core()))
    with plain_kernels(ag):
        stages['row_core_plain_ms'] = time_ms(row_core(), 3)
    emit(dict(phase='align_v3_dispatch', bucket=kb, rows=B, K=K,
              k2=k2, k3=k3, k4=k4, k5=k5, stages=stages))
    k4_row = dict(
        name='_blocks_to_measures', route='cuda',
        source='vclust_tpu_torch/csrc/back_half.cu',
        replaces='vclust_tpu/ops/align_tpu.py:454', design=K4_DESIGN,
        **{k: k4['aggregates'].get(k) for k in (
            'max_abs_err', 'ms', 'device_ms', 'plain_ms', 'bound_ms',
            'bound_by', 'bound_bytes_ms', 'bound_ops_ms', 'share_of_bound',
            'host_ms')},
        library_ms=None, library=NO_LIBRARY['_blocks_to_measures'], at=at,
        with_records=k4['records'])
    k4_row['max_abs_err'] = max(k4_row['max_abs_err'],
                                k4['records']['max_abs_err'])
    return k2, k3, k4_row, k5


def v2_row(alone: dict, replaces_design) -> dict:
    """A kernels-line row of K8, K6 or K7 from its v2_alone result; its
    launches are those of its wrapper (K8's are K6's: one kernel)."""
    replaces, design = replaces_design
    row = dict(alone, route='cuda',
               source='vclust_tpu_torch/csrc/align_v2.cu',
               replaces=replaces, design=design)
    row.pop('bytes', None)
    return row


def k2_library_ms(torch, qocc, rocc, r_rows, q_rows) -> float:
    """Yardstick only, never called by the port: bf16 torch.matmul over
    the same chunks of 512 reference blocks plus torch packed maxes, with
    the reduced-precision bf16 reduction off (counts <= 64 are exact in
    bf16). Operand building is not timed."""
    qf = qocc[q_rows.long()].to(torch.bfloat16)
    NRB = rocc.shape[1]
    chunks = [(lo, rocc[r_rows.long(), lo:lo + 512].to(
        torch.bfloat16).transpose(1, 2)[:, None].contiguous())
        for lo in range(0, NRB, 512)]

    def run():
        outs = None
        for lo, rf in chunks:
            Mc = torch.matmul(qf, rf).to(torch.int32)
            Ma, Mb = Mc[:, :, 0::2], Mc[:, :, 1::2]
            rr = torch.arange(lo, lo + Mc.shape[-1], dtype=torch.int32,
                              device=Mc.device)
            part = [(((Ma + Mb) << 13) | rr).amax(-1),
                    ((Ma << 13) | rr).amax(-1), ((Mb << 13) | rr).amax(-1)]
            outs = part if outs is None else [
                torch.maximum(x, y) for x, y in zip(outs, part)]
        return outs

    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return time_ms(run, 3)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            prev


def phase_align_v3(torch, dev, seed: int, engine: dict):
    """Phases align_v3 and align_hybrid. The `launches` of K9, K10, K2, K3,
    K5, K4, K8 (fused into K6: K6's), K6 and K7 are those of the CLI engine
    path (phase align_engine); the other paths' are beside them. Returns
    their nine rows (K9 on genomes48's arena of 65,536; K10, K8, K6 and K7
    timed on the hybrid's v2 dispatch at 65,536)."""
    from vclust_tpu_torch.ops import align_gpu as ag
    res48, codes, pairs, idx, out = align_v3_corpus(
        torch, dev, 'genomes48', mutant_corpus(), ag)
    res48.update(cpu_reference_check(dev, ag, codes, pairs, out))
    res48.update(native_dtani(codes, pairs, out))
    emit(res48)
    k2, k3, k4, k5 = align_v3_dispatch(torch, dev, ag, idx, codes, seed)
    hybrid = phase_align_hybrid(torch, dev, ag, idx, codes, pairs, out,
                                seed)
    k4['at_v2'] = hybrid['v2_dispatch']['k4']
    k4['max_abs_err'] = max(k4['max_abs_err'], *(
        k4['at_v2'][v]['max_abs_err'] for v in ('aggregates', 'records')))
    del idx
    res_c, c_codes, _, c_idx, _ = align_v3_corpus(
        torch, dev, 'contigs128', contig_corpus(), ag)
    emit(res_c)
    # K2 and K3 alone at bucket 4,096 (K2's 64 x 128 tile); K5 and K4
    # alone on that dispatch's stage-4 results (many short pairs).
    b4 = c_idx.bucket[(4096, 'v3')]
    k2s, k3s, inputs = k2_k3_alone(torch, dev, ag, b4, c_codes, seed, 4096)
    k5s, k4s = k5_k4_alone(torch, ag, b4, inputs, 4096)
    del inputs
    emit(dict(phase='align_v3_dispatch', bucket=4096, k2=k2s, k3=k3s,
              k4=k4s, k5=k5s))
    del c_idx, b4
    keys = ('at', 'max_abs_err', 'ms', 'device_ms', 'plain_ms', 'bound_ms',
            'bound_by', 'library_ms', 'share_of_bound', 'host_ms')
    for row, at in ((k2, k2s), (k3, k3s), (k5, k5s)):
        row['max_abs_err'] = max(row['max_abs_err'], at['max_abs_err'])
        row['at_4096'] = {key: at.get(key) for key in keys}
    k4['at_4096'] = k4s
    k4['max_abs_err'] = max(k4['max_abs_err'], *(
        k4s[v]['max_abs_err'] for v in ('aggregates', 'records')))
    v2d = hybrid['v2_dispatch']
    v2_rows = tuple(v2_row(v2d[k], src) for k, src in (
        ('k8', ('vclust_tpu/ops/align_tpu.py:296', K8_DESIGN)),
        ('k6', ('vclust_tpu/ops/align_tpu.py:355', K6_DESIGN)),
        ('k7', ('vclust_tpu/ops/align_tpu.py:653', K7_DESIGN))))
    # K9 alone on genomes48's arena of 65,536; its other arenas beside.
    k9 = dict(res48['k9'][65536], name='index_v3',
              wrapper='_index_block_v3', route='cuda',
              source='vclust_tpu_torch/csrc/index.cu',
              replaces='vclust_tpu/ops/align_tpu.py:1040', design=K9_DESIGN,
              library_ms=None,
              library='none: no PyTorch call builds the occupancies (the '
                      'plain version is a zero fill, an index_put of one '
                      'byte a position and unfold copies)')
    k9['other_arenas'] = {r['at']: {key: r.get(key) for key in keys}
                          for res in (res48, res_c)
                          for kb, r in res['k9'].items()
                          if res is res_c or kb != 65536}
    k10 = dict(v2d['index'], route='cuda',
               source='vclust_tpu_torch/csrc/index.cu',
               replaces='vclust_tpu/ops/align_tpu.py:748',
               design=K10_DESIGN)
    rows = (k9, k10, k2, k3, k5, k4) + v2_rows
    for row in rows:
        key = row.get('wrapper', row['name'])
        row['launches'] = engine['path_launches'][key]
        row['launches_by_path'] = {
            'align --engine gpu (example, 66 pairs)':
                engine['path_launches'][key],
            'align_v3 genomes48 (index)': res48['index_launches'][key],
            'align_v3 genomes48': res48['path_launches'][key],
            'align_v3 contigs128 (index)': res_c['index_launches'][key],
            'align_v3 contigs128': res_c['path_launches'][key],
            'align_hybrid genomes48': hybrid['path_launches'][key]}
    return rows


# --------------------------------------------------------------------------
# Phase 6: the device align engine from the CLI
# --------------------------------------------------------------------------

# tests/test_align_tpu.py:24-33: simulated truth of the example's mutants.
TRUE_TANI = {
    ('NC_010807', 'NC_010807.alt1'): 0.99753,
    ('NC_010807', 'NC_010807.alt2'): 0.98985,
    ('NC_010807', 'NC_010807.alt3'): 0.98414,
    ('NC_005091', 'NC_005091.alt1'): 0.97161,
    ('NC_005091', 'NC_005091.alt2'): 0.96707,
    ('NC_025457', 'NC_025457.alt1'): 0.80607,
    ('NC_025457', 'NC_025457.alt2'): 0.75921,
    ('NC_002486', 'NC_002486.alt'): 1.00000,
}


@contextlib.contextmanager
def pipe_timer(ag):
    """Inside: every `_all2all_single` call (each returns host arrays, so
    its wall time holds its device work) adds its seconds, calls and pairs
    to the yielded {'v3': ..., 'v2': ...} by pipe, every row core call one
    dispatch to its pipe, and every chunk of genomes an arena build of
    the pipe writes (`GenomeIndex._build`) one index chunk, each build
    that wrote any its seconds to index_s (to the card's end: the
    wrapper synchronises after it)."""
    import torch
    stats = {p: dict(s=0.0, calls=0, pairs=0, dispatches=0,
                     index_chunks=0, index_s=0.0) for p in ('v3', 'v2')}
    real = ag._all2all_single
    cores = {'v3': ag._row_core_v3, 'v2': ag._row_core}
    real_build = ag.GenomeIndex._build

    def build(self, key, gids, cache, names, index_fn, empty_fn):
        pipe = 'v3' if key[1] == 'v3' else 'v2'

        def chunk(*args, **kw):
            stats[pipe]['index_chunks'] += 1
            return index_fn(*args, **kw)
        chunks = stats[pipe]['index_chunks']
        t0 = time.perf_counter()
        d = real_build(self, key, gids, cache, names, chunk, empty_fn)
        if stats[pipe]['index_chunks'] > chunks:
            torch.cuda.synchronize()
            stats[pipe]['index_s'] += time.perf_counter() - t0
        return d

    def counted(pipe):
        def core(*args, **kw):
            stats[pipe]['dispatches'] += 1
            return cores[pipe](*args, **kw)
        return core

    def timed(codes, pairs, params=None, index=None, keep_alignments=False,
              seeds_per_block=None, pipe='v2', device=None, mesh=None):
        t0 = time.perf_counter()
        out = real(codes, pairs, params, index, keep_alignments,
                   seeds_per_block, pipe, device, mesh)
        st = stats[pipe]
        st['s'] += time.perf_counter() - t0
        st['calls'] += 1
        st['pairs'] += len(pairs)
        return out

    ag._all2all_single = timed
    ag._row_core_v3, ag._row_core = counted('v3'), counted('v2')
    ag.GenomeIndex._build = build
    try:
        yield stats
    finally:
        ag._all2all_single = real
        ag._row_core_v3, ag._row_core = cores['v3'], cores['v2']
        ag.GenomeIndex._build = real_build


def engine_run(ag, out: pathlib.Path, *extra):
    """`align --engine gpu` of example/multifasta.fna into out/ani.tsv
    (with `extra` arguments), K2, K3, K5 and K4 counted from 0 around it,
    each held to the dispatches of its pipes. Returns (wall seconds,
    launches, pipe stats)."""
    from vclust_tpu_torch.utils.data import example_dir
    out.mkdir()
    zero_align_launches(ag)
    with pipe_timer(ag) as st:
        t0 = time.perf_counter()
        cli('align', '-i', example_dir() / 'multifasta.fna', '-o',
            out / 'ani.tsv', '--engine', 'gpu', '-v', '0', *extra)
        wall = time.perf_counter() - t0
    launches = align_launches(ag)
    check_align_launches('align --engine gpu', launches, st)
    if not st['v3']['index_chunks'] or \
            bool(st['v2']['dispatches']) != bool(st['v2']['index_chunks']):
        fail(f'align --engine gpu: index chunks {st} (each pipe that ran '
             f'builds its arenas)')
    return wall, launches, st


def split_seconds(wall, st) -> dict:
    v3, v2 = st['v3']['s'], st['v2']['s']
    return dict(wall_s=wall, v3_s=v3, v2_s=v2, host_s=wall - v3 - v2,
                v3_index_s=st['v3']['index_s'],
                v2_index_s=st['v2']['index_s'],
                v2_pairs=st['v2']['pairs'],
                dispatches={p: st[p]['dispatches'] for p in st})


def phase_align_engine(torch, work: pathlib.Path):
    from vclust_tpu_torch.ops import align_gpu as ag
    from vclust_tpu_torch.utils.data import example_dir
    gold = REPO / 'tests' / 'golden_torch' / 'engine_tpu'
    names = ('ani.tsv', 'ani.ids.tsv', 'ani.aln.tsv')

    # The path, counted from 0.
    cold = work / 'engine_cold'
    wall, launches, st = engine_run(ag, cold, '--out-aln',
                                    cold / 'ani.aln.tsv')
    for name in names:
        if (cold / name).read_bytes() != (gold / name).read_bytes():
            fail(f'align --engine gpu: {name} != the JAX --engine tpu '
                 f'golden')
    first = split_seconds(wall, st)
    n_pairs = 66
    if st['v3']['pairs'] != n_pairs:
        fail(f'align --engine gpu ran {st["v3"]["pairs"]} pairs on v3')

    warm = work / 'engine_warm'
    wall, _, st = engine_run(ag, warm, '--out-aln', warm / 'ani.aln.tsv')
    for name in names:
        if (warm / name).read_bytes() != (cold / name).read_bytes():
            fail(f'align --engine gpu: {name} differs between runs')
    warm_split = split_seconds(wall, st)

    # The workflow of tests/test_workflow.py:45-69 on the card.
    filt = work / 'engine_filter'
    ex = example_dir()
    engine_run(ag, filt, '--filter', ex / 'output' / 'fltr.txt',
               '--filter-threshold', '0.7')
    cli('cluster', '-i', filt / 'ani.tsv', '--ids', filt / 'ani.ids.tsv',
        '-o', filt / 'clusters.tsv', '--metric', 'tani', '--tani', '0.95',
        '-v', '0')
    if (filt / 'clusters.tsv').read_bytes() != \
            (ex / 'output' / 'clusters.tsv').read_bytes():
        fail('align --engine gpu --filter, cluster: clusters.tsv != '
             'example/output/clusters.tsv')

    lines = (cold / 'ani.tsv').read_text().splitlines()
    head = lines[0].split('\t')
    tani = {}
    for ln in lines[1:]:
        f = dict(zip(head, ln.split('\t')))
        tani[(f['query'], f['reference'])] = float(f['tani'])
    truth = {}
    for (a, b), t in TRUE_TANI.items():
        got = tani.get((a, b), tani.get((b, a)))
        truth[f'{a}~{b}'] = [got, t, None if got is None else got - t]
    res = dict(phase='align_engine', pairs=n_pairs, path_launches=launches,
               files_eq_golden=list(names), clusters_eq_golden=True,
               hard_pairs_v2=first['v2_pairs'], first=first, warm=warm_split,
               warm_pairs_per_s=n_pairs / (warm_split['v3_s']
                                           + warm_split['v2_s']),
               warm_cli_pairs_per_s=n_pairs / warm_split['wall_s'],
               truth_tani=truth,
               max_abs_dtani_truth=max(abs(v[2]) for v in truth.values()))
    emit(res)
    return res


# --------------------------------------------------------------------------
# Phase 8: the hybrid on the 48 genomes; v2 dispatch stages
# --------------------------------------------------------------------------

K8_DESIGN = ('fused into K6 (one launch; this row is its votes output, '
             'the debug path\'s): a CTA a run of (query, coarse block) '
             'items of one reference row, a directory of each strand\'s '
             'sorted seed values staged in shared memory (every s-th, '
             's >= 4, at most 16,384 in 16 bits, as a breadth-first search '
             'tree), a branch-free descent a seed and strand, the segment '
             'between two samples by 16-byte loads, pk1 read only at the '
             'end of the run of equal values (pk2 never); a lane\'s '
             'searches interleaved')
K6_DESIGN = ('the seeds of a v2 dispatch in, the election out: a warp an '
             'item, lanes 8q .. 8q + 7 fine block q\'s seeds and votes in '
             'registers (4, 8 or 16 a lane), an in-lane network, shuffle '
             'merges over lanes 1, 2, 4 (each fine block) and 8, 16 (the '
             'coarse block), window counts from the next lanes by '
             'shuffles, the coarse sample at registers 0, 4, ..., packed '
             'maxes by shuffles; the votes never reach device memory')
K7_DESIGN = ('K5\'s tiles, of 64 blocks with a halo of EXT_ITERS, the warps '
             'of one wave of CTAs taking tiles in turn; each assigned '
             'block\'s mask at its own state, then, before every step from '
             'the block before, the masks at both neighbours\' states (a '
             'run of one state once) that the table lacks, listed over the '
             'warp by ballots and evaluated 32 at a time; a mask from the '
             'window\'s 2-3 aligned 16-byte pieces, a byte compare as a '
             'carry-free add, bits transposed so a flag word is a shift and '
             'a mask; the table c-major in shared memory; two steps without '
             'an adoption end the steps')


# Int32 issue slots of the least work of K6 on a fine block of 4C votes
# (fine) and a coarse block of 16C (coarse), given sorted lists can be
# merged: the sort, n log2 n compare-selects (fine), the merge of 4 runs
# (2 a vote); the window and equal counts by two moving pointers (4 a vote
# of the list elected on), the exact votes and the support (2 a vote
# counted).
def k6_slots(C: int) -> tuple:
    import math
    c4 = 4 * C
    fine = c4 * math.ceil(math.log2(c4)) + 4 * c4 + 2 * c4 + 2 * c4
    coarse = 2 * 4 * c4 + 4 * c4 + 2 * 4 * c4
    return fine, coarse


def v2_alone(torch, name, run, plain, nbytes, slots, at, **extra):
    """Kernel `name` alone (run) against its plain version on the same
    tensors, every output: error, ms, device_ms, host_ms, plain_ms and the
    bound (least bytes over the memory rate, or `slots` int32 issue slots
    over the int32 rate, the larger)."""
    got, want = run(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if any(g.shape != w.shape or g.dtype != w.dtype
           for g, w in zip(got, want)):
        fail(f'{name} at {at}: shapes or types differ from plain')
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    if err:
        fail(f'{name} != plain at {at} (max abs err {err})')
    del got, want
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = slots / INT32_SLOTS_PER_S * 1e3
    return with_shares(dict(
        name=name, max_abs_err=err, ms=time_ms(run, 5),
        **device_ms_item(run, 5), plain_ms=time_ms(plain, 2),
        bound_ms=max(t_bytes, t_ops),
        bound_by='bytes' if t_bytes >= t_ops else 'operations',
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops, bytes=nbytes,
        int32_slots=slots, at=at, **extra))


def k7_least(torch, b, r_rows, q_rows, kb) -> tuple:
    """K7's least bytes and int32 slots on one v2 dispatch: the election
    read (6 bytes a block), each distinct query's codes and each distinct
    reference's bases of both strands read once (32 a window row: row r + 1
    holds bases [32 r, 32 r + 64), so each row adds 32 to the one before),
    the flags (a byte a query position each) and the states (13 bytes a
    block) written; the final masks 6 slots a word of 4 positions."""
    R, K = q_rows.shape
    N, NBF = R * K, kb // 32
    NRT = b['r2dov'].shape[1] // 2
    n_q, n_ref = len(torch.unique(q_rows)), len(torch.unique(r_rows))
    nbytes = (N * NBF * 6 + n_q * kb + n_ref * 2 * NRT * 32 + 2 * N * kb
              + N * NBF * 13)
    return nbytes, N * NBF * 8 * 6


def v2_front_end_alone(torch, ag, b, r_rows, rlens, q_rows, qlens, kb, C,
                       at):
    """K6 (K8 fused in) and K7 alone on one v2 dispatch, each against its
    plain version on the same inputs (v2_alone): K6's election against the
    plain pair (row k6), and the same launch with its votes output against
    votes_v2_plain (row k8). The library_ms of both is one
    torch.searchsorted over the same rows and values (both strands), timed
    in the same call."""
    R, K = q_rows.shape
    N, NBF = R * K, kb // ag.FINE
    NQ = NBF * C
    kw = dict(Lq=kb, Lr=kb, C=C)
    uq, ur = torch.unique(q_rows).long(), torch.unique(r_rows).long()
    n_q, n_ref = len(uq), len(ur)
    packs = 1 if b['pack_bits'] == 64 else 2
    rr = r_rows.long()
    sv2 = torch.cat([b['sv_f'][rr], b['sv_r'][rr]]).contiguous()
    vals = b['qsv'][q_rows.long()].reshape(R, K * NQ)
    vals2 = torch.cat([vals, vals]).contiguous()
    library = dict(
        library_ms=time_ms(
            lambda: torch.searchsorted(sv2, vals2, right=True), 5),
        library='torch.searchsorted of the seeds\' values in the '
                'references\' sorted values, both strands, one call (the '
                'search alone: no packs, no election)')
    del sv2, vals, vals2
    # Counted on this dispatch's data: a query slot past its genome's end,
    # or in a block of fewer valid seeds, holds no seed (qsv -1), and a
    # reference row's entries past its valid ones are BIG. Each distinct
    # query's seed values (and the valid seeds' offsets) and each distinct
    # reference's valid values and packs (both strands) read once, the
    # election written (10 bytes a fine block; the votes too, 16 bytes a
    # query slot, with the votes output); a search a valid seed and strand
    # over the reference strand's valid entries (a compare-select a
    # level), and K6's least election work (k6_slots) on the fine and
    # coarse blocks that hold a valid seed.
    valid = [(b[k] < ag.BIG).sum(dim=1) for k in ('sv_f', 'sv_r')]
    nbytes = (n_q * NQ * 4 + int((b['qsv'][uq] >= 0).sum()) * 4
              + int(sum(n[ur].sum() for n in valid)) * (4 + 8 * packs)
              + N * NBF * 10)
    seeds = (b['qsv'][q_rows.long()] >= 0).view(R, K, NBF, C)
    levels = sum(torch.ceil(torch.log2(n[rr].double() + 1))
                 for n in valid)
    fine, coarse = k6_slots(C)
    slots = (2 * int((seeds.sum(dim=(1, 2, 3)).double() * levels).sum())
             + int(seeds.any(dim=3).sum()) * fine
             + int(seeds.view(R, K, NBF // 4, 4 * C).any(dim=3).sum())
             * coarse)
    k6 = v2_alone(
        torch, '_votes_elect_v2',
        lambda: ag._votes_elect_v2(b, r_rows, q_rows, **kw)[:4],
        lambda: ag.votes_elect_v2_plain(b, r_rows, q_rows, **kw)[:4],
        nbytes, slots, at, **library)
    k8 = v2_alone(
        torch, '_votes_elect_v2 votes output',
        lambda: ag._votes_elect_v2(b, r_rows, q_rows, want_votes=True,
                                   **kw)[4],
        lambda: ag.votes_v2_plain(b, r_rows, q_rows, **kw),
        nbytes + N * NQ * 16, slots, at, wrapper='_votes_elect_v2',
        **library)
    A, S, D = ag._votes_elect_v2(b, r_rows, q_rows, **kw)[:3]
    args = (b, r_rows, rlens, q_rows, qlens, A, S, D)
    k7 = v2_alone(
        torch, '_propagate_v2', lambda: ag._propagate_v2(*args, Lr=kb),
        lambda: ag.propagate_v2_plain(*args, Lr=kb),
        *k7_least(torch, b, r_rows, q_rows, kb), at, library_ms=None,
        library='none: no PyTorch call computes the neighbour adoption '
                '(its plain version is ~20 torch ops a step)')
    return k8, k6, k7


K10_DESIGN = ('(genome, strand) rows a group at a time (at most 128 MiB '
              'of items), three launches at k <= 4 and four at k = 8: the '
              'selection, a CTA 64 fine blocks of a row, 8 a warp, '
              'its (hash, offset) keys sorted by a bitonic network over the '
              'warp, lanes r < C writing slot r, both passes\' digits '
              'counted in shared memory and added to the row\'s totals once '
              'a CTA and digit; a stable LSD radix of 8-bit digits, a launch '
              'a pass, a CTA a (row, tile of 4,096) taken by ticket: items '
              'ranked by ballots (digit peers) and per-warp counts, the '
              'tile\'s digit counts published, the tiles before found by a '
              'decoupled look-back (epoch-tagged words), the items staged '
              'by digit in shared memory and stored in runs; 4-byte items '
              'up to bucket 65,536; the packs from the sorted items; the '
              'window rows as 16-byte copies')


def v2_index_build(torch, ag, b, codes, kb, C) -> dict:
    """K10 on the arena's genomes (bucket kb, C seeds a block) == the arena
    (built by K10 through GenomeIndex) == index_block_plain on the same
    codes, key by key (the plain version launching nothing); its ms,
    device_ms, plain_ms, bytes bound (both strands' codes read once, the
    index written once) and library_ms: torch.sort(stable=True) of the
    same rows' keys (the selected values of both strands, BIG where
    invalid; the sort alone, no selection and no packs)."""
    fwd = b['fwd']
    G = fwd.shape[0]
    rc = arena_rc(torch, b, codes, kb)
    pb = b['pack_bits']
    at = f'v2 index, bucket {kb}: {G} genomes, C={C}, {pb}-bit packs'

    def run():
        return ag._index_block(fwd, rc, ag.SEED_K, pb, C)

    def plain():
        return ag.index_block_plain(fwd, rc, ag.SEED_K, pb, C)

    keys = ag._V2_KEYS
    same_arena(at, run(), [b[k] for k in keys], keys)
    with no_launches(ag, at):
        same_arena(at, [b[k] for k in keys], plain(), keys)
        plain_ms = time_ms(plain, 2)
        # The reverse strand's selected values: the plain version's qsv
        # of the reverse codes.
        sel_r = ag.index_block_plain(rc, rc, ag.SEED_K, pb, C)[0]
    keys_rows = torch.cat([torch.where(x < 0, ag.BIG, x)
                           for x in (b['qsv'], sel_r)]).contiguous()
    del sel_r
    library_ms = time_ms(lambda: torch.sort(keys_rows, dim=1, stable=True),
                         5)
    del keys_rows
    NQ = kb // ag.FINE * C
    # qsv, qoff, sv_f, sv_r (int32); the packs (int64: four arrays, or
    # two where pk2 is pk1); the window rows (int8).
    nbytes = (2 * G * kb + G * NQ * (16 + 8 * (4 if pb == 32 else 2))
              + b['r2dov'].numel())
    return with_shares(dict(
        name='index_v2', wrapper='_index_block', genomes=G, bucket=kb, C=C,
        pack_bits=pb, max_abs_err=0, ms=time_ms(run, 3),
        **device_ms_item(run, 3),
        profile=profile_breakdown(
            torch, run, 6, warm=True,
            expect=('index_v2_select', 'index_v2_pass', 'index_v2_pack')),
        plain_ms=plain_ms,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by='bytes',
        bytes=nbytes, library_ms=library_ms,
        library='torch.sort(stable=True) of the rows\' keys (both '
                'strands\' selected values, BIG where invalid): the sort '
                'alone', at=at))


def v2_dispatch(torch, dev, ag, b, codes, kb, seed, C=None, kernels=True):
    """One v2 dispatch at bucket `kb` (B rows of K = 8 queries from the
    arena `b`): K6 (K8 fused in) and K7 alone against their plain versions
    and the bucket's index build (v2_front_end_alone, v2_index_build, with
    `kernels`), each stage's event time (K4 alone against its plain
    version, k4_alone), its bytes bound and the live bytes of the dispatch
    at 1 and 2 rows (their difference a row), without and with
    records."""
    import numpy as np
    C = C or ag.SEEDS_PER_BLOCK
    K = ag.K_QUERIES
    B = ag._dispatch_rows_v2(kb, K, False)
    rng = np.random.default_rng(seed)
    gids = sorted(b['rows'])
    refs = [gids[w % len(gids)] for w in range(B)]

    def put(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    r_rows = put([b['rows'][g] for g in refs])
    rlens = put([len(codes[g]) for g in refs])
    qg = rng.choice(gids, (B, K))
    q_rows = put([[b['rows'][g] for g in row] for row in qg])
    qlens = put([[len(codes[g]) for g in row] for row in qg])
    p = ag.AlignParams()
    kw = dict(Lq=kb, Lr=kb, K=K, mqd=p.mqd, mrd=p.mrd, reg=p.reg, C=C)
    at = f'v2 bucket {kb}: B={B} rows x K={K}, C={C}'

    def peak(R, alns=False):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ag._row_core(b, r_rows[:R], rlens[:R], q_rows[:R], qlens[:R],
                     with_alns=alns, **kw)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    front = (v2_front_end_alone(torch, ag, b, r_rows, rlens, q_rows, qlens,
                                kb, C, at) if kernels else None)
    A, S, D = ag._votes_elect_v2(b, r_rows, q_rows, Lq=kb, Lr=kb, C=C)[:3]
    flags = ag._propagate_v2(b, r_rows, rlens, q_rows, qlens, A, S, D, Lr=kb)
    N = B * K
    flat = [x.reshape((N,) + x.shape[2:]) for x in flags]
    rl = rlens[:, None].expand(B, K).reshape(N)
    k4 = k4_alone(torch, ag, flat, rl, kb, dict(mqd=p.mqd, mrd=p.mrd,
                                                reg=p.reg), at)
    stages = dict(
        votes_election_ms=time_ms(lambda: ag._votes_elect_v2(
            b, r_rows, q_rows, Lq=kb, Lr=kb, C=C), 3),
        propagation_ms=time_ms(lambda: ag._propagate_v2(
            b, r_rows, rlens, q_rows, qlens, A, S, D, Lr=kb), 3),
        back_half_ms=k4['aggregates']['ms'],
        back_half_plain_ms=k4['aggregates']['plain_ms'],
        row_core_ms=time_ms(lambda: ag._row_core(
            b, r_rows, rlens, q_rows, qlens, **kw), 3))
    del flags, flat
    with plain_kernels(ag):
        stages['row_core_plain_ms'] = time_ms(lambda: ag._row_core(
            b, r_rows, rlens, q_rows, qlens, **kw), 2)
    # Least bytes of the row core: each distinct reference's sampled
    # values and packs (both strands) and window rows, each distinct
    # query's sampled seeds and codes read once; the aggregates written.
    NQ = kb // ag.FINE * C
    n_ref = len(torch.unique(r_rows))
    n_q = len(torch.unique(q_rows))
    nbytes = (n_ref * (2 * NQ * (4 + 8 + 8) + b['r2dov'][0].numel())
              + n_q * (NQ * 8 + kb) + N * 12)
    one, two = peak(1), peak(2)
    one_r, two_r = peak(1, True), peak(2, True)
    res = dict(bucket=kb, rows=B, K=K, C=C, pack_bits=b['pack_bits'],
               stages=stages, k4=k4,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by='bytes',
               peak_bytes_1_row=one, peak_bytes_2_rows=two,
               bytes_per_row=two - one,
               bytes_per_query_pos=(two - one) / (K * kb),
               model_bytes_per_row=K * kb * ag._V2_BYTES_PER_POS,
               records_peak_bytes_1_row=one_r,
               records_peak_bytes_2_rows=two_r,
               records_bytes_per_query_pos=(two_r - one_r) / (K * kb),
               records_model_bytes_per_row=K * kb
               * ag._V2_BYTES_PER_POS_RECORDS)
    if front:
        res['k8'], res['k6'], res['k7'] = front
        res['index'] = v2_index_build(torch, ag, b, codes, kb, C)
    return res


def phase_align_hybrid(torch, dev, ag, idx, codes, pairs, v3_out, seed):
    """all2all_gpu at its defaults on the 48 genomes (their v3 arenas from
    phase align_v3 reused); the hybrid against v3 alone."""
    import numpy as np
    zero_align_launches(ag)
    with pipe_timer(ag) as st:
        t0 = time.perf_counter()
        out = ag.all2all_gpu(codes, pairs, index=idx)
        first_s = time.perf_counter() - t0
    launches = align_launches(ag)
    check_align_launches('align_hybrid', launches, st)
    if st['v3']['pairs'] != len(pairs):
        fail('align_hybrid: v3 did not run every pair')
    hard = st['v2']['pairs']
    changed = int((out != v3_out).any(axis=1).sum())
    # With records, the kernels against the plain K2, K3, K5 and K4.
    with_recs = ag.all2all_gpu(codes, pairs, index=idx, keep_alignments=True)
    with plain_kernels(ag):
        want = ag.all2all_gpu(codes, pairs, index=idx, keep_alignments=True)
    same_records('align_hybrid', with_recs, want)
    if not np.array_equal(with_recs[0], out):
        fail('align_hybrid: aggregates differ with records')
    walls = {'hybrid': [], 'v3_alone': []}
    cov = ag.V3_RERUN_COV
    for _ in range(3):
        for name in walls:
            ag.V3_RERUN_COV = cov if name == 'hybrid' else 0.0
            try:
                t0 = time.perf_counter()
                got = ag.all2all_gpu(codes, pairs, index=idx)
                walls[name].append(time.perf_counter() - t0)
            finally:
                ag.V3_RERUN_COV = cov
            if not np.array_equal(got, out if name == 'hybrid' else v3_out):
                fail(f'align_hybrid: {name} differs between runs')
    prof = profile_breakdown(torch, lambda: ag.all2all_gpu(codes, pairs,
                                                           index=idx))
    res = dict(phase='align_hybrid', corpus='genomes48', pairs=len(pairs),
               hard_pairs=hard, hard_pairs_changed=changed,
               first_run_s=first_s, warm_s=walls,
               pairs_per_s={k: len(pairs) / min(v) for k, v in walls.items()},
               v2_s_first=st['v2']['s'], v3_s_first=st['v3']['s'],
               dispatches_first={p: st[p]['dispatches'] for p in st},
               path_launches=launches, records=int(len(with_recs[1][0])),
               kernels_eq_plain=True, profile=prof)
    res.update(native_dtani(codes, pairs, out))
    kb = 65536
    res['v2_dispatch'] = v2_dispatch(torch, dev, ag,
                                     idx.bucket[(kb, ag.SEEDS_PER_BLOCK)],
                                     codes, kb, seed)
    emit(res)
    return res


# --------------------------------------------------------------------------
# Phase 9: the v2 pipe above V3_MAX_BUCKET
# --------------------------------------------------------------------------

# Genomes concatenated from example/multifasta.fna, by ids: 158,076,
# 178,606, 193,520 and 248,724 bases (buckets 196,608 and 262,144).
V2_GENOMES = (
    ('NC_010807', 'NC_010807.alt1', 'NC_010807.alt2', 'NC_010807.alt3'),
    ('NC_005091', 'NC_005091.alt1', 'NC_005091.alt2'),
    ('NC_025457', 'NC_025457.alt1', 'NC_025457.alt2', 'NC_002486'),
    ('NC_002486.alt', 'NC_010807', 'NC_005091', 'NC_025457',
     'NC_025457.alt2'),
)


def v2_corpus():
    """The 4 concatenated genomes and a 5% mutant of each (8 genomes)."""
    import numpy as np
    from vclust_tpu_torch.models.input import Genome, load_genomes
    from vclust_tpu_torch.utils.data import example_path
    genomes, _ = load_genomes(example_path('multifasta.fna'))
    by_name = {g.name: g.seqs[0] for g in genomes}
    rng = np.random.default_rng(1)
    acgt = np.frombuffer(b'ACGT', dtype='S1')
    corpus = []
    for k, names in enumerate(V2_GENOMES):
        s = b''.join(by_name[n] for n in names)
        m = np.frombuffer(s, dtype='S1').copy()
        hit = rng.random(len(m)) < 0.05
        m[hit] = acgt[rng.integers(0, 4, hit.sum())]
        corpus += [Genome(f'cat{k}', [s]), Genome(f'cat{k}.mut', [m.tobytes()])]
    return corpus


def wide_pack_check(dev, ag) -> dict:
    """The v2 election's 64-bit pack, which only a pair of two genomes in
    bucket MAX_TPU_LEN reaches (vote codes above 22 bits; ROADMAP R9): a
    random genome of 950,000 bases and its 5% mutant, the card against the
    CPU, with the native engine's tANI beside it (ROADMAP R10: v2 loses
    alignments from bucket 524,288 up, in the JAX package too)."""
    import numpy as np
    rng = np.random.default_rng(2)
    g = rng.integers(0, 4, 950_000).astype(np.int8)
    m = g.copy()
    hit = rng.random(len(g)) < 0.05
    m[hit] = (m[hit] + rng.integers(1, 4, hit.sum())) % 4
    codes, pair = [g, m], np.array([[0, 1]], np.int32)
    t0 = time.perf_counter()
    card = ag._all2all_single(codes, pair, device=dev, pipe='v2')
    card_s = time.perf_counter() - t0
    cpu = ag._all2all_single(codes, pair, device='cpu', pipe='v2')
    if not np.array_equal(card, cpu):
        fail('align_v2: the card != the CPU at the 64-bit election pack')
    if not card[0, 0] > 0:
        fail('align_v2: nothing elected at the 64-bit election pack')
    nat = native_dtani(codes, pair, card)
    return dict(bucket=ag._pad_bucket(len(g)), seconds=card_s,
                aggregates=card[0].tolist(),
                tani=nat['worst_tani_and_native'][0],
                native_tani=nat['worst_tani_and_native'][1])


def phase_align_v2(torch, dev, seed):
    import numpy as np
    from vclust_tpu_torch.ops import align_gpu as ag
    codes, pairs = align_inputs(v2_corpus())
    lens = [len(c) for c in codes]
    buckets = sorted({max(ag._pad_bucket(lens[i]), ag._pad_bucket(lens[j]))
                      for i, j in pairs.tolist()})
    if buckets[0] <= ag.V3_MAX_BUCKET:
        fail(f'align_v2: buckets {buckets} reach the v3 pipe')
    idx = ag.GenomeIndex(codes, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_align_launches(ag)
    with pipe_timer(ag) as st:
        t0 = time.perf_counter()
        got = ag._all2all_single(codes, pairs, index=idx,
                                 keep_alignments=True, pipe='v2')
        first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = align_launches(ag)
    dispatches = {p: st[p]['dispatches'] for p in st}
    check_align_launches('align_v2', launches, st)
    with plain_kernels(ag):
        want = ag._all2all_single(codes, pairs, index=idx,
                                  keep_alignments=True, pipe='v2')
    same_records('align_v2', got, want)
    out = got[0]
    if out.shape != (len(pairs), 6) or (out < 0).any():
        fail('align_v2: malformed aggregates')
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        agg = ag._all2all_single(codes, pairs, index=idx, pipe='v2')
        walls.append(time.perf_counter() - t0)
    if not np.array_equal(agg, out):
        fail('align_v2: aggregates differ between runs / with records')
    # Two pairs at 262,144 on the card and on the CPU: the longest genome
    # (ids 0) with its mutant (1) and with the next longest (2), which
    # shares two example genomes with it.
    check = np.array([[0, 1], [0, 2]], np.int32)
    rows = [int(np.flatnonzero((pairs == p).all(axis=1))[0]) for p in check]
    card = ag._all2all_single(codes, check, device=dev, keep_alignments=True,
                              pipe='v2')
    cpu = ag._all2all_single(codes, check, device='cpu',
                             keep_alignments=True, pipe='v2')
    if not (np.array_equal(card[0], cpu[0]) and np.array_equal(card[0],
                                                                out[rows])
            and np.array_equal(card[1][1], cpu[1][1])
            and np.array_equal(card[1][0], cpu[1][0])):
        fail('align_v2: the card != the CPU')
    kb = buckets[-1]
    dispatch = v2_dispatch(torch, dev, ag, idx.bucket[(kb,
                                                       ag.SEEDS_PER_BLOCK)],
                           codes, kb, seed)
    # The arena at C = 8 (PHASE1_C), built by one K10 launch.
    before = ag._index_block.launches
    gids = sorted(idx.bucket[(kb, ag.SEEDS_PER_BLOCK)]['rows'])
    b8 = idx.ensure(kb, gids, C=8)
    if ag._index_block.launches != before + 1:
        fail('align_v2: the C = 8 arena was not built by one K10 launch')
    c8 = v2_dispatch(torch, dev, ag, b8, codes, kb, seed, C=8,
                     kernels=False)
    index_c8 = v2_index_build(torch, ag, b8, codes, kb, 8)
    wide = wide_pack_check(dev, ag)
    den = np.array([lens[i] + lens[j] for i, j in pairs.tolist()])
    res = dict(phase='align_v2', genomes=len(codes), lengths=lens,
               pairs=len(pairs), buckets=buckets, pack_bits=sorted(
                   {idx.bucket[k]['pack_bits'] for k in idx.bucket}),
               first_run_s=first_s, warm_s=walls,
               pairs_per_s=len(pairs) / min(walls), peak_mem_gib=peak / 2 ** 30,
               records=int(len(got[1][0])), path_launches=launches,
               dispatches=dispatches, kernels_eq_plain=True,
               tani=((out[:, 1] + out[:, 4]) / den).round(5).tolist(),
               cpu_eq_pairs=check.tolist(),
               cpu_eq_records=int(len(cpu[1][0])), wide_pack=wide,
               dispatch=dispatch, index_c8=index_c8,
               dispatch_c8={k: c8[k] for k in (
                   'rows', 'peak_bytes_1_row', 'peak_bytes_2_rows',
                   'bytes_per_row', 'model_bytes_per_row')})
    emit(res)
    return res


# --------------------------------------------------------------------------
# Phase 10: the mesh paths
# --------------------------------------------------------------------------

def k1_passes_case(torch, dev, at: str, n: int, passes, window=None):
    """K1 on `passes` (of n genomes; `window` (row0, rows) or the n x n
    count) == plain, with its ms, the plain ms and the bound."""
    from vclust_tpu_torch.ops import prefilter as pf
    row0, rows = window or (0, n)
    counts = torch.zeros((rows, n), dtype=torch.int32, device=dev)

    def run_kernel():
        counts.zero_()
        for c in passes:
            pf.occupancy_count(counts, c)

    def run_plain():
        out = torch.zeros_like(counts)
        for c in passes:
            pf.occupancy_count_plain(out, c.gids, c.offs, c.weights,
                                     row0=row0)
        return out

    run_kernel()
    plain = run_plain()
    torch.cuda.synchronize()
    err = int((counts.long() - plain.long()).abs().max())
    if err:
        fail(f'K1 ({at}): kernel != plain (max abs err {err})')
    del plain
    ms = time_ms(run_kernel, 3)
    plain_ms = time_ms(run_plain, 1)
    patterns = sum(int(c.weights.numel()) for c in passes)
    nnz = sum(int(c.gids.numel()) for c in passes)
    # Least bytes: the COO and weights read once, the counts read and
    # written once; least operations: one u8 product a pattern for each
    # distinct entry of the counts (`k1_least_products`).
    nbytes = 4 * (nnz + 2 * patterns + len(passes)) + 8 * rows * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (2.0 * k1_least_products(patterns, n, rows)
             / INT8_TENSOR_OPS_PER_S * 1e3)
    n_limbs = max(c.n_limbs for c in passes)
    return dict(at=f'{at}: {rows} x {n} counts, {patterns} patterns',
                passes=len(passes), items=sum(len(c.work) for c in passes),
                split=sorted({c.split for c in passes}), max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                library_ms=k1_library_ms(torch, dev, n, passes, n_limbs, 3,
                                         window))


def k1_split_ms(torch, dev, index, shards: int) -> float:
    """The time of K1 over `shards` shards of one card, launches only: each
    shard's part of each pass's work list into the card's one n x n counts
    (the sum's trip to the host left out)."""
    from vclust_tpu_torch.ops import prefilter as pf
    n = index.n
    _, chunks = pf.device_chunks(index, dev, shards=shards)
    parts = [pf.k1_split_work(c.work.cpu().numpy(), c.kb_limbs.cpu().numpy(),
                              shards) for c in chunks]
    subs = [pf.k1_shard(c, p[s], dev) for s in range(shards)
            for c, p in zip(chunks, parts) if len(p[s])]
    counts = torch.zeros((n, n), dtype=torch.int32, device=dev)

    def run():
        counts.zero_()
        for c in subs:
            pf.occupancy_count(counts, c)

    return time_ms(run, 2)


def run_workers(devices, shards: int, timeout: float = 300.0) -> list:
    """`python -m vclust_tpu_torch.parallel.worker` in one process a
    device of `devices`, all of one gloo group on localhost, each with
    `shards` shards on its device; returns their stdout lines that start
    with MULTIHOST_OK. Kills them all on the way out."""
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    n_procs = len(devices)
    procs = []
    try:
        for pid, device in enumerate(devices):
            env = dict(os.environ, VCLUST_DIST_COORD=f'127.0.0.1:{port}',
                       VCLUST_DIST_NPROCS=str(n_procs),
                       VCLUST_DIST_PROCID=str(pid), PYTHONPATH=str(REPO))
            procs.append(subprocess.Popen(
                [sys.executable, '-m', 'vclust_tpu_torch.parallel.worker',
                 '--device', device, '--shards', str(shards), '--timeout',
                 str(int(timeout / 2))], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    ok = []
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        line = [ln for ln in out.splitlines()
                if ln.startswith(f'MULTIHOST_OK pid={pid}/{n_procs}')]
        if p.returncode or not line:
            fail(f'worker {pid} failed (rc {p.returncode}):\n{err[-3000:]}')
        ok += line
    return ok


def phase_mesh(torch, dev, k1_inputs, align_rows) -> dict:
    """Phase mesh (module docstring, 10). Returns K1's window-mode fields
    for the kernels line; adds the sharded align's K2, K3, K5 and K4
    launches to their rows."""
    import numpy as np
    from vclust_tpu_torch.entry import dryrun_multichip, entry
    from vclust_tpu_torch.ops import align_gpu as ag
    from vclust_tpu_torch.ops import prefilter as pf
    from vclust_tpu_torch.parallel.mesh import make_mesh
    sets_a, idx_a, idx_c = k1_inputs
    res = dict(phase='mesh', cards=torch.cuda.device_count())

    # K1's work lists cut among shards of this card.
    split = {}
    for name, idx in (('a_bench_1536', idx_a), ('c_synthetic_16384',
                                                idx_c)):
        whole = pf.shared_kmer_counts_indexed(idx, engine='device',
                                              device=dev)
        for shards in (2, 3):
            pf.occupancy_count.launches = 0
            t0 = time.perf_counter()
            got = pf.shared_kmer_counts_indexed(
                idx, mesh=make_mesh(shards, device=dev))
            seconds = time.perf_counter() - t0
            launches = pf.occupancy_count.launches
            if launches < shards:
                fail(f'mesh: K1 over {shards} shards launched {launches}')
            if not np.array_equal(got, whole):
                fail(f'mesh: K1 over {shards} shards != unsharded ({name})')
            split[f'{name} x {shards} shards'] = dict(
                launches=launches, seconds=seconds)
            del got
        del whole
    res['k1_split'] = split

    # The unweighted count and its row panels (K1 in window mode).
    pf.occupancy_count.launches = 0
    dense = pf.shared_kmer_counts_device(sets_a, device=dev)
    res['unweighted_launches'] = pf.occupancy_count.launches
    if not res['unweighted_launches']:
        fail('mesh: the unweighted count launched no K1')
    if not np.array_equal(dense, pf._counts_from_index_host(idx_a)):
        fail('mesh: the unweighted count != the host count')
    window_launches = {}
    for panel in (512, 300):
        pf.occupancy_count.launches = 0
        rows = 0
        for lo, hi, block in pf.shared_kmer_counts_panels(sets_a, panel=panel,
                                                          device=dev):
            if not np.array_equal(block, dense[lo:hi]):
                fail(f'mesh: panel [{lo}, {hi}) of {panel} != dense rows')
            rows += hi - lo
        window_launches[panel] = pf.occupancy_count.launches
        if rows != len(sets_a) or not window_launches[panel]:
            fail(f'mesh: panels of {panel} did not cover the rows with K1')
    res['panel_launches'] = window_launches
    del dense
    res['k1_unweighted'] = k1_passes_case(
        torch, dev, 'unweighted, (a)\'s 1,536 sets', len(sets_a),
        pf.unweighted_passes(sets_a, dev))
    n_c = idx_c.n
    rc = max(1024, min(131072, (1 << 28) // (4 * (n_c + 1))))
    rc, nc = pf._adapt_chunks(idx_c.gids, idx_c.lens, n_c, rc, 524288)
    panel = min(4096, n_c // 4 // pf.K1_TILE * pf.K1_TILE)   # 4,096 at c
    window = k1_passes_case(
        torch, dev, f'window rows [{panel}, {2 * panel}), case c', n_c,
        pf.k1_passes(n_c, idx_c.gids, idx_c.lens, idx_c.weights, dev, rc, nc,
                     window=(panel, panel)), window=(panel, panel))
    res['k1_window'] = window
    res['k1_split_ms'] = {f'c_synthetic_16384 x {k} shards':
                          k1_split_ms(torch, dev, idx_c, k) for k in (2, 3)}

    # The sharded device align engine on the 48 genomes.
    codes, pairs = align_inputs(mutant_corpus())
    single = ag.all2all_gpu(codes, pairs, keep_alignments=True, device=dev)
    mesh2 = make_mesh(2, device=dev)
    zero_align_launches(ag)
    with pipe_timer(ag) as st:
        sharded = ag.all2all_gpu(codes, pairs, keep_alignments=True,
                                 mesh=mesh2)
    sharded_launches = align_launches(ag)
    check_align_launches('mesh: the sharded align', sharded_launches, st)
    if not (np.array_equal(single[0], sharded[0])
            and np.array_equal(single[1][0], sharded[1][0])
            and np.array_equal(single[1][1], sharded[1][1])):
        fail('mesh: the sharded align != the single device')
    with plain_kernels(ag):
        plain = ag.all2all_gpu(codes, pairs, keep_alignments=True,
                               mesh=mesh2)
    same_records('mesh: the sharded align', sharded, plain)
    walls = {'single': [], 'sharded_2': []}
    for _ in range(2):
        for key, kw in (('single', dict(device=dev)),
                        ('sharded_2', dict(mesh=mesh2))):
            t0 = time.perf_counter()
            ag.all2all_gpu(codes, pairs, **kw)
            walls[key].append(time.perf_counter() - t0)
    res['align'] = dict(corpus='genomes48', pairs=len(pairs),
                        records=int(len(single[1][0])),
                        launches=sharded_launches, kernels_eq_plain=True,
                        warm_s=walls,
                        pairs_per_s={k: len(pairs) / min(v)
                                     for k, v in walls.items()})
    for row in align_rows:
        row['launches_by_path']['mesh: all2all_gpu 2 shards (genomes48)'] = \
            sharded_launches[row.get('wrapper', row['name'])]

    # Two processes on this card, and the dry run.
    t0 = time.perf_counter()
    res['multihost'] = run_workers([f'cuda:{dev.index or 0}'] * 2, 1)
    res['multihost_s'] = time.perf_counter() - t0
    fn, args = entry()
    counts = fn(*args)[0]
    want = args[0].int().cpu() @ args[0].int().cpu().T
    if not torch.equal(counts.cpu(), want):
        fail('mesh: entry() counts != the int product')
    # entry()'s step: int8 torch._int_mm, ani-shorter and the keep mask.
    # Least bytes: the occupancy and sizes read, counts, sim and keep
    # written; least operations: 2 G^2 M int8.
    G, M = args[0].shape
    t_bytes = (G * M + 4 * G + G * G * 9) / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * G * G * M / INT8_TENSOR_OPS_PER_S * 1e3
    res['entry'] = dict(shape=[G, M], ms=time_ms(lambda: fn(*args), 20),
                        bound_ms=max(t_bytes, t_ops),
                        bound_by='bytes' if t_bytes >= t_ops
                        else 'operations')
    cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    if cards > 1:
        dryrun_multichip(cards)
        res['dryrun'] = f'{cards} cards'
    else:
        dryrun_multichip(2, device=dev)
        res['dryrun'] = '2 shards of one card'
    res['dryrun_s'] = time.perf_counter() - t0
    emit(res)
    keys = ('at', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms')
    unweighted = res['k1_unweighted']
    return dict(launches=sum(window_launches.values()),
                launches_by_path={f'panels of {p} (1,536 sets)': v
                                  for p, v in window_launches.items()},
                **{k: window[k] for k in keys}), dict(
        launches=res['unweighted_launches'],
        launches_by_path={'shared_kmer_counts_device (1,536 sets)':
                          res['unweighted_launches']},
        **{k: unweighted[k] for k in keys})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    if not (REPO / 'vclust_tpu_torch').is_dir():
        sys.exit('chip_smoke.py must run from a checkout of the repository')
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit('CUDA is not available: chip_smoke.py needs a GPU')
    sys.path.insert(0, str(REPO))
    from vclust_tpu_torch.ops import cuda
    from vclust_tpu_torch.utils.logging import create_logger
    create_logger(0)
    os.environ['VCLUST_TORCH_DEVICE'] = 'cuda'
    dev = torch.device('cuda')

    t0 = time.perf_counter()
    build_s = cuda.build()
    emit(dict(phase='build', seconds=build_s, sources=list(cuda.SOURCES),
              ptxas={k: ptxas_summary(v) for k, v in cuda.build_log.items()}))
    kx_row = phase_kx(torch, dev, np.random.default_rng(args.seed))
    c, k1_err, k1_inputs = phase_k1(torch, dev, args.seed)
    cc_path, cc_cases = phase_cc(torch, dev, args.seed)
    with tempfile.TemporaryDirectory(prefix='vclust_smoke_') as tmp:
        cc_cli = phase_cluster_cli(pathlib.Path(tmp) / 'cluster_cli',
                                   args.seed)
        launches, k1_main = phase_main(torch, dev, pathlib.Path(tmp),
                                       k1_inputs[0])
        engine = phase_align_engine(torch, pathlib.Path(tmp))
    k1_row = dict(
        name='occupancy_count', route='cuda',
        source='vclust_tpu_torch/csrc/occupancy.cu',
        replaces='vclust_tpu/ops/prefilter.py:277',
        launches=launches['occupancy_count'],
        max_abs_err=max(k1_err, k1_main['max_abs_err']),
        ms=c['ms'], plain_ms=c['plain_ms'], bound_ms=c['bound_ms'],
        bound_by=c['bound_by'], library_ms=c['library_ms'],
        at='case c: n=16384, 65536 patterns',
        limb_products=c['limb_products'],
        limb_products_without_classes=c['limb_products_without_classes'],
        split=c['split'], device_ms=c['device_ms'],
        ms_per_chunk=c['ms_per_chunk'],
        main_shape={key: k1_main[key] for key in (
            'n', 'patterns', 'chunks', 'passes', 'max_abs_err', 'ms',
            'device_ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
            'limb_products', 'limb_products_without_classes', 'split')})
    kx_row['at'] = 'the kx phase jobs'
    align_rows = phase_align_v3(torch, dev, args.seed, engine)
    v2 = phase_align_v2(torch, dev, args.seed)
    for row in align_rows:
        row['launches_by_path']['align_v2 (8 genomes, 28 pairs)'] = \
            v2['path_launches'][row.get('wrapper', row['name'])]
    window, unweighted = phase_mesh(torch, dev, k1_inputs, align_rows)
    k1_row['window_mode'] = window
    k1_row['unweighted'] = unweighted
    k1_row['max_abs_err'] = max(k1_row['max_abs_err'], window['max_abs_err'],
                                unweighted['max_abs_err'])
    keys = ('at', 'max_abs_err', 'ms', 'device_ms', 'plain_ms', 'bound_ms',
            'bound_by', 'library_ms', 'share_of_bound', 'host_ms')
    for row, key in zip(align_rows[6:], ('k8', 'k6', 'k7')):
        at = v2['dispatch'][key]
        row['max_abs_err'] = max(row['max_abs_err'], at['max_abs_err'])
        row['at_262144'] = {key: at.get(key) for key in keys}
    (k9_row, k10_row, k2_row, k3_row, k5_row, k4_row, k8_row, k6_row,
     k7_row) = align_rows
    for name, at in (('at_262144', v2['dispatch']['index']),
                     ('at_262144_c8', v2['index_c8'])):
        k10_row['max_abs_err'] = max(k10_row['max_abs_err'],
                                     at['max_abs_err'])
        k10_row[name] = {key: at.get(key) for key in keys}
    at = {c['graph']: c for c in cc_cases}
    cc_row = dict(
        name='connected_components', route='cuda',
        source='vclust_tpu_torch/csrc/cc.cu',
        replaces='vclust_tpu/ops/cc.py:21', launches=cc_cli['k11_launches'],
        launches_by_path={
            'cluster CLI, 60,000 objects': cc_cli['k11_launches'],
            'models/cluster.py:_single, 200,000 nodes':
                cc_path['path_launches']},
        max_abs_err=max(c['max_abs_err'] for c in cc_cases),
        **{key: at['a_recipe_2m'].get(key) for key in (
            'ms', 'device_ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms')},
        at='graph (a): 2,000,000 nodes, '
           f"{at['a_recipe_2m']['edges']} edges between ids < 64 apart",
        library=NO_LIBRARY['connected_components'],
        by_graph={name: {key: c.get(key) for key in (
            'nodes', 'edges', 'ms', 'device_ms', 'parts', 'plain_ms',
            'plain_rounds', 'bound_ms', 'share_of_bound')}
            for name, c in at.items()})
    rows = [kx_row, k1_row, k9_row, k10_row, k2_row, k3_row, k4_row, k5_row,
            k8_row, k6_row, k7_row, cc_row]
    emit({'kernels': [with_shares(row) for row in rows],
          'seconds': time.perf_counter() - t0})
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    main()
