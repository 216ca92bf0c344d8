"""The port's v3 align pipe (vclust_tpu_torch/ops/align_gpu.py) against the
JAX package's (vclust_tpu/ops/align_tpu.py), on the CPU, bit for bit.

Every input is made from a numpy seed (or bench.py's corpus functions) and
every output is an integer, so the tolerance is 0:

- the index (`_index_block_v3` through `ensure_v3`), with N runs and
  genomes shorter than the bucket;
- the row core (`_row_core_v3(debug=True)`) on one arena carried across
  by `index_v3_from_numpy`: every intermediate, at buckets 4,096 and 6,144
  with K = 2 and 4, over a reverse-complement mutant, an N run and a
  tandem copy that ties stage-1 counts;
- the all-vs-all entry point (`_all2all_single(..., pipe='v3')` in both
  packages), aggregates and records, on 16 contigs of
  `bench.make_contig_corpus` (all 120 pairs) and on NC_005091 and
  NC_005091.alt1 of the example with one 5% mutant each (bucket 65,536,
  6 pairs); also over split arenas and with B = 1 dispatch row.

The JAX side runs once per corpus (module fixtures) and once per
row-core bucket: XLA on the CPU compiles each program in ~45 s, so each
corpus stays in one bucket (one program).
"""

import functools
import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FASTA_FILE, REPO

sys.path.insert(0, str(REPO))

import bench                                          # noqa: E402
from vclust_tpu.models.align import _genome_codes, order_objects  # noqa
from vclust_tpu.models.input import load_genomes      # noqa: E402
from vclust_tpu.ops import align_tpu as ja            # noqa: E402
from vclust_tpu_torch.ops import align_gpu as ag      # noqa: E402

# Six pytest workers share the machine: one torch thread each.
torch.set_num_threads(1)

CPU = torch.device('cpu')
_DEBUG_KEYS = ('cnt1', 'g1', 'cnt2', 'g2', 'cnt_best', 'A', 'S', 'D', 'm',
               'ma', 'seg_start', 'e_flag', 'acc_cov', 'n_alns',
               'sum_match', 'sum_alnlen')


def _ids_codes(corpus):
    return [_genome_codes(corpus[i]) for i in order_objects(corpus)]


def _all_pairs(n):
    return np.array([(i, j) for i in range(n) for j in range(i + 1, n)],
                    dtype=np.int32)


def _revcomp(s):
    return np.where(s < 4, 3 - s, 4)[::-1].astype(np.int8)


def _row_genomes(bucket, seed=11):
    """Six genomes for one row-core arena: a reference whose last 600
    bases repeat bases 200-800 on the 32-block grid (stage-1 ties), a 5%
    mutant, the reverse complement of another, an 8% mutant with a
    100-base N run, a short 3% mutant of its first third and a mosaic of
    the reference's second half with an inverted first half."""
    rng = np.random.default_rng(seed)
    n = bucket - 704                    # n and n - 800 multiples of 32
    ref = rng.integers(0, 4, n).astype(np.int8)
    ref[-600:] = ref[200:800]

    def mutate(s, rate):
        s = s.copy()
        hit = rng.random(len(s)) < rate
        s[hit] = (s[hit] + rng.integers(1, 4, hit.sum())) % 4
        return s

    nrun = mutate(ref, 0.08)
    nrun[1000:1100] = 4
    mosaic = np.concatenate([mutate(ref[n // 2:], 0.04),
                             _revcomp(mutate(ref[:n // 2], 0.04))])
    return [ref, mutate(ref, 0.05), _revcomp(mutate(ref, 0.05)), nrun,
            mutate(ref[:n // 3], 0.03), mosaic]


def _np_dict(d):
    return {k: (np.asarray(v) if k != 'rows' else v) for k, v in d.items()}


# --------------------------------------------------------------------------
# index
# --------------------------------------------------------------------------

@pytest.mark.parametrize('bucket', [4096, 6144])
def test_index_matches_reference(bucket):
    codes = _row_genomes(bucket)
    want = _np_dict(ja.GenomeIndexTPU(codes).ensure_v3(bucket,
                                                       range(len(codes))))
    got = ag.GenomeIndex(codes, device=CPU).ensure_v3(bucket,
                                                      range(len(codes)))
    assert got['rows'] == want['rows']
    for key in ('fwd', 'qocc', 'rocc', 'roww_f', 'roww_r'):
        assert np.array_equal(got[key].numpy(), want[key]), key
    # Cached: a subset is served from the same arena.
    assert ag.GenomeIndex(codes, device=CPU).ensure_v3(
        bucket, [0, 1])['rows'] == {0: 0, 1: 1}


# --------------------------------------------------------------------------
# row core
# --------------------------------------------------------------------------

# Two rows (reference, four queries); K = 2 takes each row's first two.
_ROW_REFS = np.array([0, 2], np.int32)
_ROW_QUERIES = np.array([[1, 2, 3, 4], [0, 5, 3, 1]], np.int32)
_JAX_ROW_CORE = jax.jit(ja._row_core_v3, static_argnames=(
    'Lq', 'Lr', 'K', 'mqd', 'mrd', 'reg', 'debug'))


@functools.lru_cache(maxsize=None)
def _row_reference(bucket):
    """The genomes' lengths, the JAX arena and the JAX row core's debug
    intermediates of both rows at K = 4, once a bucket. A query's
    intermediates do not depend on the other queries of its row, so the
    K = 2 case reads the first two."""
    codes = _row_genomes(bucket)
    lens = np.array([len(c) for c in codes], np.int32)
    jd = _np_dict(ja.GenomeIndexTPU(codes).ensure_v3(bucket,
                                                     range(len(codes))))
    p = ja.AlignParams()
    want = [_JAX_ROW_CORE(
        jd['rocc'][rr], jd['roww_f'][rr], jd['roww_r'][rr],
        jnp.int32(lens[rr]), jd['fwd'][qr], jd['qocc'][qr],
        jnp.asarray(lens[qr]), jnp.int32(ja.V3_TBAND),
        jnp.int32(ja.V3_SMIN), debug=True, Lq=bucket, Lr=bucket, K=4,
        mqd=p.mqd, mrd=p.mrd, reg=p.reg)
        for rr, qr in zip(_ROW_REFS, _ROW_QUERIES)]
    return lens, jd, [jax.tree.map(np.asarray, w) for w in want]


@pytest.mark.parametrize('bucket,K', [(4096, 2), (4096, 4), (6144, 2),
                                      (6144, 4)])
def test_row_core_intermediates_match_reference(bucket, K):
    lens, jd, want = _row_reference(bucket)
    b = ag.index_v3_from_numpy(jd, device=CPU)
    p = ja.AlignParams()
    refs = _ROW_REFS
    q_rows = np.ascontiguousarray(_ROW_QUERIES[:, :K])
    got = ag._row_core_v3(b, torch.from_numpy(refs),
                          torch.from_numpy(lens[refs]),
                          torch.from_numpy(q_rows), ja.V3_TBAND, ja.V3_SMIN,
                          debug=True, Lq=bucket, Lr=bucket, K=K, mqd=p.mqd,
                          mrd=p.mrd, reg=p.reg)
    for row in range(len(refs)):
        for key in _DEBUG_KEYS:
            assert np.array_equal(got[key][row].numpy(),
                                  want[row][key][:K]), (row, key)
        for gb, wb in zip(got['band_best'], want[row]['band_best']):
            assert np.array_equal(gb[row].numpy(), wb[:K])
    # The inputs reach what they are for: elections on both strands, a
    # propagated or switched diagonal, alignments, and a stage-1 tie that
    # the larger reference block won.
    assert got['A'].any() and got['S'].any() and (~got['S'] & got['A']).any()
    assert (got['n_alns'] > 0).all()
    p_sum = ag.stage1_pack_plain(b['qocc'], b['rocc'],
                                 torch.from_numpy(refs),
                                 torch.from_numpy(q_rows))[0]
    qf = b['qocc'][torch.from_numpy(q_rows[0]).long()].float()
    M = torch.matmul(qf, b['rocc'][refs[0]].float().T)
    M = (M[:, 0::2] + M[:, 1::2]).int()
    top = M.amax(dim=-1, keepdim=True)
    tied = ((M == top) & (top > 0)).sum(dim=-1) > 1
    assert tied.any()
    last = M.shape[-1] - 1 - (M == top).flip(-1).int().argmax(dim=-1)
    assert torch.equal((p_sum[0] & 8191)[tied], last[tied])


# --------------------------------------------------------------------------
# the all-vs-all entry point
# --------------------------------------------------------------------------

def _contigs16():
    return _ids_codes(bench.make_contig_corpus(16))


def _example4():
    """NC_005091 and NC_005091.alt1 (57,455 bases each) with one 5% mutant
    each: all in bucket 65,536, so the JAX side compiles one program."""
    genomes, _ = load_genomes(FASTA_FILE)
    pick = [g for g in genomes if g.name in ('NC_005091', 'NC_005091.alt1')]
    return _ids_codes(bench.make_align_corpus(pick, reps=1))


_CORPORA = {'contigs16': _contigs16, 'example4': _example4}


@pytest.fixture(scope='module', params=sorted(_CORPORA))
def corpus(request):
    """(codes, pairs, JAX (out, (rows, counts))) of one corpus; the JAX
    run keeps alignments, whose aggregates equal its run without."""
    codes = _CORPORA[request.param]()
    pairs = _all_pairs(len(codes))
    with pytest.MonkeyPatch.context() as mp:
        # The JAX CPU default pads every dispatch to 16 rows; 4 rows wastes
        # less (results do not depend on the dispatch rows).
        mp.setattr(ja, '_batch_rows_v3', lambda L, K: 4)
        want = ja._all2all_single(codes, pairs, None,
                                  ja.GenomeIndexTPU(codes), None, True,
                                  ja.SEEDS_PER_BLOCK, pipe='v3')
    return codes, pairs, want


def _assert_equal(got, want, keep):
    if not keep:
        assert got.dtype == np.int64 and got.shape == want[0].shape
        assert np.array_equal(got, want[0])
        return
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1][1], want[1][1])
    assert np.array_equal(got[1][0], want[1][0])


@pytest.mark.parametrize('keep', [False, True])
def test_all2all_matches_reference(corpus, keep):
    codes, pairs, want = corpus
    got = ag._all2all_single(codes, pairs, keep_alignments=keep, pipe='v3',
                             device=CPU)
    _assert_equal(got, want, keep)
    assert (want[0][:, 0] > 0).sum() > len(pairs) // 8


def test_all2all_split_arenas_match_reference(corpus, monkeypatch):
    codes, pairs, want = corpus
    monkeypatch.setattr(ag, 'MAX_ARENA', 3)
    calls = []
    ensure = ag.GenomeIndex.ensure_v3

    def spy(self, Lp, gids, cache=True):
        calls.append((len(set(gids)), cache))
        return ensure(self, Lp, gids, cache)

    monkeypatch.setattr(ag.GenomeIndex, 'ensure_v3', spy)
    got = ag._all2all_single(codes, pairs, keep_alignments=True, pipe='v3',
                             device=CPU)
    _assert_equal(got, want, True)
    assert len(calls) > 1 and all(n <= 3 and not c for n, c in calls)


def test_all2all_results_do_not_depend_on_dispatch_rows(corpus, monkeypatch):
    codes, pairs, want = corpus
    idx = ag.GenomeIndex(codes, device=CPU)
    monkeypatch.setattr(ag, '_dispatch_rows', lambda L, K, dev, alns: 1)
    one = ag._all2all_single(codes, pairs, index=idx, pipe='v3')
    monkeypatch.setattr(ag, '_dispatch_rows',
                        lambda L, K, dev, alns: 10 ** 6)
    every = ag._all2all_single(codes, pairs, index=idx, pipe='v3')
    assert np.array_equal(one, every)
    assert np.array_equal(every, want[0])


def test_dispatch_rows_follow_the_bytes_each_device_holds():
    cuda = torch.device('cuda')
    cpu = ag._dispatch_rows(65536, 8, CPU, False)
    card = ag._dispatch_rows(65536, 8, cuda, False)
    # The card does not hold the plain stage 1's float32 operand; records
    # hold more a position.
    assert 1 <= cpu < card
    assert ag._dispatch_rows(65536, 8, cuda, True) < card
    assert ag._dispatch_rows(4096, 8, CPU, False) > cpu


@pytest.mark.parametrize('L,alns,rows', [(65536, False, 34),
                                         (65536, True, 23),
                                         (4096, False, 546)])
def test_dispatch_rows_hold_no_windows_on_the_card(L, alns, rows):
    """On the card a v3 query holds the four bands' counts and no windows
    (K3 and K5 read the wide rows in place): B = 34 at 65,536 (23 with
    records; 26 and 20 while the windows were live) and 546 at 4,096. The
    CPU's plain versions build the windows, and its budget counts them."""
    g3 = ag._v3_geom(L, L)
    per_pos = ag._BYTES_PER_POS_RECORDS if alns else ag._BYTES_PER_POS
    counts = 4 * (L // 32) * g3['BAND']
    B = ag._dispatch_rows(L, 8, torch.device('cuda'), alns)
    assert B == ag._LIVE_BYTES // (8 * (counts + L * per_pos)) == rows
    windows = 4 * (L // 32) * g3['WIN']
    operand = 2 * g3['NQB'] * ag.V3_H * 4
    assert ag._dispatch_rows(L, 8, CPU, alns) == ag._LIVE_BYTES // (
        8 * (counts + windows + operand + L * per_pos))


def test_record_cap_warns_only_when_it_overflows(monkeypatch):
    codes = _row_genomes(4096)
    pairs = _all_pairs(len(codes))
    idx = ag.GenomeIndex(codes, device=CPU)
    full = ag._all2all_single(codes, pairs, index=idx,
                              keep_alignments=True, pipe='v3')
    most = int(full[1][1].max())
    assert most > 1 and (full[1][1] < most).any()
    log = logging.getLogger('vclust-tpu')
    seen = []
    handler = logging.Handler()
    handler.emit = lambda rec: seen.append(rec.getMessage())
    log.addHandler(handler)
    # A CLI run earlier in this process (`-v 0`) may have left the logger
    # at ERROR.
    level = log.level
    log.setLevel(logging.WARNING)
    try:
        # Exactly full: no warning, every record kept.
        monkeypatch.setattr(ag, '_maxseg', lambda Lq, reg: most)
        exact = ag._all2all_single(codes, pairs, index=idx,
                                   keep_alignments=True, pipe='v3')
        assert seen == []
        _assert_equal(exact, full, True)
        # One short: a warning, and the fullest pairs lose their last row.
        monkeypatch.setattr(ag, '_maxseg', lambda Lq, reg: most - 1)
        cut = ag._all2all_single(codes, pairs, index=idx,
                                 keep_alignments=True, pipe='v3')
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    assert len(seen) == 1 and 'overflowed' in seen[0]
    assert np.array_equal(cut[0], full[0])
    assert np.array_equal(cut[1][1], np.minimum(full[1][1], most - 1))


@pytest.mark.parametrize('case', ['wq_above_416', 'bucket_above_13_bits',
                                  'bucket_above_max', 'oversized'])
def test_all2all_guards_raise(monkeypatch, case):
    codes = [np.zeros(5000, np.int8), np.zeros(3000, np.int8)]
    pairs = np.array([[0, 1]], np.int32)
    if case == 'wq_above_416':
        monkeypatch.setattr(ag, 'V3_WQ', 448)
    elif case == 'bucket_above_13_bits':
        codes[0] = np.zeros(300_000, np.int8)
        monkeypatch.setattr(ag, 'V3_MAX_BUCKET', 1 << 20)
    elif case == 'bucket_above_max':
        # Above V3_MAX_BUCKET the v3 pipe hands the group to v2 (which
        # raised NotImplementedError until v2 was ported); an unknown
        # pipe raises.
        monkeypatch.setattr(ag, 'V3_MAX_BUCKET', 4096)
        idx = ag.GenomeIndex(codes, device=CPU)
        got = ag._all2all_single(codes, pairs, index=idx, pipe='v3')
        assert list(idx.bucket) == [(6144, ag.SEEDS_PER_BLOCK)]
        assert np.array_equal(got, ag._all2all_single(codes, pairs,
                                                      index=idx, pipe='v2'))
        with pytest.raises(ValueError):
            ag._all2all_single(codes, pairs, index=idx, pipe='v4')
        return
    else:
        monkeypatch.setattr(ag, 'MAX_TPU_LEN', 4096)
    with pytest.raises(ValueError):
        ag._all2all_single(codes, pairs, pipe='v3', device=CPU)
