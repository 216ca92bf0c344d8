"""The port's v2 align pipe, hybrid tail, two-phase screen and `--engine
gpu` (vclust_tpu_torch/ops/align_gpu.py, models/align.py) against the JAX
package's (vclust_tpu/ops/align_tpu.py, `--engine tpu`), on the CPU, bit
for bit.

Every input is made from a numpy seed or bench.py's corpus functions and
every output is an integer or a file of them, so the tolerance is 0:

- the v2 index (`_index_block`, and through `ensure`) at bucket 4,096,
  pack 32 and 64, C = 16 and 8, over a tandem repeat that ties the hash;
- the v2 row core (`_row_core(debug=True)`) on one JAX arena carried
  across by `index_v2_from_numpy`: every intermediate, `votes` and `vb`
  included, at pack 32 and 64;
- `_all2all_single(pipe='v2')` on 16 contigs of `bench.make_contig_corpus`
  (120 pairs, bucket 6,144), aggregates and records; and v3 and v2 groups
  in one call (V3_MAX_BUCKET at 4,096 in both packages);
- `_elect` at both pack widths against a plain election in numpy;
- `all2all_gpu` against `all2all_tpu` on a small corpus with hard pairs
  (containments, a 5% mutant, a reverse complement, multi-contig genomes
  with reordered contigs, all at bucket 4,096), with and without records; the
  v2 two-phase screen; and results that do not depend on the dispatch
  rows;
- the engine: `run_align(engine='gpu')` rows, the CLI's `ani.tsv`,
  `ani.ids.tsv` and `ani.aln.tsv` against the JAX CLI's `--engine tpu`,
  the route of oversized genomes to the host engines, and `--engine tpu`
  == `--engine gpu` in the port.

The JAX side runs with one device (the port has no mesh yet), once a
corpus (module fixtures), with dispatches of 8 rows (its CPU defaults pad
a dispatch to 16 and 128 rows; results do not depend on the rows); the
JAX row core compiles once a pack width, and the JAX CLI runs in-process,
so it reuses the programs the engine fixture compiled.
"""

import contextlib
import io
import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO

sys.path.insert(0, str(REPO))

import bench                                          # noqa: E402
from vclust_tpu.core.seq import revcomp_codes         # noqa: E402
from vclust_tpu.models import align as jalign         # noqa: E402
from vclust_tpu.models.input import Genome as JGenome  # noqa: E402
from vclust_tpu.ops import align_tpu as ja            # noqa: E402
from vclust_tpu_torch.models import align as talign   # noqa: E402
from vclust_tpu_torch.models.input import Genome      # noqa: E402
from vclust_tpu_torch.ops import align_gpu as ag      # noqa: E402
from hybrid_cases import hybrid_genomes as _hybrid_genomes  # noqa: E402
from hybrid_cases import write_hybrid_dir  # noqa: E402

# Six pytest workers share the machine: one torch thread each.
torch.set_num_threads(1)

CPU = torch.device('cpu')
_DEBUG_KEYS = ('votes', 'vb', 'A', 'S', 'D', 'm', 'ma', 'seg_start',
               'e_flag', 'acc_cov', 'n_alns', 'sum_match', 'sum_alnlen')


@pytest.fixture(scope='module', autouse=True)
def _jax_rows():
    """JAX dispatches of 8 rows: XLA on the CPU runs every padded row."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ja, '_batch_rows', lambda Lq, Lr, K, C: 8)
        mp.setattr(ja, '_batch_rows_v3', lambda L, K: 8)
        yield


@pytest.fixture(autouse=True)
def _one_device(monkeypatch):
    """The JAX engine on one device (the conftest's 8 virtual CPU devices
    would shard it over a mesh: the same results, other programs), and
    the port's entry points on the CPU."""
    monkeypatch.setattr('vclust_tpu.parallel.mesh.auto_mesh', lambda: None)
    monkeypatch.setenv('VCLUST_TORCH_DEVICE', 'cpu')


def _all_pairs(n):
    return np.array([(i, j) for i in range(n) for j in range(i + 1, n)],
                    dtype=np.int32)


def _np_dict(d):
    return {k: (np.asarray(v) if k != 'rows' else v) for k, v in d.items()}


# --------------------------------------------------------------------------
# index
# --------------------------------------------------------------------------

BUCKET = 4096


def _index_genomes(seed=1):
    """A reference with a tandem repeat (equal values, so hash ties, in
    one block) and a copy of bases 300-900 at its end, a 5% mutant with an
    N run, and a short piece of the mutant."""
    rng = np.random.default_rng(seed)
    n = BUCKET - 704
    ref = rng.integers(0, 4, n).astype(np.int8)
    ref[-600:] = ref[300:900]
    ref[1000:1400] = np.tile(ref[1000:1010], 40)
    mut = ref.copy()
    hit = rng.random(n) < 0.05
    mut[hit] = (mut[hit] + rng.integers(1, 4, hit.sum())) % 4
    mut[1500:1600] = 4
    return [ref, mut, mut[:n // 3]]


def _padded(codes):
    fwd = np.full((len(codes), BUCKET), 4, np.int8)
    rc = fwd.copy()
    for r, c in enumerate(codes):
        fwd[r, :len(c)] = c
        rc[r, :len(c)] = revcomp_codes(c)
    return fwd, rc


def _jax_index_block(codes, pack, C):
    """The JAX `_index_block` arrays as numpy, with 'fwd', 'pack_bits'
    and the identity row map: a bucket dict for `index_v2_from_numpy`."""
    fwd, rc = _padded(codes)
    with ja._x64(pack):
        arrs = ja._index_block(jnp.asarray(fwd), jnp.asarray(rc), ja.SEED_K,
                               pack, C)
        d = dict(zip(ag._V2_KEYS, (np.asarray(a) for a in arrs)))
    d.update(fwd=fwd, pack_bits=pack, rows={i: i for i in range(len(codes))})
    return d


@pytest.mark.parametrize('pack,C', [(32, 16), (32, 8), (64, 16), (64, 8)])
def test_index_block_matches_reference(pack, C):
    codes = _index_genomes()
    want = _jax_index_block(codes, pack, C)
    fwd, rc = _padded(codes)
    got = ag._index_block(torch.from_numpy(fwd), torch.from_numpy(rc),
                          ag.SEED_K, pack, C)
    for key, g in zip(ag._V2_KEYS, got):
        w = want[key]
        assert g.dtype == (torch.int64 if key.startswith('pk') else
                           torch.int8 if key == 'r2dov' else torch.int32)
        assert np.array_equal(g.numpy().astype(np.int64),
                              w.astype(np.int64)), key
    # The tandem repeat ties hashes inside a block, and values repeat
    # across blocks, so the previous-occurrence packs are in use.
    assert (want['pk2_f'] > 0).any() and (want['pk1_f'] > 0).any()
    if pack == 32:
        assert want['pk1_f'].max() > 2 ** 31       # uint32 above int32


def test_ensure_matches_reference():
    codes = _index_genomes()
    want = _np_dict(ja.GenomeIndexTPU(codes).ensure(BUCKET, range(3)))
    idx = ag.GenomeIndex(codes, device=CPU)
    got = idx.ensure(BUCKET, range(3))
    assert got['rows'] == want['rows'] and got['pack_bits'] == 32
    for key in ('fwd',) + ag._V2_KEYS:
        assert np.array_equal(got[key].numpy().astype(np.int64),
                              want[key].astype(np.int64)), key
    # Cached per (bucket, C): a subset is served from the same arena, C=8
    # is another.
    assert idx.ensure(BUCKET, [0, 1]) is got
    assert idx.ensure(BUCKET, [0, 1], C=8) is not got


# --------------------------------------------------------------------------
# row core
# --------------------------------------------------------------------------

# Two rows (reference, two queries): the reference against its mutant and
# the reverse complement of another; the short piece against the mosaic
# and the mutant.
_ROW_REFS = np.array([0, 2], np.int32)
_ROW_QUERIES = np.array([[1, 3], [4, 1]], np.int32)
_JAX_ROW_CORE = jax.jit(ja._row_core, static_argnames=(
    'Lq', 'Lr', 'K', 'mqd', 'mrd', 'reg', 'pack_bits', 'C', 'with_alns',
    'debug'))


def _row_genomes(seed=11):
    """The index genomes plus the reverse complement of a 5% mutant and a
    mosaic of the reference's halves, the first inverted."""
    rng = np.random.default_rng(seed)
    ref, mut, short = _index_genomes(seed)
    n = len(ref)
    rcm = ref.copy()
    hit = rng.random(n) < 0.05
    rcm[hit] = (rcm[hit] + 1) % 4
    mosaic = np.concatenate([ref[n // 2:], revcomp_codes(ref[:n // 2])])
    return [ref, mut, short, revcomp_codes(rcm), mosaic]


@pytest.mark.parametrize('pack', [32, 64])
def test_row_core_intermediates_match_reference(pack):
    codes = _row_genomes()
    lens = np.array([len(c) for c in codes], np.int32)
    jd = _jax_index_block(codes, pack, ja.SEEDS_PER_BLOCK)
    p = ja.AlignParams()
    static = dict(Lq=BUCKET, Lr=BUCKET, K=2, mqd=p.mqd, mrd=p.mrd,
                  reg=p.reg)
    with ja._x64(pack):
        want = [jax.tree.map(np.asarray, _JAX_ROW_CORE(
            *(jd[k][rr] for k in ('sv_f', 'pk1_f', 'pk2_f', 'sv_r', 'pk1_r',
                                  'pk2_r', 'r2dov')),
            jnp.int32(lens[rr]), jd['fwd'][qr], jd['qsv'][qr],
            jd['qoff'][qr], jnp.asarray(lens[qr]), pack_bits=pack,
            C=ja.SEEDS_PER_BLOCK, debug=True, **static))
            for rr, qr in zip(_ROW_REFS, _ROW_QUERIES)]
    b = ag.index_v2_from_numpy(jd, device=CPU)
    got = ag._row_core(b, torch.from_numpy(_ROW_REFS),
                       torch.from_numpy(lens[_ROW_REFS]),
                       torch.from_numpy(_ROW_QUERIES),
                       torch.from_numpy(lens[_ROW_QUERIES]), debug=True,
                       **static)
    for row in range(len(_ROW_REFS)):
        for key in _DEBUG_KEYS:
            assert np.array_equal(got[key][row].numpy(), want[row][key]), \
                (row, key)
    # The inputs reach what they are for: votes on both strands,
    # elections on both strands and alignments in every pair.
    votes = got['votes']
    assert (votes[..., :2] < ag.BIG).any() and (votes[..., 2:] < ag.BIG).any()
    assert (got['A'] & got['S']).any() and (got['A'] & ~got['S']).any()
    assert (got['n_alns'] > 0).all()


def _elect_plain(sd, cstride, min_votes, DSPAN, Lq):
    """The election of `_elect`, a row at a time in numpy: the largest
    saturated cluster count on the subsampled row (ties to the smallest
    start), then the most frequent value inside that cluster (ties to the
    smallest), then its exact vote count over the whole row."""
    out = []
    for row in sd.astype(np.int64):
        sds = row[::cstride]
        w = len(sds)
        sdp = np.concatenate([sds, np.full(w, ag.BIG)])
        smax = min(ag.SMAX, w - 1)
        cnt = [1 + sum(sdp[i + s] - sds[i] <= ag.GAP_DIAG
                       for s in range(1, smax + 1)) for i in range(w)]
        eq = [1 + sum(sdp[i + s] == sds[i] for s in range(1, smax + 1))
              for i in range(w)]
        ok = [i for i in range(w) if sds[i] < ag.BIG]
        medv = ag.BIG
        if ok:
            start = min((-cnt[i], sds[i]) for i in ok)[1]
            inb = [i for i in ok if start <= sds[i] <= start + ag.GAP_DIAG]
            medv = min((-eq[i], sds[i]) for i in inb)[1]
        vb = int((np.abs(row - medv) <= ag.GAP_DIAG).sum()) \
            if medv < ag.BIG else 0
        strand = medv >= DSPAN
        out.append((vb >= min_votes, strand,
                    (medv - DSPAN if strand else medv) - Lq, vb, medv))
    return [np.array(col) for col in zip(*out)]


@pytest.mark.parametrize('cstride', [1, 4])
@pytest.mark.parametrize('dspan', [3000, 1 << 21])
def test_elect_matches_plain_election(dspan, cstride):
    """Both pack widths of `_elect`: 22 bits in int32 while the vote codes
    (up to 2*DSPAN + 64) fit, else 32 bits in int64 (a pair of two genomes
    in bucket MAX_TPU_LEN). Rows hold clusters on both strands, equal
    counts (the smallest start wins), repeated values and empty tails. At
    the narrow pack the JAX `_elect` gives the same; at the wide one it
    elects nothing (ROADMAP R9), which the port does not copy."""
    rng = np.random.default_rng(dspan + cstride)
    top = 2 * dspan + 64
    rows = []
    for r in range(12):
        v = [rng.integers(0, top, 8)]
        for c in rng.integers(0, top - 20, 3):
            v.append(c + rng.integers(0, 12, rng.integers(3, 12)))
        if r % 3 == 0:                       # two clusters of equal size
            v = [rng.integers(0, top, 4), np.full(6, top - 40),
                 np.full(6, 7)]
        v = np.sort(np.concatenate(v))[:48]
        rows.append(np.concatenate([v, np.full(48 - len(v), ag.BIG)]))
    rows.append(np.full(48, ag.BIG))          # no votes
    sd = np.stack(rows).astype(np.int32)
    Lq = dspan // 2
    want = _elect_plain(sd, cstride, 2, dspan, Lq)
    got = ag._elect(torch.from_numpy(sd), cstride, 2, DSPAN=dspan, Lq=Lq)
    for key, g, w in zip(('assigned', 'strand', 'diag', 'vb', 'medv'),
                         got, want):
        assert np.array_equal(g.numpy().astype(np.int64),
                              w.astype(np.int64)), key
    assert want[0].any() and want[1].any() and (~want[1][:-1]).any()
    if top < 1 << 22:
        ref = jax.jit(ja._elect, static_argnums=(1, 2),
                      static_argnames=('DSPAN', 'Lq'))(
            jnp.asarray(sd), cstride, 2, DSPAN=dspan, Lq=Lq)
        for g, w in zip(got, ref):
            assert np.array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# _all2all_single(pipe='v2'), and v3 and v2 groups in one call
# --------------------------------------------------------------------------

def _ids_codes(corpus):
    return [jalign._genome_codes(corpus[i])
            for i in jalign.order_objects(corpus)]


def _assert_equal(got, want, keep):
    if not keep:
        assert got.dtype == np.int64 and got.shape == want[0].shape
        assert np.array_equal(got, want[0])
        return
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1][1], want[1][1])
    assert np.array_equal(got[1][0], want[1][0])


@pytest.fixture(scope='module')
def contigs16(_jax_rows):
    """(codes, pairs, JAX v2 (out, (rows, counts))) of 16 contigs of 5,600
    bases in 4 families (bucket 6,144: the mixed-groups test reuses this
    JAX program): the JAX run keeps alignments, whose aggregates equal its
    run without."""
    codes = _ids_codes(bench.make_contig_corpus(16, length=5600, families=4))
    pairs = _all_pairs(len(codes))
    want = ja._all2all_single(codes, pairs, None, ja.GenomeIndexTPU(codes),
                              None, True, ja.SEEDS_PER_BLOCK, pipe='v2')
    return codes, pairs, want


@pytest.mark.parametrize('keep', [False, True])
def test_all2all_v2_matches_reference(contigs16, keep):
    codes, pairs, want = contigs16
    got = ag._all2all_single(codes, pairs, keep_alignments=keep, pipe='v2',
                             device=CPU)
    _assert_equal(got, want, keep)
    assert (want[0][:, 0] > 0).sum() > len(pairs) // 8


@pytest.fixture(scope='module')
def hybrid(_jax_rows):
    """(codes, pairs, JAX (out, (rows, counts)), JAX AlignResult): the
    JAX run_align(engine='tpu', keep_alignments=True) of the hybrid corpus
    and what its all2all_tpu call returned (codes in ids order, all
    pairs, the defaults). With alignments kept the rows are the same as
    without."""
    seen = []
    real = ja.all2all_tpu

    def spy(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr('vclust_tpu.parallel.mesh.auto_mesh', lambda: None)
        mp.setattr(ja, 'all2all_tpu', spy)
        res = jalign.run_align(_hybrid_genomes(JGenome), engine='tpu',
                               keep_alignments=True)
    codes = _ids_codes(_hybrid_genomes(JGenome))
    return codes, _all_pairs(len(codes)), seen[0], res


def test_all2all_mixed_v3_v2_groups_match_reference(contigs16, hybrid,
                                                   monkeypatch):
    """The contigs' pairs (bucket 6,144) and the hybrid corpus' (4,096) in
    one call: with V3_MAX_BUCKET at 4,096 the contigs run on v2 and the
    rest on v3 (each group the same JAX program as its fixture's)."""
    c_codes, c_pairs, _ = contigs16
    h_codes, h_pairs = hybrid[:2]
    codes = c_codes + h_codes
    pairs = np.concatenate([c_pairs, h_pairs + len(c_codes)])
    monkeypatch.setattr(ja, 'V3_MAX_BUCKET', 4096)
    monkeypatch.setattr(ag, 'V3_MAX_BUCKET', 4096)
    want = ja._all2all_single(codes, pairs, None, ja.GenomeIndexTPU(codes),
                              None, True, ja.SEEDS_PER_BLOCK, pipe='v3')
    idx = ag.GenomeIndex(codes, device=CPU)
    got = ag._all2all_single(codes, pairs, index=idx, keep_alignments=True,
                             pipe='v3')
    _assert_equal(got, want, True)
    # Both pipes ran and aligned: bucket 4,096 on v3, 6,144 on v2.
    assert sorted(idx.bucket, key=str) == [(4096, 'v3'),
                                           (6144, ag.SEEDS_PER_BLOCK)]
    n2 = len(c_pairs)
    assert want[0][:n2, 0].any() and want[0][n2:, 0].any()


# --------------------------------------------------------------------------
# all2all_gpu: the hybrid, the two-phase screen, the dispatch rows
# --------------------------------------------------------------------------

def _hard(codes, pairs, out):
    """all2all_tpu's hard pairs of a v3 result."""
    lens = np.array([len(c) for c in codes], np.int64)
    lj, li = lens[pairs[:, 1]], lens[pairs[:, 0]]
    tani = (out[:, 1] + out[:, 4]) / (lj + li)
    return (tani > 0.05) & ((out[:, 2] / lj < ja.V3_RERUN_COV)
                            | (out[:, 5] / li < ja.V3_RERUN_COV))


@pytest.mark.parametrize('keep', [False, True])
def test_all2all_gpu_matches_all2all_tpu(hybrid, keep, monkeypatch):
    codes, pairs, want, _ = hybrid
    calls = []
    single = ag._all2all_single

    def spy(codes_, p, params, index, keep, C, pipe='v2'):
        calls.append((len(p), pipe))
        return single(codes_, p, params, index, keep, C, pipe)

    monkeypatch.setattr(ag, '_all2all_single', spy)
    got = ag.all2all_gpu(codes, pairs, keep_alignments=keep, device=CPU)
    _assert_equal(got, want, keep)
    # The hybrid re-ran a non-empty proper subset of the pairs on v2.
    v3 = single(codes, pairs, pipe='v3', device=CPU)
    hard = _hard(codes, pairs, v3)
    assert 0 < hard.sum() < len(pairs)
    assert calls == [(len(pairs), 'v3'), (int(hard.sum()), 'v2')]
    assert not np.array_equal(v3[hard], want[0][hard])


def _two_phase_genomes():
    """A 4 kb base with a ~75%-identity variant (inside the re-run band),
    a 3% variant (above it) and junk (below it)."""
    rng = np.random.default_rng(9)
    base = rng.integers(0, 4, 3600).astype(np.int8)

    def mut(rate):
        s = base.copy()
        m = rng.random(len(s)) < rate
        s[m] = rng.integers(0, 4, m.sum())
        return s

    return [base, mut(0.25), mut(0.03),
            rng.integers(0, 4, 3600).astype(np.int8)]


def test_all2all_gpu_two_phase_matches_reference(monkeypatch):
    codes = _two_phase_genomes()
    pairs = _all_pairs(len(codes))
    monkeypatch.setenv('VCLUST_ALIGN_PIPE', 'v2')
    monkeypatch.setattr(ja, 'TWO_PHASE_MIN_BUCKET', 4096)
    monkeypatch.setattr(ag, 'TWO_PHASE_MIN_BUCKET', 4096)
    want = ja.all2all_tpu(codes, pairs)
    calls = []
    single = ag._all2all_single

    def spy(codes_, p, params, index, keep, C, pipe='v2'):
        calls.append((len(p), C, pipe))
        return single(codes_, p, params, index, keep, C, pipe)

    monkeypatch.setattr(ag, '_all2all_single', spy)
    got = ag.all2all_gpu(codes, pairs, device=CPU)
    assert np.array_equal(got, want)
    # Every pair screened at PHASE1_C, the band again at full density.
    assert calls[0] == (len(pairs), ag.PHASE1_C, 'v2')
    assert len(calls) == 2 and 0 < calls[1][0] < len(pairs)
    assert calls[1][1:] == (ag.SEEDS_PER_BLOCK, 'v2')


def test_all2all_gpu_results_do_not_depend_on_dispatch_rows(hybrid,
                                                            monkeypatch):
    codes, pairs, want, _ = hybrid
    idx = ag.GenomeIndex(codes, device=CPU)
    outs = []
    for B in (1, 10 ** 6):
        monkeypatch.setattr(ag, '_dispatch_rows', lambda L, K, d, a: B)
        monkeypatch.setattr(ag, '_dispatch_rows_v2', lambda L, K, a: B)
        outs.append(ag.all2all_gpu(codes, pairs, index=idx,
                                   keep_alignments=True))
    for out in outs:
        _assert_equal(out, want, True)


def test_dispatch_rows_v2_follow_the_bytes():
    B = ag._dispatch_rows_v2(65536, 8, False)
    assert B == (2 << 30) // (8 * 65536 * ag._V2_BYTES_PER_POS)
    assert 1 <= ag._dispatch_rows_v2(65536, 8, True) < B
    assert ag._dispatch_rows_v2(65536, 1, False) > B
    assert ag._dispatch_rows_v2(4096, 8, False) > B
    assert ag._dispatch_rows_v2(1 << 20, 8, True) >= 1
    # Above the ladder a bucket is a multiple of 131,072, a Python int
    # whatever the length's type (an int32 one overflowed the bound).
    kb = ag._pad_bucket(np.int32(950_000))
    assert type(kb) is int and kb == 1 << 20
    assert ag._dispatch_rows_v2(kb, 1, False) > 1


# --------------------------------------------------------------------------
# the engine and the CLI
# --------------------------------------------------------------------------

def test_engine_rows_match_jax(hybrid):
    """run_align(engine='gpu') == the JAX run_align(engine='tpu') row for
    row on the multi-contig case and the rest of the hybrid corpus."""
    want = hybrid[3]
    got = talign.run_align(_hybrid_genomes(), engine='gpu')
    assert got.objects == want.objects
    assert [vars(r) for r in got.rows] == [vars(r) for r in want.rows]
    assert {'multi', 'multi.mut'} <= {r.query for r in got.rows}


def run_cli(main, args):
    """A CLI's main in-process; returns (exit code, stderr). The logger
    both packages configure ('vclust-tpu') is restored afterwards."""
    log = logging.getLogger('vclust-tpu')
    state = log.level, log.handlers[:], log.propagate
    err = io.StringIO()
    code = 0
    with contextlib.redirect_stderr(err):
        try:
            main([str(a) for a in args])
        except SystemExit as exc:
            code = int(exc.code or 0)
        finally:
            log.setLevel(state[0])
            log.handlers[:] = state[1]
            log.propagate = state[2]
    return code, err.getvalue()


_ALIGN_FILES = ('ani.tsv', 'ani.ids.tsv', 'ani.aln.tsv')


@pytest.fixture(scope='module')
def cli_runs(hybrid, tmp_path_factory):
    """The hybrid corpus as a FASTA through both CLIs' align with
    --out-aln, in-process: JAX `--engine tpu`, the port `--engine gpu` and
    `tpu`."""
    from vclust_tpu.cli import main as jax_main
    from vclust_tpu_torch.cli import main as port_main
    root = tmp_path_factory.mktemp('cli')
    gdir = write_hybrid_dir(root / 'genomes')
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr('vclust_tpu.parallel.mesh.auto_mesh', lambda: None)
        mp.setenv('VCLUST_TORCH_DEVICE', 'cpu')
        for who, engine in (('jax', 'tpu'), ('gpu', 'gpu'), ('tpu', 'tpu')):
            out = root / who
            out.mkdir()
            args = ['align', '-i', gdir, '-o', out / 'ani.tsv', '--out-aln',
                    out / 'ani.aln.tsv', '--engine', engine, '-v', '0']
            code, err = run_cli(jax_main if who == 'jax' else port_main,
                                args)
            assert code == 0, err
            outs[who] = out
    return outs


@pytest.mark.parametrize('name', _ALIGN_FILES)
def test_cli_align_files_match_jax(cli_runs, name):
    got = (cli_runs['gpu'] / name).read_bytes()
    assert got == (cli_runs['jax'] / name).read_bytes()
    assert got.count(b'\n') > 1


def test_cli_engine_tpu_equals_gpu(cli_runs):
    for name in _ALIGN_FILES:
        assert (cli_runs['tpu'] / name).read_bytes() == \
            (cli_runs['gpu'] / name).read_bytes()


def test_oversized_genome_routes_to_host_engine():
    """tests/test_align_tpu.py:151-173's case: a pair touching a genome
    beyond MAX_TPU_LEN goes to the exact native engine, as in the JAX
    package; the device entry point rejects it."""
    rng = np.random.default_rng(1)
    acgt = np.frombuffer(b'ACGT', dtype='S1')
    small = acgt[rng.integers(0, 4, 30_000)]
    big = np.concatenate([small] * 40)[: (1 << 20) + 500]
    mk = lambda cls: [cls('big', [big.tobytes()]),        # noqa: E731
                      cls('small', [small.tobytes()])]
    want = jalign.run_align(mk(JGenome), engine='tpu')
    got = talign.run_align(mk(Genome), engine='gpu')
    assert [vars(r) for r in got.rows] == [vars(r) for r in want.rows]
    rows = {(r.query, r.reference): r for r in got.rows}
    assert rows[('small', 'big')].qcov > 0.9
    codes = [np.zeros((1 << 20) + 8, np.int8), np.zeros(1000, np.int8)]
    with pytest.raises(ValueError):
        ag.all2all_gpu(codes, np.array([[0, 1]], np.int32), device=CPU)


def test_oversized_route_without_native_library(monkeypatch):
    """Without the native library the host route is the Python oracle
    (`_all2all_py`), with the same rows and records as the native engine
    (MAX_TPU_LEN lowered so the multi-contig genomes count as oversized)."""
    genomes = _hybrid_genomes()[4:]           # multi, multi.mut, junk
    exact = talign.run_align(genomes, engine='native', keep_alignments=True)
    monkeypatch.setattr(ag, 'MAX_TPU_LEN', 3500)
    native = talign.run_align(genomes, engine='gpu', keep_alignments=True)
    monkeypatch.setattr(talign.lz_native, 'available', lambda: False)
    py = talign.run_align(genomes, engine='gpu', keep_alignments=True)
    for res in (native, py):
        assert [vars(r) for r in res.rows] == [vars(r) for r in exact.rows]
        assert [vars(a) for a in res.alignments] == \
            [vars(a) for a in exact.alignments]
    assert exact.rows and exact.alignments


@pytest.mark.parametrize('native', [True, False])
def test_mixed_host_and_device_records_match_jax(hybrid, native,
                                                 monkeypatch):
    """Records of host and device pairs in one `--out-aln` run: a genome
    above MAX_TPU_LEN (the reference `a` with 1,500 more bases) goes to
    the host engine (7 record columns from the native library), the
    hybrid corpus stays on the device (6): rows and alignments equal the
    JAX `--engine tpu`'s. The device pairs are the hybrid fixture's, so
    the JAX side reuses its programs."""
    genomes = _hybrid_genomes()
    jgenomes = _hybrid_genomes(JGenome)
    rng = np.random.default_rng(6)
    tail = np.frombuffer(b'ACGT', dtype='S1')[rng.integers(0, 4, 1500)]
    big = genomes[0].seqs[0] + tail.tobytes()
    genomes.append(Genome('a.big', [big]))
    jgenomes.append(JGenome('a.big', [big]))
    monkeypatch.setattr(ja, 'MAX_TPU_LEN', 4000)
    monkeypatch.setattr(ag, 'MAX_TPU_LEN', 4000)
    want = jalign.run_align(jgenomes, engine='tpu', keep_alignments=True)
    if not native:
        monkeypatch.setattr(talign.lz_native, 'available', lambda: False)
    got = talign.run_align(genomes, engine='gpu', keep_alignments=True)
    assert [vars(r) for r in got.rows] == [vars(r) for r in want.rows]
    assert [vars(a) for a in got.alignments] == \
        [vars(a) for a in want.alignments]
    # Both routes gave records.
    refs = {(a.query, a.reference) for a in want.alignments}
    assert ('a', 'a.big') in refs and ('a', 'a.mut5') in refs
