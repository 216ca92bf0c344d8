"""The torch port's device ops against the JAX package, bit for bit.

On a box without CUDA the wrappers take their plain torch versions (the
tensors lie on the CPU); the JAX side runs on the CPU as its own tests run
it. Inputs are made from seeds with numpy and handed to both packages.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels.py and chip_smoke.py.
"""

import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

sys.path.insert(0, '.')

from vclust_tpu.ops import extend_pallas as jext                   # noqa: E402
from vclust_tpu.ops import prefilter as jpf                       # noqa: E402
from vclust_tpu.ops.cc import connected_components_device as jcc  # noqa: E402
from vclust_tpu.ops.lz_parse_py import AlignParams, _extend       # noqa: E402
from vclust_tpu_torch.ops import cc as tcc                         # noqa: E402
from vclust_tpu_torch.ops import extend as tx                      # noqa: E402
from vclust_tpu_torch.ops import prefilter as tpf                  # noqa: E402
from test_torch_kernels import kx_edge_jobs                        # noqa: E402

# Six pytest workers share the machine: one torch thread each.
torch.set_num_threads(1)


def _carry(ji):
    """The JAX package's index, carried across as numpy arrays."""
    return tpf.index_from_numpy(ji.n, ji.sizes, ji.gids, ji.lens, ji.weights,
                                ji.n_groups)


def _weighted_sets():
    # bench.py:124-134: dense sharing among 6 genomes -> weights > 255.
    rng = np.random.default_rng(7)
    universe = np.unique(rng.integers(0, 2 ** 50, 20000).astype(np.uint64))
    return [np.sort(np.unique(rng.choice(universe, 16000)))
            for _ in range(6)]


def _random_sets(n=40):
    rng = np.random.default_rng(11)
    universe = rng.choice(2 ** 40, size=3000, replace=False).astype(np.uint64)
    return [np.sort(universe[rng.random(len(universe))
                             < rng.uniform(0.05, 0.5)]) for _ in range(n)]


@pytest.fixture(scope='module')
def corpora():
    return {'weighted': _weighted_sets(), 'random40': _random_sets()}


# Small chunks so the count runs over many chunks (nnz_chunk must hold n).
CHUNKS = dict(rows_chunk=256, nnz_chunk=2048)


@pytest.mark.parametrize('name', ['weighted', 'random40'])
def test_k1_plain_matches_jax(corpora, name):
    sets = corpora[name]
    ji = jpf.PrefilterIndex(sets)
    want = jpf.shared_kmer_counts_indexed(ji, engine='device', **CHUNKS)
    ti = _carry(ji)
    got = tpf.shared_kmer_counts_indexed(ti, engine='device', device='cpu',
                                         **CHUNKS)
    assert np.array_equal(got, want)
    assert np.array_equal(got, jpf.shared_kmer_counts_host(sets))
    # The count above ran over chunks whose patterns are in weight-byte
    # order (the order K1 takes them in), merged into passes.
    _, chunks = tpf.device_chunks(ti, 'cpu', **CHUNKS)
    for c in chunks:
        for w in torch.split(c.weights, c.parts):
            assert np.all(np.diff(tpf._weight_bytes(w.numpy())) >= 0)
    if name == 'weighted':
        assert ji.weights.max() > 255
        assert {c.n_limbs for c in chunks} == {2}
    else:
        assert len(chunks) == 1 and len(chunks[0].parts) > 1


def _check_chunks_match_jax(ji, pass_bytes):
    """K1's passes hold the JAX package's chunks, whole, one to one and in
    order: same patterns and entries in each. Returns (passes, chunks) for
    small and for default chunks."""
    out = []
    for rows_chunk, nnz_chunk in ((256, 2048), (131072, 524288)):
        rc = max(1024, min(rows_chunk, (1 << 28) // (4 * (ji.n + 1))))
        rc, nc = jpf._adapt_chunks(ji.gids, ji.lens, ji.n, rc, nnz_chunk)
        _, want = jpf._chunk_groups(ji.lens, rc, nc)
        _, got = tpf.device_chunks(_carry(ji), 'cpu', rows_chunk, nnz_chunk)
        assert [p for c in got for p in c.parts] == \
            [hi - lo for lo, hi in want]
        for c in got:
            ng = int(c.weights.numel())
            assert len(c.parts) == 1 or \
                ji.n * -(-ng // tpf.K1_KBLOCK) * tpf.K1_KBLOCK <= pass_bytes
        weights = torch.cat([c.weights for c in got]).numpy()
        lens = torch.cat([c.offs.diff() for c in got]).numpy()
        for lo, hi in want:
            assert sorted(weights[lo:hi]) == sorted(ji.weights[lo:hi])
            assert lens[lo:hi].sum() == ji.lens[lo:hi].sum()
        out.append((len(got), len(want)))
    return out


def test_k1_chunks_match_jax(corpora):
    """Same chunking rules, so chunks match one to one; at this size every
    chunk fits one pass."""
    ji = jpf.PrefilterIndex(corpora['random40'])
    assert [p for p, _ in _check_chunks_match_jax(
        ji, tpf._K1_PASS_BYTES)] == [1, 1]


@pytest.mark.parametrize('pass_bytes', [0, 40 * 1024])
def test_k1_passes_are_runs_of_whole_chunks(corpora, monkeypatch,
                                            pass_bytes):
    """Smaller passes: one chunk each (0), or runs of a few chunks."""
    monkeypatch.setattr(tpf, '_K1_PASS_BYTES', pass_bytes)
    ji = jpf.PrefilterIndex(corpora['random40'])
    passes, chunks = _check_chunks_match_jax(ji, pass_bytes)[0]
    assert passes == chunks if pass_bytes == 0 else 1 < passes < chunks


def test_k1_weight_of_exactly_one_byte_limb_more():
    """A largest weight of exactly 256 needs two byte limbs; the count
    stays exact (equal to the host accumulation)."""
    idx = tpf.index_from_numpy(3, [10, 10, 10], [0, 1, 1, 2], [2, 2],
                               [256, 5])
    assert tpf._n_limbs(idx.weights) == 2
    got = tpf.shared_kmer_counts_indexed(idx, engine='device', device='cpu')
    assert np.array_equal(got, tpf._counts_from_index_host(idx))
    assert got[0, 1] == 256


def test_k1_shared_counts_dispatch(corpora):
    sets = corpora['random40']
    want = jpf.shared_kmer_counts_host(sets)
    assert np.array_equal(
        tpf.shared_kmer_counts(sets, backend='host'), want)
    assert np.array_equal(
        tpf.shared_kmer_counts(sets, device='cpu'), want)


def test_k1_wrapper_checks():
    idx = tpf.index_from_numpy(4, [9] * 4, [0, 1, 2], [3], [5])
    _, (chunk,) = tpf.device_chunks(idx, 'cpu')
    counts = torch.zeros((4, 4), dtype=torch.int32)
    tpf.occupancy_count(counts, chunk)
    assert counts[0, 1] == 5 and counts[2, 2] == 5 and counts[3, 3] == 0
    with pytest.raises(TypeError):
        tpf.occupancy_count(counts.long(), chunk)
    with pytest.raises(ValueError):
        tpf.occupancy_count(counts, chunk._replace(n_limbs=4))
    with pytest.raises(ValueError):
        tpf.occupancy_count(counts.t(), chunk)
    with pytest.raises(ValueError):
        tpf.occupancy_count(torch.zeros((5, 5), dtype=torch.int32), chunk)
    with pytest.raises(ValueError):
        tpf.occupancy_count(counts, chunk._replace(kb_limbs=torch.ones(
            2, dtype=torch.int32)))
    with pytest.raises(ValueError):
        tpf.occupancy_count(counts, chunk._replace(parts=(2,)))


EDGE_WEIGHTS = [1, 255, 256, 65535, 65536, 2 ** 24 - 1]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.one_of(st.sampled_from(EDGE_WEIGHTS),
                          st.integers(1, 2 ** 24 - 1)),
                min_size=1, max_size=700))
def test_k1_limb_plan_covers_every_weight(weights):
    """Each k-block's limb count covers the bytes of every weight in it (and
    is their largest byte count); the limb bytes rebuild each weight."""
    w = np.sort(np.asarray(weights, np.int64), kind='stable')
    w = w[np.argsort(tpf._weight_bytes(w), kind='stable')]
    wbytes, kb_limbs = tpf.k1_limb_plan(w)
    kb = np.arange(len(w)) // tpf.K1_KBLOCK
    nbytes = np.array([(int(x).bit_length() + 7) // 8 for x in w])
    assert len(kb_limbs) == -(-len(w) // tpf.K1_KBLOCK)
    assert np.all(kb_limbs[kb] >= nbytes)
    assert np.array_equal(kb_limbs, [nbytes[kb == k].max()
                                     for k in range(len(kb_limbs))])
    flat = wbytes.transpose(0, 2, 1).reshape(-1, 3).astype(np.int64)
    rebuilt = flat[:, 0] + (flat[:, 1] << 8) + (flat[:, 2] << 16)
    assert np.array_equal(rebuilt[:len(w)], w)
    assert not rebuilt[len(w):].any()
    # Within a chunk in weight-byte order, the limb counts only grow.
    assert np.all(np.diff(kb_limbs) >= 0)


@pytest.mark.parametrize('n,nkb,n_sms', [
    (48, 48, 132), (48, 1, 132), (33, 7, 132), (200, 40, 132),
    (1536, 19, 132), (1000, 3, 132), (2049, 5, 132), (16384, 31, 132),
    (300, 64, 8)])
def test_k1_work_covers_each_upper_tile_and_kblock_once(n, nkb, n_sms):
    rng = np.random.default_rng(n + nkb)
    kb_limbs = np.sort(rng.integers(1, 4, nkb)).astype(np.int32)
    tiles = tpf.k1_tiles(n)
    work, split = tpf.k1_work(tiles, kb_limbs, n_sms)
    nt = -(-n // tpf.K1_TILE)
    cover = np.zeros((nt, nt, nkb), np.int64)
    for ti, tj, lo, hi in work:
        assert ti <= tj and lo < hi
        cover[ti, tj, lo:hi] += 1
    upper = np.triu(np.ones((nt, nt), bool))
    assert np.all(cover[upper] == 1) and not cover[~upper].any()
    assert len(work) == len(tiles) * split
    # Split-K when the tiles are fewer than the SMs: enough k ranges to
    # give each SM a CTA, as the k-blocks allow (equal limb products may
    # merge a few ranges).
    want = 1 if len(tiles) >= n_sms else min(nkb, -(-n_sms // len(tiles)))
    assert split <= want and (split == want or split > want // 2)
    if want == nkb:
        assert split == nkb    # one k-block a CTA
    # One tile of many k-blocks split a k-block a CTA is small enough to
    # build from the COO; CTAs of many k-blocks are not.
    if len(tiles) == 1 and nkb >= 40:
        assert tpf.k1_from_coo(work, 50_000)
        assert not tpf.k1_from_coo(work, tpf._K1_COO_READS + 1)
    if split == 1 and nkb > tpf._K1_COO_KBLOCKS:
        assert not tpf.k1_from_coo(work, 1000)


def test_batch_store_blocks_match_dense(tmp_path, corpora):
    sets = corpora['random40']
    dense = jpf.shared_kmer_counts_host(sets)
    store = tpf.BatchIndexStore(tmp_path)
    for lo in range(0, len(sets), 15):
        store.add_batch(sets[lo:lo + 15], lo)
    out = np.zeros_like(dense)
    nb = len(store.batches)
    for i in range(nb):
        for j in range(i, nb):
            ro, co, block = store.pair_block(i, j, device='cpu')
            out[ro:ro + block.shape[0], co:co + block.shape[1]] = block
            out[co:co + block.shape[1], ro:ro + block.shape[0]] = block.T
    assert np.array_equal(out, dense)


# --------------------------------------------------------------------------
# The unweighted and panel counts (K1 at weight 1, and in window mode)
# --------------------------------------------------------------------------

def _small_sets(rng, n, lo=50, hi=500):
    # tests/test_ops.py:_random_sets
    return [np.unique(rng.integers(0, 10_000, int(rng.integers(lo, hi)))
                      .astype(np.uint64)) for _ in range(n)]


@pytest.mark.parametrize('n,lo,hi,seed,kw', [
    (12, 50, 500, 42, {}),                       # tests/test_ops.py:22-26
    (5, 500, 2000, 1, dict(rows_chunk=256))])    # :29-34, many chunks
def test_unweighted_device_counts_match_jax(n, lo, hi, seed, kw):
    sets = _small_sets(np.random.default_rng(seed), n, lo, hi)
    want = jpf.shared_kmer_counts_device(sets, **kw)
    got = tpf.shared_kmer_counts_device(sets, device='cpu', **kw)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    assert np.array_equal(got, jpf.shared_kmer_counts_host(sets))


def _panel_sets(n, universe_size=800, seed=11):
    rng = np.random.default_rng(seed)
    universe = rng.choice(2 ** 40, size=universe_size,
                          replace=False).astype(np.uint64)
    return [np.sort(universe[rng.random(len(universe))
                             < rng.uniform(0.02, 0.2)]) for _ in range(n)]


@pytest.mark.parametrize('n,panel,kw', [
    (23, 7, dict(rows_chunk=512, nnz_chunk=4096)),  # tests/test_ops.py:93-110
    (300, 128, {}),                                 # 128-aligned panels
    (300, 100, dict(nnz_chunk=4096))])              # unaligned, chunked
def test_panel_counts_match_jax(n, panel, kw):
    sets = (_panel_sets(n, 3000) if n == 23 else _panel_sets(n))
    dense = jpf.shared_kmer_counts_host(sets)
    want = list(jpf.shared_kmer_counts_panels(sets, panel=panel, **kw))
    got = list(tpf.shared_kmer_counts_panels(sets, panel=panel,
                                             device='cpu', **kw))
    assert [g[:2] for g in got] == [w[:2] for w in want]
    out = np.zeros_like(dense)
    for (lo, hi, block), (_, _, jblock) in zip(got, want):
        assert block.shape == (hi - lo, n) and block.dtype == np.int64
        assert np.array_equal(block, jblock)
        out[lo:hi] = block
    assert np.array_equal(out, dense)


def _index300(seed=5, n=300, n_patterns=700):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 40, n_patterns).astype(np.int32)
    gids = np.concatenate([np.sort(rng.choice(n, ln, replace=False))
                           for ln in lens])
    weights = rng.integers(1, 70_000, n_patterns)
    return tpf.index_from_numpy(n, np.full(n, 10 ** 6), gids, lens, weights)


@pytest.mark.parametrize('row0,rows', [(0, 128), (128, 172), (256, 44),
                                       (0, 300)])
def test_k1_window_matches_dense_rows(row0, rows):
    """K1's window on the CPU (`occupancy_count` of a pass planned for the
    window: whole, then a part of its work list the way a shard gets it)
    == the rows of the square count."""
    idx = _index300()
    n = idx.n
    _, square = tpf.device_chunks(idx, 'cpu', nnz_chunk=2048)
    dense = torch.zeros((n, n), dtype=torch.int32)
    for c in square:
        tpf.occupancy_count(dense, c)
    passes = tpf.k1_passes(n, idx.gids, idx.lens, idx.weights, 'cpu', 1024,
                           2048, window=(row0, rows))
    assert len(passes) == len(square) == 1 and len(passes[0].parts) > 1
    got = torch.zeros((rows, n), dtype=torch.int32)
    for c in passes:
        # Every tile of the row band, each k-block once.
        tiles = {tuple(t) for t in c.work[:, :2].tolist()}
        assert tiles == {tuple(t) for t in tpf.k1_panel_tiles(row0, rows, n)}
        assert tpf._work_is_whole(c)
        tpf.occupancy_count(got, c)
    assert torch.equal(got, dense[row0:row0 + rows])
    assert torch.equal(
        tpf.occupancy_count_plain(torch.zeros_like(got), passes[0].gids,
                                  passes[0].offs, passes[0].weights,
                                  row0=row0),
        tpf.occupancy_count_plain(torch.zeros((n, n), dtype=torch.int32),
                                  passes[0].gids, passes[0].offs,
                                  passes[0].weights)[row0:row0 + rows])
    parts = torch.zeros_like(got)
    for c in passes:
        for w in tpf.k1_split_work(c.work.numpy(), c.kb_limbs.numpy(), 3):
            if len(w):
                sub = tpf.k1_shard(c, w, 'cpu')
                assert not tpf._work_is_whole(sub)
                tpf.occupancy_count(parts, sub)
    assert torch.equal(parts, got)


@pytest.mark.parametrize('items,nkb,parts', [(1, 1, 3), (5, 7, 2),
                                             (132, 1, 8), (40, 9, 3)])
def test_k1_split_work_is_contiguous_and_balanced(items, nkb, parts):
    rng = np.random.default_rng(items + parts)
    kb_limbs = np.sort(rng.integers(1, 4, nkb)).astype(np.int32)
    lo = rng.integers(0, nkb, items)
    work = np.column_stack([np.arange(items), np.arange(items), lo,
                            lo + 1]).astype(np.int32)
    runs = tpf.k1_split_work(work, kb_limbs, parts)
    assert len(runs) == parts
    assert np.array_equal(np.concatenate(runs), work)
    cost = [int(kb_limbs[r[:, 2]].sum()) for r in runs]
    assert max(cost) - min(cost) <= 2 * kb_limbs.max() or items < parts


# --------------------------------------------------------------------------
# KX
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def seqs():
    # tests/test_extend_pallas.py's sequences.
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 4, 1500).astype(np.int8)
    q = ref.copy()
    sub = rng.random(len(q)) < 0.05
    q[sub] = (q[sub] + rng.integers(1, 4, sub.sum()).astype(np.int8)) % 4
    q[700:707] = 4   # N run
    return q, ref


def _check_kx(q, r, jobs, p):
    qi = np.array([a for a, _ in jobs], np.int32)
    ri = np.array([b for _, b in jobs], np.int32)
    lens, matches = tx.batched_extend(tx.pad_codes(q), tx.pad_codes(r), qi,
                                      ri, len(q), len(r), p.aw, p.am, p.ar,
                                      device='cpu')
    got = list(zip(lens.tolist(), matches.tolist()))
    assert got == [_extend(q, r, a, b, 0, p) for a, b in jobs]


def test_kx_matches_oracle(seqs):
    q, ref = seqs
    rng = np.random.default_rng(1)
    jobs = [(int(rng.integers(0, len(q) - 50)),) * 2 for _ in range(8)]
    jobs += [(int(rng.integers(0, len(q) - 50)),
              int(rng.integers(0, len(ref) - 50))) for _ in range(8)]
    _check_kx(q, ref, jobs, AlignParams())


def test_kx_sequence_ends(seqs):
    q, ref = seqs
    jobs = [(len(q) - 10, len(ref) - 10), (len(q) - 1, 0),
            (0, len(ref) - 1), (0, 0), (len(q), 0), (0, len(ref))]
    _check_kx(q, ref, jobs, AlignParams())


def test_kx_long_exact():
    rng = np.random.default_rng(2)
    ref = rng.integers(0, 4, 2500).astype(np.int8)
    _check_kx(ref.copy(), ref, [(0, 0), (1, 1), (1200, 1200)],
              AlignParams())


@pytest.mark.parametrize('aw,am,ar', [(15, 7, 3), (1, 0, 1), (32, 10, 32),
                                      (8, 3, 5)])
def test_kx_random_jobs(seqs, aw, am, ar):
    q, ref = seqs
    rng = np.random.default_rng(aw * 100 + ar)
    jobs = [(int(a),) * 2 for a in rng.integers(0, len(q), 150)]
    jobs += [(int(a), int(b)) for a, b in zip(rng.integers(0, len(q), 150),
                                              rng.integers(0, len(ref), 150))]
    _check_kx(q, ref, jobs, AlignParams(aw=aw, am=am, ar=ar))


def test_kx_cap():
    """An identical run longer than the cap stops at CAP bases."""
    n = tx.CAP + 3000
    codes = np.random.default_rng(3).integers(0, 4, n).astype(np.int8)
    lens, matches = tx.batched_extend(
        tx.pad_codes(codes), tx.pad_codes(codes), np.array([0, 5], np.int32),
        np.array([0, 5], np.int32), n, n, device='cpu')
    assert lens.tolist() == [tx.CAP, tx.CAP]
    assert matches.tolist() == [tx.CAP, tx.CAP]


def test_kx_wrapper_checks(seqs):
    q, ref = seqs
    with pytest.raises(ValueError):
        tx.batched_extend(tx.pad_codes(q), tx.pad_codes(ref),
                          np.zeros(1, np.int32), np.zeros(1, np.int32),
                          len(q), len(ref), aw=33, device='cpu')
    with pytest.raises(ValueError):
        tx.batched_extend(tx.pad_codes(q), tx.pad_codes(ref),
                          np.array([-1], np.int32), np.zeros(1, np.int32),
                          len(q), len(ref), device='cpu')
    t = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        tx.extend(t, t, t, t, 4, 4)
    empty = tx.batched_extend(tx.pad_codes(q), tx.pad_codes(ref),
                              np.empty(0, np.int32), np.empty(0, np.int32),
                              len(q), len(ref), device='cpu')
    assert [len(x) for x in empty] == [0, 0]


# The kernel's decomposition: ranges summarised apart, combined in order.
KX_CHUNKS = (32, 64, 1024)
# Chunk edges chunk * k for k = 1 and 3, and one job 40 chunks of 32 in.
KX_EDGES = sorted({c * k for c in KX_CHUNKS for k in (1, 3)} | {32 * 40})


def _kx_tensors(q, r, qi, ri):
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32).reshape(-1))
            for a in (tx.pad_codes(q), tx.pad_codes(r), qi, ri)]


@pytest.fixture(scope='module')
def kx_edge_case():
    """The chunk-edge jobs at the default parameters and the JAX package's
    batched_extend on them: one interpret-mode run for the module."""
    p = AlignParams()
    q, r, qi, ri = kx_edge_jobs(KX_EDGES, p.aw, p.am, p.ar)
    want = jext.batched_extend(jext.pad_codes(q), jext.pad_codes(r), qi, ri,
                               len(q), len(r), p.aw, p.am, p.ar)
    return (q, r, qi, ri), [np.asarray(w) for w in want]


@pytest.mark.parametrize('chunk', KX_CHUNKS)
def test_kx_chunked_model_matches_jax(kx_edge_case, chunk):
    """A violation, a cut, an N run and a limit at chunk * k - 1, chunk * k
    and chunk * k + aw - 2: the model == extend_plain == the JAX kernel."""
    (q, r, qi, ri), want = kx_edge_case
    p = AlignParams()
    args = _kx_tensors(q, r, qi, ri)
    got = tx.extend_chunked_plain(*args, len(q), len(r), p.aw, p.am, p.ar,
                                  chunk)
    plain = tx.extend_plain(*args, len(q), len(r), p.aw, p.am, p.ar)
    for g, pl, w in zip(got, plain, want):
        assert np.array_equal(g.numpy(), w)
        assert np.array_equal(pl.numpy(), w)


@pytest.mark.parametrize('chunk', KX_CHUNKS)
@pytest.mark.parametrize('aw,am,ar', [(1, 0, 1), (32, 10, 32), (8, 3, 5)])
def test_kx_chunked_model_matches_plain(chunk, aw, am, ar):
    q, r, qi, ri = kx_edge_jobs(KX_EDGES, aw, am, ar, seed=aw)
    args = _kx_tensors(q, r, qi, ri)
    got = tx.extend_chunked_plain(*args, len(q), len(r), aw, am, ar, chunk)
    want = tx.extend_plain(*args, len(q), len(r), aw, am, ar)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_kx_chunked_model_cap_and_starts(seqs):
    """The cap, sequence ends, a negative start and odd chunk lengths."""
    n = tx.CAP + 3000
    codes = np.random.default_rng(3).integers(0, 4, n).astype(np.int8)
    args = _kx_tensors(codes, codes, np.array([0, 5, -1, n - 7], np.int32),
                       np.array([0, 5, 0, n - 7], np.int32))
    for chunk in (4096, 2048 * 16 + 1):
        got = tx.extend_chunked_plain(*args, n, n, 15, 7, 3, chunk)
        assert [g.tolist() for g in got] == [[tx.CAP, tx.CAP, 0, 7]] * 2
    q, ref = seqs
    args = _kx_tensors(q, ref, np.arange(0, 1500, 7, dtype=np.int32),
                       np.arange(0, 1500, 7, dtype=np.int32)[::-1].copy())
    want = tx.extend_plain(*args, len(q), len(ref), 15, 7, 3)
    for chunk in (1, 33):
        got = tx.extend_chunked_plain(*args, len(q), len(ref), 15, 7, 3,
                                      chunk)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_kx_kernel_ranges():
    """The ranges csrc/extend.cu summarises apart tile [0, limit): A's
    [0, FIRST), then rounds of WARPS ranges doubling to SUB0 << DOUBLINGS."""
    for limit in (1, tx.FIRST, tx.FIRST + 1, 20_000, tx.CAP):
        rounds = tx.kernel_ranges(limit)
        flat = [rg for rd in rounds for rg in rd]
        assert flat[0] == (0, min(limit, tx.FIRST))
        assert all(a[1] == b[0] for a, b in zip(flat, flat[1:]))
        assert flat[-1][1] == limit
        assert all(len(rd) <= tx.WARPS for rd in rounds[1:])
        assert all(s % 32 == 0 for s, _ in flat)
    sizes = [rd[0][1] - rd[0][0] for rd in tx.kernel_ranges(tx.CAP)[1:]]
    assert sizes[:5] == [256, 512, 1024, 2048, 2048]
    assert tx.kernel_ranges(0) == []


# --------------------------------------------------------------------------
# Connected components
# --------------------------------------------------------------------------

def _union_find(n, edges):
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return np.array([find(i) for i in range(n)])


@pytest.mark.parametrize('n,n_edges,seed', [(500, 300, 3), (2000, 1900, 4),
                                            (64, 500, 5)])
def test_cc_matches_jax_and_union_find(n, n_edges, seed):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (n_edges, 2)).astype(np.int32)
    got = tcc.connected_components_device(n, edges, device='cpu')
    assert got.dtype == np.int32
    assert np.array_equal(got, jcc(n, edges))
    assert np.array_equal(got, _union_find(n, edges))


def test_cc_empty():
    assert tcc.connected_components_device(
        0, np.empty((0, 2)), device='cpu').tolist() == []
    assert tcc.connected_components_device(
        3, np.empty((0, 2)), device='cpu').tolist() == [0, 1, 2]
