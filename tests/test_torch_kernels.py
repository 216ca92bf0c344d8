"""The torch port's CUDA kernels against their plain torch versions.

These need a CUDA card and skip without one (marker `gpu`). The file
imports no JAX, so it runs where only torch is installed:

    python -m pytest -m gpu tests/test_torch_kernels.py

On a box without CUDA, the wrapper-dispatch tests below still run: a
wrapper answers CPU tensors with its plain version.
"""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, '.')

from back_half_cases import (CASES, K3_ARGS, K5_ARGS,  # noqa: E402
                             PARAMS, back_half_case, bands_case, chain_case,
                             last_chunk_case, long_segment_case,
                             propagate_case, sparse_cap_case, torch_args)
from cc_cases import (build_edges_order, least_member_labels,  # noqa
                      model_graphs, near_ids, random_graph, star, union_find)
from index_cases import index_genomes, padded  # noqa: E402
from v2_cases import (CRAFTED, chain_election, clipped_election,  # noqa
                      crafted_case, distinct_election, election_case,
                      random_election, relay_election, v2_arena, v2_genomes,
                      v2_rows)
from vclust_tpu_torch.ops import align_gpu as tav  # noqa: E402
from vclust_tpu_torch.ops import cc as tcc         # noqa: E402
from vclust_tpu_torch.ops import extend as tx      # noqa: E402
from vclust_tpu_torch.ops import prefilter as tpf  # noqa: E402

# Six pytest workers share the machine: one torch thread each.
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _index(seed, n, n_patterns, max_len, max_w):
    """A random index; max_w='mixed' draws one, two and three-byte weights
    (edges included) in equal shares, so chunks hold every limb class."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, max_len + 1, n_patterns).astype(np.int32)
    gids = np.concatenate([np.sort(rng.choice(n, ln, replace=False))
                           for ln in lens])
    if max_w == 'mixed':
        lo = np.array([1, 256, 65536])[rng.integers(0, 3, n_patterns)]
        weights = np.minimum(lo * rng.integers(1, 256, n_patterns),
                             2 ** 24 - 1)
        weights[:4] = [255, 256, 65535, 2 ** 24 - 1]
    else:
        weights = rng.integers(1, max_w + 1, n_patterns)
    return tpf.index_from_numpy(n, np.full(n, 10 ** 6), gids, lens, weights)


def _seqs(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, n).astype(np.int8)
    q = ref.copy()
    sub = rng.random(n) < 0.05
    q[sub] = (q[sub] + rng.integers(1, 4, sub.sum()).astype(np.int8)) % 4
    q[700:707] = 4
    return q, ref


def kx_edge_jobs(edges, aw, am, ar, seed=0):
    """Codes (q, r) and int32 job starts (qi, ri) that put each kind of
    event at each of the positions b - 1, b and b + aw - 2 of a job, for
    every b in `edges` (positions count from the job's start): the first
    violation (am + 1 mismatches ending there), the cut (the same block
    starting just after it), an N run of am starting there (no violation;
    a block of am + 1 mismatches ends the job later), an N run ending there
    that violates, and the limit (a job that far from the end). Each job
    has a region of its own; q equals r (random bases) elsewhere. Also 32
    random jobs, most at unrelated offsets."""
    rng = np.random.default_rng(seed)
    spots = sorted({b + d for b in edges for d in (-1, 0, aw - 2)})
    block = am + 1
    regions = []                          # (kind, x)
    for x in spots:
        regions += [(k, x) for k in ('viol', 'cut', 'n_run', 'n_viol')]
    tail = max(spots) + 64
    n = sum(x + 3 * block + 2 * aw + 64 for _, x in regions) + tail
    r = rng.integers(0, 4, n).astype(np.int8)
    q = r.copy()

    def mismatch(lo, hi):
        q[lo:hi] = (r[lo:hi] + 1) % 4

    starts, at = [], 0
    for kind, x in regions:
        s = at
        if kind == 'viol':
            mismatch(s + x - am, s + x + 1)
        elif kind == 'cut':
            mismatch(s + x + 1, s + x + 1 + block)
        elif kind == 'n_run':
            q[s + x:s + x + am] = 4
            mismatch(s + x + am + aw, s + x + am + aw + block)
        else:
            q[s + x - am:s + x + 1] = 4
        starts.append(s)
        at = s + x + 3 * block + 2 * aw + 64
    starts += [n - x for x in spots]       # limits
    qi = np.array(starts, np.int64)
    ri = qi.copy()
    qi = np.concatenate([qi, rng.integers(0, n, 32)])
    ri = np.concatenate([ri, rng.integers(0, n, 24), qi[-8:]])
    return q, r, qi.astype(np.int32), ri.astype(np.int32)


def _k1_both(index, device, **chunking):
    n = index.n
    _, chunks = tpf.device_chunks(index, device, **chunking)
    k = torch.zeros((n, n), dtype=torch.int32, device=device)
    p = torch.zeros_like(k)
    for c in chunks:
        tpf.occupancy_count(k, c)
        tpf.occupancy_count_plain(p, c.gids, c.offs, c.weights)
    return k, p, chunks


# rows_chunk 1024: chunks of at most 8 k-blocks, one launch each
SMALL_CHUNKS = 'small'
# the same chunks merged into passes, as many as fit one launch
MERGED = 'merged'


@pytest.mark.gpu
@pytest.mark.parametrize('n,n_patterns,max_len,max_w,chunking', [
    (6, 40, 6, 300, SMALL_CHUNKS), (70, 3000, 20, 255, SMALL_CHUNKS),
    (200, 5000, 64, 70000, SMALL_CHUNKS),
    (1000, 300, 256, 2 ** 24 - 1, SMALL_CHUNKS),
    # ragged and diagonal tiles
    (33, 2000, 20, 70000, SMALL_CHUNKS), (48, 2500, 30, 300, SMALL_CHUNKS),
    (65, 1500, 40, 'mixed', SMALL_CHUNKS), (130, 3000, 64, 70000, None),
    (200, 800, 100, 2 ** 24 - 1, None),
    # one chunk of > 6,000 patterns on 48 genomes: one tile, split-K; and
    # of 40,000, whose CTAs walk 3 k-blocks: TMA loads of a 48-row tile
    (48, 6100, 30, 70000, None), (48, 40000, 30, 70000, None),
    # every limb class in one chunk
    (300, 4000, 50, 'mixed', None),
    # many chunks, one launch each or all in one pass (whose diagonal sums
    # stay below 2^31, where the plain version's float64 sums convert)
    (200, 24000, 20, 'mixed', SMALL_CHUNKS),
    (200, 24000, 20, 70000, MERGED),
    # occupancy scattered and loaded by TMA (`k1_from_coo` false): split-K
    # with n % 4 == 0 and != 0 epilogues, and 153 tiles without split-K
    (520, 6000, 200, 70000, None), (1001, 3000, 64, 'mixed', None),
    (2101, 1500, 100, 70000, None)])
def test_k1_kernel_matches_plain(cuda_device, monkeypatch, n, n_patterns,
                                 max_len, max_w, chunking):
    idx = _index(n + n_patterns, n, n_patterns, min(max_len, n), max_w)
    kw = {}
    if chunking is not None:
        kw = dict(rows_chunk=1024, nnz_chunk=max(2048, n + 1))
    if chunking == SMALL_CHUNKS:
        monkeypatch.setattr(tpf, '_K1_PASS_BYTES', 0)
    k, p, chunks = _k1_both(idx, cuda_device, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert torch.equal(k, k.T)
    if n_patterns > 6000 and chunking is None:
        assert len(chunks) == 1 and chunks[0].split > 1
    if max_w == 'mixed' and chunking is None:
        assert set(torch.cat([c.kb_limbs for c in chunks]).tolist()) == \
            {1, 2, 3}
    if n_patterns >= 24000 and chunking is not None:
        assert (len(chunks) >= 20 if chunking == SMALL_CHUNKS else
                len(chunks) == 1 and len(chunks[0].parts) >= 20)


@pytest.mark.gpu
@pytest.mark.parametrize('n,n_patterns,max_w,row0,rows', [
    # one tile row, split-K, the occupancy built from the COO
    (300, 2000, 1, 128, 128), (300, 2000, 70000, 256, 44),
    # n % 4 != 0: the element-wise epilogue, at a ragged band end
    (1001, 3000, 'mixed', 896, 105), (1001, 3000, 1, 0, 1001),
    # many tiles a band: TMA loads of a scattered occupancy
    (2101, 1500, 70000, 512, 640), (520, 6000, 1, 384, 136)])
def test_k1_window_kernel_matches_plain(cuda_device, n, n_patterns, max_w,
                                        row0, rows):
    """K1 in window mode (each tile of the row band added once, at its
    window row) == the plain version over the same window."""
    idx = _index(n + row0, n, n_patterns, min(100, n), max_w)
    chunks = tpf.k1_passes(n, idx.gids, idx.lens, idx.weights, cuda_device,
                           1 << 16, 1 << 20, window=(row0, rows))
    k = torch.zeros((rows, n), dtype=torch.int32, device=cuda_device)
    p = torch.zeros_like(k)
    for c in chunks:
        tpf.occupancy_count(k, c)
        tpf.occupancy_count_plain(p, c.gids, c.offs, c.weights, row0=row0)
    torch.cuda.synchronize()
    assert torch.equal(k, p)


@pytest.mark.gpu
@pytest.mark.parametrize('n,n_patterns,max_w,shards', [
    (48, 6100, 70000, 3), (300, 4000, 'mixed', 2), (1001, 3000, 70000, 3),
    (2101, 1500, 70000, 2)])
def test_k1_split_work_matches_whole(cuda_device, n, n_patterns, max_w,
                                     shards):
    """K1 over a mesh of shards on one card (each pass's work list cut
    among them, their parts added into the card's one counts) == K1
    unsharded."""
    from vclust_tpu_torch.parallel.mesh import make_mesh
    idx = _index(n + shards, n, n_patterns, min(100, n), max_w)
    want = tpf.shared_kmer_counts_indexed(idx, engine='device',
                                          device=cuda_device)
    before = tpf.occupancy_count.launches
    got = tpf.shared_kmer_counts_indexed(
        idx, mesh=make_mesh(shards, device=cuda_device))
    assert np.array_equal(got, want)
    assert tpf.occupancy_count.launches - before >= shards


@pytest.mark.gpu
def test_mesh_dry_run_on_one_card(cuda_device):
    from vclust_tpu_torch.entry import dryrun_multichip, entry
    fn, args = entry()
    counts, sim, keep = fn(*args)
    want = args[0].int().cpu() @ args[0].int().cpu().T
    assert torch.equal(counts.cpu(), want)
    dryrun_multichip(2, device=cuda_device)


@pytest.mark.gpu
def test_kx_kernel_matches_plain(cuda_device):
    q, ref = _seqs()
    rng = np.random.default_rng(9)
    starts = [rng.integers(0, len(q), 500), rng.integers(0, len(ref), 500)]
    same = rng.integers(0, len(q), 500)
    args = [torch.from_numpy(a.astype(np.int32).reshape(-1)).to(cuda_device)
            for a in (tx.pad_codes(q), tx.pad_codes(ref),
                      np.concatenate([starts[0], same]),
                      np.concatenate([starts[1], same]))]
    for aw, am, ar in ((15, 7, 3), (1, 0, 1), (32, 10, 32), (8, 3, 5)):
        got = tx.extend(*args, len(q), len(ref), aw, am, ar)
        want = tx.extend_plain(*args, len(q), len(ref), aw, am, ar)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _kx_on(device, q, r, qi, ri, aw=15, am=7, ar=3):
    """KX and extend_plain on the same device tensors; plain's scanned."""
    args = [torch.from_numpy(np.ascontiguousarray(a, np.int32).reshape(-1)
                             ).to(device)
            for a in (tx.pad_codes(q), tx.pad_codes(r), qi, ri)]
    got = tx.extend(*args, len(q), len(r), aw, am, ar)
    *want, scanned = tx.extend_plain(*args, len(q), len(r), aw, am, ar,
                                     return_scanned=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    return scanned.cpu().numpy()


def _kx_long_seqs(n=400_000, seed=4):
    """q == r up to substitutions whose rate changes every 20,000 bases
    (0 to 4%), with N runs of 7: job lengths from a few bases to the cap."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 4, n).astype(np.int8)
    rate = np.repeat(rng.choice([0.0, 0.001, 0.01, 0.02, 0.04], n // 20_000),
                     20_000)
    q = r.copy()
    sub = rng.random(n) < rate
    q[sub] = (q[sub] + 1) % 4
    for at in rng.integers(0, n - 7, 20):
        q[at:at + 7] = 4
    return q, r


@pytest.mark.gpu
def test_kx_kernel_chunk_edges(cuda_device):
    """Events at b - 1, b and b + aw - 2 of every range start b the kernel
    uses up to its fifth round of launch B, and at A's end."""
    rounds = tx.kernel_ranges(tx.CAP)
    edges = sorted({rd[i][0] for rd in rounds[1:6] for i in (0, 1, -1)}
                   | {rounds[6][0][0]})
    for aw, am, ar in ((15, 7, 3), (32, 10, 32)):
        q, r, qi, ri = kx_edge_jobs(edges, aw, am, ar)
        sc = _kx_on(cuda_device, q, r, qi, ri, aw, am, ar)
        assert (sc > tx.FIRST).sum() >= 3 * 4 * len(edges)


@pytest.mark.gpu
@pytest.mark.parametrize('aw,am,ar', [(15, 7, 3), (1, 0, 1), (32, 10, 32),
                                      (8, 3, 5)])
def test_kx_kernel_many_jobs_past_first(cuda_device, aw, am, ar):
    """Thousands of jobs past launch A's FIRST positions: B has work for
    every CTA, and long jobs take many rounds."""
    q, r = _kx_long_seqs()
    rng = np.random.default_rng(aw)
    qi = rng.integers(0, len(q), 6000).astype(np.int32)
    ri = qi.copy()
    ri[:500] = rng.integers(0, len(r), 500)
    sc = _kx_on(cuda_device, q, r, qi, ri, aw, am, ar)
    if (aw, am, ar) == (15, 7, 3):
        assert (sc > tx.FIRST).sum() > 1000 and sc.max() > 100_000


@pytest.mark.gpu
def test_kx_kernel_nothing_past_first(cuda_device):
    """No job outlives launch A (the sequences are shorter than FIRST): B
    finds an empty list."""
    q, r = _seqs(n=tx.FIRST - 1)
    rng = np.random.default_rng(5)
    qi = rng.integers(0, len(q), 3000).astype(np.int32)
    ri = rng.integers(0, len(r), 3000).astype(np.int32)
    ri[:1000] = qi[:1000]
    sc = _kx_on(cuda_device, q, r, qi, ri)
    assert sc.max() <= tx.FIRST


@pytest.mark.gpu
def test_kx_kernel_cap_and_single_jobs(cuda_device):
    n = tx.CAP + 3000
    codes = np.random.default_rng(3).integers(0, 4, n).astype(np.int8)
    one = np.zeros(1, np.int32)
    sc = _kx_on(cuda_device, codes, codes, np.array([0, 5, 0], np.int32),
                np.array([0, 5, 9], np.int32))
    assert sc[:2].tolist() == [tx.CAP, tx.CAP]
    for start in (0, n - tx.FIRST - 1, n - 40):   # n_jobs = 1
        _kx_on(cuda_device, codes, codes, one + start, one + start)
    dev = cuda_device
    args = [torch.from_numpy(tx.pad_codes(codes).reshape(-1)).to(dev)] * 2
    lens, matches = tx.extend(*args, torch.zeros(1, dtype=torch.int32,
                                                  device=dev),
                              torch.zeros(1, dtype=torch.int32, device=dev),
                              n, n)
    assert (int(lens[0]), int(matches[0])) == (tx.CAP, tx.CAP)


def _stage1_inputs(seed, K, M2, NRB, H, rows=3, zero=False, ties=False,
                   G=5):
    """Random {0,1} arenas of G rows for K2: (qocc, rocc, r_rows, q_rows).
    zero: all-zero rows in both arenas; ties: reference rows repeated, so
    counts tie between reference blocks (the larger block must win)."""
    rng = np.random.default_rng(seed)
    qocc = (rng.random((G, M2, H)) < 0.04).astype(np.int8)
    rocc = (rng.random((G, NRB, H)) < 0.02).astype(np.int8)
    # Rows of shared buckets, so the maxima are not all noise.
    qocc[:, :, :64] |= (rng.random((G, M2, 1)) < 0.5).astype(np.int8)
    rocc[:, :, :64] |= (rng.random((G, NRB, 1)) < 0.5).astype(np.int8)
    if zero:
        qocc[1] = 0
        rocc[:, ::3] = 0
    if ties:
        rocc[:, 1::2] = rocc[:, 0:-1:2][:, :NRB // 2]
    r_rows = rng.integers(0, G, rows).astype(np.int32)
    q_rows = rng.integers(0, G, (rows, K)).astype(np.int32)
    if zero:
        q_rows[0, 0] = 1
    return [torch.from_numpy(a) for a in (qocc, rocc, r_rows, q_rows)]


@pytest.mark.gpu
@pytest.mark.parametrize('K,M2,NRB,H,case', [
    # bucket 4,096 (contigs128; the 64 x 128 tile), 65,536 and 131,072
    # (V3_MAX_BUCKET; the 128 x 256 tile)
    (8, 64, 128, 2048, None), (1, 1024, 2048, 2048, None),
    (8, 1024, 4096, 2048, None),
    # NRB not a multiple of 512 or of the 256-block tile; 2*NQB not of 64
    (8, 80, 700, 2048, None), (1, 96, 200, 256, None),
    (8, 64, 600, 1024, 'zero'), (1, 128, 520, 2048, 'zero'),
    (8, 192, 512, 2048, 'ties'), (1, 64, 300, 512, 'ties'),
    # an arena of 40 rows, each dispatch row's queries all one arena row
    (8, 256, 512, 2048, 'arena40')])
def test_k2_kernel_matches_plain(cuda_device, K, M2, NRB, H, case):
    args = _stage1_inputs(K * NRB + M2, K, M2, NRB, H, zero=case == 'zero',
                          ties=case == 'ties',
                          G=40 if case == 'arena40' else 5,
                          rows=6 if case == 'arena40' else 3)
    if case == 'arena40':
        args[2] = torch.tensor([39, 0, 17, 17, 3, 39], dtype=torch.int32)
        args[3] = args[3][:, :1].expand(-1, K).contiguous()
    args = [a.to(cuda_device) for a in args]
    before = tav.stage1_pack.launches
    got = tav.stage1_pack(*args)
    want = tav.stage1_pack_plain(*args)
    torch.cuda.synchronize()
    assert tav.stage1_pack.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case == 'ties':
        assert ((got[0] & 8191) % 2 == 1).float().mean() > 0.9


@pytest.mark.gpu
def test_k2_wrapper_rejects_what_tma_cannot_read(cuda_device):
    """TMA reads contiguous arenas at 16-byte aligned addresses: the
    wrapper raises on anything else instead of launching."""
    qocc, rocc, r_rows, q_rows = (a.to(cuda_device) for a in _stage1_inputs(
        1, 2, 64, 128, 256))
    before = tav.stage1_pack.launches
    with pytest.raises(ValueError, match='contiguous'):
        tav.stage1_pack(qocc.transpose(1, 2), rocc, r_rows, q_rows)
    flat = torch.zeros(qocc.numel() + 1, dtype=torch.int8,
                       device=cuda_device)
    shifted = flat[1:].view(qocc.shape)
    shifted.copy_(qocc)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match='16-byte aligned'):
        tav.stage1_pack(shifted, rocc, r_rows, q_rows)
    assert tav.stage1_pack.launches == before


def _k3_matches(device, case, tband=None, smin=None):
    """K3 == bands_v3_plain on `case`'s arena on `device`, every output, in
    one launch. Returns K3's outputs, the arena and the other arguments."""
    tband = tav.V3_TBAND if tband is None else tband
    smin = tav.V3_SMIN if smin is None else smin
    b, args = torch_args(torch, case, K3_ARGS, device)
    before = tav._bands_v3.launches
    got = tav._bands_v3(b, *args, tband, smin, case['g3'])
    want = tav.bands_v3_plain(b, *args, tband, smin, case['g3'])
    torch.cuda.synchronize()
    assert tav._bands_v3.launches == before + 1
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    return got, b, args


@pytest.mark.gpu
@pytest.mark.parametrize('wq,R,K,NQB,mode', [
    (128, 25, 8, 25, None), (64, 3, 8, 16, None), (416, 2, 4, 6, None),
    (128, 4, 8, 8, 'ties'),
    # one coarse block (a warp in a CTA of 8); 525 warps, not a multiple
    # of a CTA's 8; 3 and 6 fine blocks a coarse block
    (128, 1, 1, 1, None), (128, 5, 7, 15, None), (96, 2, 8, 11, None),
    (192, 7, 3, 10, None),
    # N runs as rare as in genomes
    (128, 6, 8, 30, 'clean'), (416, 3, 8, 4, 'clean')])
def test_k3_kernel_matches_plain(cuda_device, wq, R, K, NQB, mode):
    """Stages 2-4's kernel (the rows read in place, the election decoded)
    == bands_v3_plain on seeded arenas: codes 4 in rows and queries,
    candidates at blocks 0 and NRB - 1, references whose lengths are not
    multiples of 32, V3_WQ 64-416."""
    got, _, _ = _k3_matches(cuda_device, bands_case(
        wq * R + NQB, R, K, NQB, wq, ties=mode == 'ties',
        clean=mode == 'clean'))
    if mode == 'ties':     # every band ties: candidate 1 forward wins
        assert not got['S'].any()


@pytest.mark.gpu
def test_k3_kernel_thresholds(cuda_device):
    """tband below the threshold's floor of 4 (the min wins) and smin // 2
    below 3 (candidate 2's gate is 3)."""
    _k3_matches(cuda_device, bands_case(11, 3, 8, 9, 96), tband=3, smin=1)


@pytest.mark.gpu
@pytest.mark.parametrize('bucket,B', [(65536, 26), (4096, None)])
def test_k3_k5_kernels_at_dispatch_shapes(cuda_device, bucket, B):
    """K3 and then K5 on K3's election, each == its plain version, at a
    full dispatch of K = 8 queries: bucket 65,536 at the parent's B = 26
    (NQB = 512, NRB = 2,048) and 4,096 at this budget's B (NQB = 32)."""
    B = B or tav._dispatch_rows(bucket, 8, cuda_device, False)
    case = bands_case(bucket, B, 8, bucket // 128, 128, clean=True,
                      nrb=bucket // 32)
    el, b, args = _k3_matches(cuda_device, case)
    r_rows, rlens, q_rows, _, g1, _, g2 = args
    k5 = (el, b, r_rows, rlens, q_rows, g1, g2, case['g3'])
    before = tav._propagate_v3.launches
    got = tav._propagate_v3(*k5)
    want = tav.propagate_v3_plain(*k5)
    torch.cuda.synchronize()
    assert tav._propagate_v3.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[0].any()


@pytest.mark.gpu
def test_k3_k5_on_a_misaligned_arena(cuda_device):
    """K3 reads the rows and query codes a byte at a time, so an arena at an
    odd address is read as any other (== plain); K5 reads them as words
    and raises on it, without a launch."""
    case = bands_case(5, 2, 3, 4, 128)
    b, args = torch_args(torch, case, K3_ARGS, cuda_device)
    odd = {}
    for k, v in b.items():
        odd[k] = torch.empty(v.numel() + 1, dtype=torch.int8,
                             device=cuda_device)[1:].view(v.shape)
        odd[k].copy_(v)
        assert odd[k].is_contiguous() and odd[k].data_ptr() % 4
    tb, sm, g3 = tav.V3_TBAND, tav.V3_SMIN, case['g3']
    got = tav._bands_v3(odd, *args, tb, sm, g3)
    want = tav.bands_v3_plain(b, *args, tb, sm, g3)
    torch.cuda.synchronize()
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    r_rows, rlens, q_rows, _, g1, _, g2 = args
    before = tav._propagate_v3.launches
    with pytest.raises(ValueError, match='4-byte aligned'):
        tav._propagate_v3(got, odd, r_rows, rlens, q_rows, g1, g2, g3)
    assert tav._propagate_v3.launches == before


def _k4_both(device, case, Lq, params, with_alns):
    """K4 and its plain version on the same tensors on `device`."""
    x = [torch.from_numpy(a).to(device)
         for a in back_half_case(case, Lq, Lq + len(case))]
    mqd, mrd, reg = PARAMS[params]
    kw = dict(Lq=Lq, mqd=mqd, mrd=mrd, reg=reg, with_alns=with_alns)
    before = tav._blocks_to_measures.launches
    got = tav._blocks_to_measures(*x, **kw)
    launched = tav._blocks_to_measures.launches - before
    return got, tav.blocks_to_measures_plain(*x, **kw), launched


@pytest.mark.gpu
@pytest.mark.parametrize('Lq,case,params', [
    (Lq, case, 'cap' if case == 'cap' else 'default')
    for Lq in (4096, 65536, 262144) for case in CASES + ('cap',)]
    + [(4096, case, 'tight') for case in CASES]
    + [(1 << 20, 'random', 'default')])
def test_k4_kernel_matches_plain(cuda_device, Lq, case, params):
    """The back half's kernel == its plain version, aggregates without
    records, and aggregates, records and counts before the cap with them;
    Lq up to MAX_TPU_LEN (32 chunks of 1,024 words)."""
    got, want, launched = _k4_both(cuda_device, case, Lq, params, False)
    torch.cuda.synchronize()
    assert launched == 1 and torch.equal(got, want)
    got, want, launched = _k4_both(cuda_device, case, Lq, params, True)
    torch.cuda.synchronize()
    assert launched == 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    if case == 'cap':
        assert (got[2] > got[1].shape[1]).all()


@pytest.mark.gpu
@pytest.mark.parametrize('R,K,NBF,band,ties,knobs', [
    (3, 8, 2048, 224, False, None), (2, 4, 2048, 224, True, None),
    (1, 2, 8192, 224, False, None), (5, 3, 128, 160, True, None),
    # a ragged block count, the widest band, and other EXT_* / V3_CONT
    (2, 1, 33, 512, False, None), (2, 3, 300, 224, True, (0, 17, 4, 6)),
    (2, 3, 300, 224, False, (5, 12, 0, 0)), (2, 3, 300, 224, True,
                                              (2, 20, 8, 32))])
def test_k5_kernel_matches_plain(cuda_device, monkeypatch, R, K, NBF, band,
                                 ties, knobs):
    """Stages 5-6's kernel == its plain version on crafted band counts and
    arenas (with ties across the bands), every output."""
    if knobs:
        for name, v in zip(('EXT_ITERS', 'EXT_MIN', 'EXT_MARGIN',
                            'V3_CONT'), knobs):
            monkeypatch.setattr(tav, name, v)
    case = propagate_case(NBF + R, R, K, NBF, band, ties)
    got = _k5_matches(cuda_device, case)
    if not knobs or knobs[0]:     # something was adopted
        assert not np.array_equal(got[5].cpu().numpy(), case['el']['D'])


def _k4_arrays_match(device, x, Lq, params):
    """K4 == its plain version on the numpy inputs x, without and with
    records (every output), one launch each."""
    mqd, mrd, reg = PARAMS[params]
    t = [torch.from_numpy(a).to(device) for a in x]
    for alns in (False, True):
        kw = dict(Lq=Lq, mqd=mqd, mrd=mrd, reg=reg, with_alns=alns)
        before = tav._blocks_to_measures.launches
        got = tav._blocks_to_measures(*t, **kw)
        want = tav.blocks_to_measures_plain(*t, **kw)
        torch.cuda.synchronize()
        assert tav._blocks_to_measures.launches == before + 1
        got, want = (got, want) if alns else ((got,), (want,))
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize('case,Lq', [
    ('long', 1 << 20), ('long', 65536), ('last', 65536), ('last', 4096),
    ('last', 1 << 20)])
def test_k4_segments_across_ctas(cuda_device, case, Lq):
    """K4's chunks (512 words = 16,384 positions from bucket 16,384 up) on
    separate CTAs: a segment whose start, MAL run and end lie in three
    chunks (0, 1, 2 at 65,536; 3, 6, 8 at 2^20); a pair whose only
    anchored matches lie in its last chunk."""
    x = (long_segment_case(Lq, 3, (60000, 100000, 140000)) if case == 'long'
         and Lq > 65536 else long_segment_case(Lq, 3) if case == 'long'
         else last_chunk_case(Lq, 3))
    got = _k4_arrays_match(cuda_device, x, Lq, 'default')
    assert (got[0][:, 0] == 1).all()


@pytest.mark.gpu
def test_k4_cap_in_a_later_cta(cuda_device):
    """The record cap (2,048 at Lq = 262,144) is reached in chunk 5 of 16:
    the rows stop there, and the counts go on to the pair's end."""
    Lq = 262144
    got = _k4_arrays_match(cuda_device, sparse_cap_case(Lq, 2), Lq, 'cap')
    assert got[1].shape[1] == 2048 and (got[2] == Lq // 48 + 1).all()
    assert (got[1][:, -1, 0] > 5 * 16384).all()   # the last row's start


@pytest.mark.gpu
def test_k4_nothing_anchored(cuda_device):
    """Pairs without a match at all, in every chunk: zero aggregates and
    all record rows -1."""
    Lq = 65536
    x = back_half_case('random', Lq, 2)
    x[0][:] = x[1][:] = False
    got = _k4_arrays_match(cuda_device, x, Lq, 'default')
    assert (got[0] == 0).all() and (got[1] == -1).all()


@pytest.mark.gpu
def test_k4_one_row_stride0_rlen(cuda_device):
    """A one-row dispatch broadcasts its reference length at stride 0."""
    Lq = 65536
    x = [torch.from_numpy(a).to(cuda_device)
         for a in back_half_case('random', Lq, 3)]
    x[-1] = x[-1][:1].expand(x[0].shape[0])
    assert x[-1].stride() == (0,)
    mqd, mrd, reg = PARAMS['default']
    kw = dict(Lq=Lq, mqd=mqd, mrd=mrd, reg=reg, with_alns=True)
    before = tav._blocks_to_measures.launches
    got = tav._blocks_to_measures(*x, **kw)
    want = tav.blocks_to_measures_plain(*x, **kw)
    torch.cuda.synchronize()
    assert tav._blocks_to_measures.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _k5_matches(device, case):
    """K5 == propagate_v3_plain on a `propagate_case`, every output, in one
    launch: the election, the arena's rows and query codes, r_rows, rlens,
    q_rows, g1, g2."""
    el = {k: torch.from_numpy(v).to(device) for k, v in case['el'].items()}
    b, args = torch_args(torch, case, K5_ARGS, device)
    before = tav._propagate_v3.launches
    got = tav._propagate_v3(el, b, *args, case['g3'])
    want = tav.propagate_v3_plain(el, b, *args, case['g3'])
    torch.cuda.synchronize()
    assert tav._propagate_v3.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize('R,K,NBF,iters,ties', [
    (2, 3, 1, 3, False),        # one block
    (2, 2, 128, 3, False),      # one tile holds the pair
    (2, 2, 129, 3, False),      # one block more: two tiles
    (1, 3, 250, 3, True),       # one past two tiles (they hold 249)
    (1, 2, 8192, 16, False),    # the largest pair at the widest halo
    (3, 2, 224, 16, True),      # one past two tiles at 16 (223)
    (2, 2, 300, 0, False)])
def test_k5_tile_edges(cuda_device, monkeypatch, R, K, NBF, iters, ties):
    """K5's tiles (128 blocks; the first writes 128 - EXT_ITERS, the others
    128 - 2 EXT_ITERS - 1: 121 at EXT_ITERS = 3, 95 at 16) at ragged block
    counts, one block and EXT_ITERS 0 and 16."""
    monkeypatch.setattr(tav, 'EXT_ITERS', iters)
    _k5_matches(cuda_device, propagate_case(NBF + iters, R, K, NBF, 224,
                                            ties))


@pytest.mark.gpu
@pytest.mark.parametrize('c0,iters', [(124, 3), (125, 3), (246, 3),
                                      (112, 16), (207, 16)])
def test_k5_chain_across_tile_edge(cuda_device, monkeypatch, c0, iters):
    """A state handed on block by block across the edge between two tiles
    (at 125 and 246 at EXT_ITERS = 3, at 112 and 207 at 16)."""
    monkeypatch.setattr(tav, 'EXT_ITERS', iters)
    case = chain_case(c0, 1, 2, 400, 224, c0, iters)
    got = _k5_matches(cuda_device, case)
    lo, hi = case['chain']
    assert got[3][..., lo:hi].all() and int(got[3].sum()) == 2 * (hi - lo)


@pytest.mark.gpu
def test_kernel_launches_counted(cuda_device):
    q, ref = _seqs()
    before = tx.extend.launches
    tx.batched_extend(tx.pad_codes(q), tx.pad_codes(ref),
                      np.zeros(3, np.int32), np.zeros(3, np.int32), len(q),
                      len(ref), device=cuda_device)
    assert tx.extend.launches == before + tx.LAUNCHES_PER_CALL
    before = tpf.occupancy_count.launches
    idx = _index(1, 40, 100, 10, 500)
    tpf.shared_kmer_counts_indexed(idx, engine='device', device=cuda_device)
    assert tpf.occupancy_count.launches == before + 1


def test_cpu_tensors_take_the_plain_version():
    """No launch and the plain result for CPU tensors."""
    idx = _index(2, 30, 200, 10, 1000)
    k, p, _ = _k1_both(idx, torch.device('cpu'))
    assert torch.equal(k, p)
    before = tx.extend.launches
    q, ref = _seqs()
    tx.batched_extend(tx.pad_codes(q), tx.pad_codes(ref),
                      np.zeros(3, np.int32), np.zeros(3, np.int32), len(q),
                      len(ref), device='cpu')
    assert tx.extend.launches == before


def test_cpu_tensors_take_the_plain_k2_and_k3():
    """K2 and K3 wrappers answer CPU tensors with their plain versions,
    without a launch."""
    before = (tav.stage1_pack.launches, tav._bands_v3.launches)
    args = _stage1_inputs(3, 4, 80, 300, 256, ties=True)
    for g, w in zip(tav.stage1_pack(*args), tav.stage1_pack_plain(*args)):
        assert torch.equal(g, w)
    case = bands_case(4, 2, 2, 4, 128)
    b, args = torch_args(torch, case, K3_ARGS)
    got = tav._bands_v3(b, *args, 17, 5, case['g3'])
    want = tav.bands_v3_plain(b, *args, 17, 5, case['g3'])
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    assert (tav.stage1_pack.launches, tav._bands_v3.launches) == before


def test_cpu_tensors_take_the_plain_k4_and_k5():
    """K4 and K5 wrappers answer CPU tensors with their plain versions,
    without a launch."""
    before = (tav._blocks_to_measures.launches, tav._propagate_v3.launches)
    x = [torch.from_numpy(a) for a in back_half_case('random', 4096, 5)]
    kw = dict(Lq=4096, mqd=40, mrd=40, reg=35, with_alns=True)
    for g, w in zip(tav._blocks_to_measures(*x, **kw),
                    tav.blocks_to_measures_plain(*x, **kw)):
        assert torch.equal(g, w)
    case = propagate_case(6, 2, 2, 64, 224)
    el = {k: torch.from_numpy(v) for k, v in case['el'].items()}
    b, args = torch_args(torch, case, K5_ARGS)
    for g, w in zip(tav._propagate_v3(el, b, *args, case['g3']),
                    tav.propagate_v3_plain(el, b, *args, case['g3'])):
        assert torch.equal(g, w)
    assert (tav._blocks_to_measures.launches,
            tav._propagate_v3.launches) == before


def test_cpu_tensors_take_the_plain_v2_front_end():
    """The K6 (K8 fused in) and K7 wrappers answer CPU tensors with their
    plain versions, without a launch: the election of the seed votes ==
    elect_v2_plain(votes_v2_plain(...)), the votes only when asked."""
    counters = (tav._votes_elect_v2, tav._propagate_v2)
    before = [c.launches for c in counters]
    codes = v2_genomes(3, 3300)
    b = v2_arena(codes, 4096, 32, 8)
    r_rows, rlens, q_rows, qlens = v2_rows(codes, 4, 2, 4)
    kw = dict(Lq=4096, Lr=4096)
    votes = tav.votes_v2_plain(b, r_rows, q_rows, C=8, **kw)
    want = tav.elect_v2_plain(votes, **kw)
    *el, none = tav._votes_elect_v2(b, r_rows, q_rows, C=8, **kw)
    assert none is None
    *el_v, got_votes = tav._votes_elect_v2(b, r_rows, q_rows, C=8,
                                           want_votes=True, **kw)
    assert torch.equal(got_votes, votes)
    for g, g_v, w in zip(el, el_v, want):
        assert torch.equal(g, w) and torch.equal(g_v, w)
    args = (b, r_rows, rlens, q_rows, qlens, *el[:3])
    for g, w in zip(tav._propagate_v2(*args, Lr=4096),
                    tav.propagate_v2_plain(*args, Lr=4096)):
        assert torch.equal(g, w)
    assert [c.launches for c in counters] == before


# The v2 front end: K6 (K8 fused in) and K7 (csrc/align_v2.cu) on the card
# against their plain versions; genomes of `v2_genomes` a bucket long, less
# 700.

def _v2_inputs(device, Lp, pack, C, R=3, K=8, seed=5, poly_t=False):
    """The index genomes' arena and rows; with poly_t genomes 0 and 1 hold
    a run of T (seeds of the largest value) and row 1 queries them."""
    codes = v2_genomes(seed, Lp - 700)
    if poly_t:
        for g in (0, 1):
            codes[g][2000:2100] = 3
    b = v2_arena(codes, Lp, pack, C, device)
    rows = v2_rows(codes, seed + 1, R, K, refs=(0, 5))
    if poly_t:
        rows[2][1, :2] = torch.tensor([0, 1])
        rows[3][1, :2] = torch.tensor([len(codes[0]), len(codes[1])])
    return b, tuple(x.to(device) for x in rows)


def _k6_matches(device, Lp, pack, C, R=3, K=8, poly_t=False):
    """The fused kernel on the index genomes == the plain pair (see
    _k6_equal)."""
    b, (r_rows, rlens, q_rows, qlens) = _v2_inputs(device, Lp, pack, C, R,
                                                   K, poly_t=poly_t)
    return _k6_equal(b, r_rows, q_rows, Lp, C)


def _k6_equal(b, r_rows, q_rows, Lp, C):
    """The fused kernel == the plain pair: the election without and with
    the votes output, and the votes; one launch each."""
    kw = dict(Lq=Lp, Lr=Lp, C=C)
    before = tav._votes_elect_v2.launches
    got = tav._votes_elect_v2(b, r_rows, q_rows, **kw)
    got_v = tav._votes_elect_v2(b, r_rows, q_rows, want_votes=True, **kw)
    want = tav.votes_elect_v2_plain(b, r_rows, q_rows, want_votes=True,
                                    **kw)
    torch.cuda.synchronize()
    assert tav._votes_elect_v2.launches == before + 2
    assert got[4] is None
    for g, g_v, w in zip(got[:4], got_v[:4], want[:4]):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(
            g_v, w)
    assert torch.equal(got_v[4], want[4])
    return want


@pytest.mark.gpu
@pytest.mark.parametrize('Lp,C,pack', [
    (4096, 8, 32), (4096, 16, 64), (65536, 8, 32), (65536, 16, 32),
    (65536, 16, 64), (262144, 8, 64), (262144, 16, 64)])
def test_k8_kernel_matches_plain(cuda_device, Lp, C, pack):
    """The fused kernel's votes (its search, K8) and election ==
    votes_v2_plain and elect_v2_plain, both strands, both pack widths; the
    directory samples every 4th sorted value (every 8th at 262,144 and
    C = 16) and the search reads the segment between two samples."""
    votes = _k6_matches(cuda_device, Lp, pack, C)[4]
    assert (votes[0, ..., 0] < tav.BIG).any() and (votes[1] == tav.BIG).all()


@pytest.mark.gpu
@pytest.mark.parametrize('Lq,C', [
    (4096, 1), (4096, 5), (4096, 8), (4096, 16), (4096, 24), (4096, 32),
    (65536, 8), (65536, 16), (65536, 32), (262144, 8), (262144, 16)])
def test_k6_kernel_matches_plain(cuda_device, Lq, C):
    """The fused kernel's two-scale election (and votes) == the plain pair
    at C = 1-32 (lanes without a seed below 8, 4, 8 and 16 votes a lane,
    BIG padding at C = 5 and 24), on the index genomes at their bucket's
    pack width."""
    A = _k6_matches(cuda_device, Lq, tav._pack_bits(Lq), C, R=2, K=4)[0]
    assert A.any() and not A.all()


@pytest.mark.gpu
def test_k6_kernel_wide_pack(cuda_device):
    """Bucket 1,048,576 (MAX_TPU_LEN): the election's pack needs 32 bits
    of vote code (2 DSPAN + 64 >= 2^22), held in int64 and clamped in its
    own type (ROADMAP R9); the rows sampled every 32nd value."""
    A = _k6_matches(cuda_device, 1 << 20, 64, 16, R=1, K=2)[0]
    assert A.any()


@pytest.mark.gpu
@pytest.mark.parametrize('Lq,C,pack', CRAFTED)
def test_k6_kernel_crafted_votes(cuda_device, Lq, C, pack):
    """The fused kernel's election (and votes) == the plain pair on an
    arena whose seeds give votes_case's crafted votes: two clusters of
    equal size, empty blocks, a coarse block with no vote, a fine election
    that ties its support for the coarse mode (the tie-breaks of ROADMAP
    P3: the smallest start, then the smallest mode), at C = 5, 16 and 32
    and at 2^20, where the election's pack holds 32 bits of vote code."""
    b, r_rows, q_rows, _ = crafted_case(Lq, C, pack)
    b = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
         for k, v in b.items()}
    A, _, D, _, _ = _k6_equal(b, r_rows.to(cuda_device),
                              q_rows.to(cuda_device), Lq, C)
    assert A.any() and not A[0, 0, 4:8].any()
    assert A[0, 0, 0] and D[0, 0, 0] == D[0, 0, 1]


@pytest.mark.gpu
@pytest.mark.parametrize('Lp,pack', [(4096, 32), (65536, 32), (262144, 64)])
def test_k6_kernel_top_value(cuda_device, Lp, pack):
    """Seeds of the largest value (TTTTTTTT), which the kernel's 16-bit
    directory holds as it holds BIG: a run of them across segments in the
    reference, then BIG; election and votes == the plain pair."""
    votes = _k6_matches(cuda_device, Lp, pack, 16, poly_t=True)[4]
    assert (votes[0, ..., 0] < tav.BIG).any()


@pytest.mark.gpu
def test_k6_wrapper_raises_on_bad_arguments(cuda_device):
    """On the card the fused kernel's wrapper raises, and neither launches
    nor falls back to the plain version, where the kernel cannot take its
    arguments."""
    b, (r_rows, _, q_rows, _) = _v2_inputs(cuda_device, 4096, 32, 8, R=2,
                                           K=4)
    kw = dict(Lq=4096, Lr=4096)
    before = tav._votes_elect_v2.launches
    with pytest.raises(ValueError, match='1-32 seeds'):
        tav._votes_elect_v2(b, r_rows, q_rows, C=33, **kw)
    with pytest.raises(ValueError, match='multiple of 128'):
        tav._votes_elect_v2(b, r_rows, q_rows, C=8, Lq=4064, Lr=4096)
    with pytest.raises(ValueError, match='packs of 32 or 64'):
        tav._votes_elect_v2(dict(b, pack_bits=48), r_rows, q_rows, C=8,
                            **kw)
    with pytest.raises(ValueError, match='must be'):
        tav._votes_elect_v2(b, r_rows, q_rows, C=16, **kw)  # qsv at C = 8
    G, NR = b['sv_f'].shape
    shifted = torch.empty(G * NR + 1, dtype=torch.int32,
                          device=cuda_device)[1:].view(G, NR)
    shifted.copy_(b['sv_f'])
    with pytest.raises(ValueError, match='16-byte aligned'):
        tav._votes_elect_v2(dict(b, sv_f=shifted), r_rows, q_rows, C=8,
                            **kw)
    with pytest.raises(ValueError, match='is on'):
        tav._votes_elect_v2(dict(b, qsv=b['qsv'].cpu()), r_rows, q_rows,
                            C=8, **kw)
    assert tav._votes_elect_v2.launches == before


def _on_cpu(b):
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in b.items()}


def _k7_matches(device, b, rows, A, S, D, Lr):
    A, S, D = (x.to(device) for x in (A, S, D))
    before = tav._propagate_v2.launches
    got = tav._propagate_v2(b, *rows, A, S, D, Lr=Lr)
    want = tav.propagate_v2_plain(b, *rows, A, S, D, Lr=Lr)
    torch.cuda.synchronize()
    assert tav._propagate_v2.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize('Lp,iters', [(4096, 3), (65536, 3), (65536, 16),
                                      (65536, 0), (262144, 3)])
def test_k7_kernel_matches_plain(cuda_device, monkeypatch, Lp, iters):
    """The propagation's kernel == propagate_v2_plain, every output, on
    elections of the index genomes with blocks unassigned, diagonals moved
    and windows clipped (adoption, strand switches, tile edges)."""
    monkeypatch.setattr(tav, 'EXT_ITERS', iters)
    b, rows = _v2_inputs(cuda_device, Lp, tav._pack_bits(Lp), 16, R=2, K=4)
    A, S, D = election_case(_on_cpu(b), tuple(x.cpu() for x in rows), Lp,
                            Lp, 16, 9)
    got = _k7_matches(cuda_device, b, rows, A, S, D, Lp)
    if iters:
        assert (got[3].cpu() & ~A).any()             # something adopted


@pytest.mark.gpu
@pytest.mark.parametrize('NBF,iters', [(1, 3), (128, 3), (129, 3), (250, 3),
                                       (224, 16), (129, 0), (300, 16)])
def test_k7_tile_edges(cuda_device, monkeypatch, NBF, iters):
    """K7's tiles (128 blocks; the first writes 128 - EXT_ITERS, the others
    128 - 2 EXT_ITERS - 1) at ragged block counts, one block and EXT_ITERS
    0 and 16, on crafted elections."""
    monkeypatch.setattr(tav, 'EXT_ITERS', iters)
    Lp = NBF * 32
    codes = [c[:Lp] for c in v2_genomes(NBF, max(Lp, 3000))]
    b = v2_arena(codes, Lp, 32, 8, cuda_device)
    rows = tuple(x.to(cuda_device) for x in v2_rows(codes, 2, 2, 4))
    A, S, D = random_election(NBF, 2, 4, NBF, Lp)
    _k7_matches(cuda_device, b, rows, A, S, D, Lp)


@pytest.mark.gpu
@pytest.mark.parametrize('c0,iters', [(124, 3), (125, 3), (246, 3),
                                      (112, 16), (207, 16)])
def test_k7_chain_across_tile_edge(cuda_device, monkeypatch, c0, iters):
    """A state handed on block by block across the edge between two tiles
    (at 125 and 246 at EXT_ITERS = 3, at 112 and 207 at 16): the reference
    against itself and its mutant from one assigned block."""
    monkeypatch.setattr(tav, 'EXT_ITERS', iters)
    Lp = 16384
    codes = v2_genomes(7, Lp - 700)
    b = v2_arena(codes, Lp, 32, 16, cuda_device)
    lens = torch.tensor([len(c) for c in codes], dtype=torch.int32)
    r_rows = torch.tensor([0], dtype=torch.int32)
    q_rows = torch.tensor([[0, 1]], dtype=torch.int32)
    rows = tuple(x.to(cuda_device) for x in (
        r_rows, lens[r_rows.long()], q_rows, lens[q_rows.long()]))
    A, S, D = chain_election(q_rows, Lp // 32, c0)
    got = _k7_matches(cuda_device, b, rows, A, S, D, Lp)
    assert got[3][0, :, c0 - iters:c0 + iters + 1].all()
    assert int(got[3].sum()) == 2 * (2 * iters + 1)


@pytest.mark.gpu
@pytest.mark.parametrize('Lp,iters', [(65536, 3), (262144, 3), (9600, 0),
                                      (9600, 16), (65536, 16)])
@pytest.mark.parametrize('kind', ['distinct', 'distinct_c0', 'relay',
                                  'clipped'])
def test_k7_crafted_elections(cuda_device, monkeypatch, Lp, iters, kind):
    """The propagation's kernel == propagate_v2_plain, every output, one
    launch, on crafted elections (tests/v2_cases.py) at buckets 65,536 and
    262,144 and at a ragged 300 blocks, EXT_ITERS 0, 3 and 16: no
    candidate state repeats in a window (with and without blocks at
    diagonal 0 whose state spreads), a state handed on over assigned
    blocks across a tile's edge, windows at and past the clips."""
    monkeypatch.setattr(tav, 'EXT_ITERS', iters)
    codes = v2_genomes(7, Lp - 700)
    b = v2_arena(codes, Lp, tav._pack_bits(Lp), 16, cuda_device)
    lens = torch.tensor([len(c) for c in codes], dtype=torch.int32)
    r_rows = torch.tensor([0, 3], dtype=torch.int32)
    q_rows = torch.tensor([[0, 1, 2, 7], [3, 0, 4, 6]], dtype=torch.int32)
    rows = tuple(x.to(cuda_device) for x in (
        r_rows, lens[r_rows.long()], q_rows, lens[q_rows.long()]))
    NBF = Lp // 32
    A, S, D = {
        'distinct': lambda: distinct_election(NBF, 2, 4, Lp),
        'distinct_c0': lambda: distinct_election(NBF, 2, 4, Lp, c0=200),
        'relay': lambda: relay_election(NBF, 2, 4, 124),
        'clipped': lambda: clipped_election(NBF, 2, 4, Lp, 5)}[kind]()
    got = _k7_matches(cuda_device, b, rows, A, S, D, Lp)
    if iters and kind != 'distinct':
        assert (got[5].cpu() != D).any()             # something adopted


@pytest.mark.gpu
@pytest.mark.parametrize('c0,iters', [(60, 3), (61, 3), (118, 3), (78, 16),
                                      (79, 16), (110, 16)])
@pytest.mark.parametrize('kind', ['chain', 'relay'])
def test_k7_state_across_64_block_tile_edge(cuda_device, monkeypatch, c0,
                                            iters, kind):
    """A state handed on block by block across the edges between the
    kernel's tiles of 64 blocks (tile t >= 1 writes from 64 - EXT_ITERS +
    (t - 1)(63 - 2 EXT_ITERS): 61 and 118 at EXT_ITERS 3, 79 and 110 at
    16), over unassigned blocks (chain) or over assigned ones at other
    diagonals (relay), on the reference against itself and its mutant
    (away from the mutant's N run)."""
    monkeypatch.setattr(tav, 'EXT_ITERS', iters)
    Lp = 16384
    codes = v2_genomes(7, Lp - 700)
    b = v2_arena(codes, Lp, 32, 16, cuda_device)
    lens = torch.tensor([len(c) for c in codes], dtype=torch.int32)
    r_rows = torch.tensor([0], dtype=torch.int32)
    q_rows = torch.tensor([[0, 1]], dtype=torch.int32)
    rows = tuple(x.to(cuda_device) for x in (
        r_rows, lens[r_rows.long()], q_rows, lens[q_rows.long()]))
    NBF = Lp // 32
    A, S, D = (chain_election(q_rows, NBF, c0) if kind == 'chain' else
               relay_election(NBF, 1, 2, c0))
    got = _k7_matches(cuda_device, b, rows, A, S, D, Lp)
    assert (got[5][0, :, c0 - iters:c0 + iters + 1] == 0).all()
    assert got[3][0, :, c0 - iters:c0 + iters + 1].all()


@pytest.mark.gpu
def test_k7_wrapper_raises_on_misaligned_rows(cuda_device):
    """On the card K7's wrapper raises, and neither launches nor falls
    back to the plain version, where the window rows are 4-byte but not
    16-byte aligned (the kernel reads them 16 bytes at a time)."""
    b, rows = _v2_inputs(cuda_device, 4096, 32, 8, R=2, K=4)
    A, S, D = (x.to(cuda_device) for x in random_election(3, 2, 4, 128,
                                                          4096))
    r2 = b['r2dov']
    shifted = torch.empty(r2.numel() + 4, dtype=torch.int8,
                          device=cuda_device)[4:].view(r2.shape)
    shifted.copy_(r2)
    before = tav._propagate_v2.launches
    with pytest.raises(ValueError, match='16-byte'):
        tav._propagate_v2(dict(b, r2dov=shifted), *rows, A, S, D, Lr=4096)
    assert tav._propagate_v2.launches == before


def _hybrid_codes(seed=4):
    """Six genomes of 3-3.4 kb: a base with an internal repeat, its 5%
    mutant, the reverse complement of a 4% mutant, a 3% mutant of its
    first 1,400 bases (a containment: a hard pair) and two unrelated
    genomes (one with an N run), in ids order."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, 3300).astype(np.int8)
    base[2500:3100] = base[300:900]

    def mut(s, rate):
        s = s.copy()
        hit = rng.random(len(s)) < rate
        s[hit] = (s[hit] + rng.integers(1, 4, hit.sum())) % 4
        return s

    rcm = mut(base, 0.04)[::-1]
    junk = rng.integers(0, 4, 3000).astype(np.int8)
    junk[100:200] = 4
    return [base, mut(base, 0.05), np.where(rcm < 4, 3 - rcm, 4).astype(
        np.int8), rng.integers(0, 4, 3200).astype(np.int8), junk,
        mut(base[:1400], 0.03)]


@pytest.mark.gpu
@pytest.mark.parametrize('pipe', ['v3', 'v2'])
def test_all2all_gpu_card_matches_cpu(cuda_device, monkeypatch, pipe):
    """The device align engine on the card (K2, K3, K5 and K4 launched on
    v3; K4 on the hybrid's v2 re-run, or on v2 alone) == the same engine on
    the CPU, aggregates and records."""
    monkeypatch.setenv('VCLUST_ALIGN_PIPE', pipe)
    codes = _hybrid_codes()
    n = len(codes)
    pairs = np.array([(i, j) for i in range(n) for j in range(i + 1, n)],
                     np.int32)
    counters = (tav.stage1_pack, tav._bands_v3, tav._propagate_v3,
                tav._blocks_to_measures)
    before = [c.launches for c in counters]
    got = tav.all2all_gpu(codes, pairs, keep_alignments=True,
                          device=cuda_device)
    launched = tuple(c.launches - b for c, b in zip(counters, before))
    want = tav.all2all_gpu(codes, pairs, keep_alignments=True, device='cpu')
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1][1], want[1][1])
    assert np.array_equal(got[1][0], want[1][0])
    assert (got[0][:, 1] > 0).sum() >= 4
    if pipe == 'v3':        # K2, K3, K5 and K4 a v3 dispatch; K4 on v2
        assert min(launched) >= 1 and launched[3] >= launched[2]
    else:
        assert launched[:3] == (0, 0, 0) and launched[3] >= 1


# The index builds: K9 and K10 (csrc/index.cu) on the card against their
# plain versions, on tests/index_cases.py's hard rows.

def _index_on(device, Lp, seed=3):
    fwd, rc = padded(index_genomes(seed, Lp), Lp)
    return (torch.from_numpy(fwd).to(device),
            torch.from_numpy(rc).to(device))


def _same_arrays(got, want, keys):
    torch.cuda.synchronize()
    for key, g, w in zip(keys, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert torch.equal(g, w), key


@pytest.mark.gpu
@pytest.mark.parametrize('Lp,k,H,wq', [
    (4096, 8, 2048, 128), (65536, 8, 2048, 128), (131072, 8, 2048, 128),
    (4096, 8, 256, 128), (4096, 4, 256, 64), (6144, 8, 16384, 96),
    (16384, 8, 4096, 256), (4096, 8, 2048, 64)])
def test_k9_kernel_matches_plain(cuda_device, monkeypatch, Lp, k, H, wq):
    """K9 == index_block_v3_plain, every array, one launch: buckets 4,096
    to 131,072, H 256 to 16,384, V3_WQ 64 to 256 (a half-block of 48 at
    96), k 4 and 8, on the poly-A, all-N, bucket-edge and N-run genomes."""
    monkeypatch.setattr(tav, 'V3_H', H)
    monkeypatch.setattr(tav, 'V3_WQ', wq)
    fwd, rc = _index_on(cuda_device, Lp)
    before = tav._index_block_v3.launches
    got = tav._index_block_v3(fwd, rc, k, Lp)
    assert tav._index_block_v3.launches == before + 1
    _same_arrays(got, tav.index_block_v3_plain(fwd, rc, k, Lp),
                 tav._V3_KEYS)


K10_SHAPES = [
    (4096, 8, 16, 32), (4096, 8, 1, 32), (4096, 8, 32, 64),
    (4096, 4, 8, 32), (4096, 4, 32, 64), (65536, 8, 16, 32),
    (65536, 8, 32, 32), (65536, 8, 8, 64), (262144, 8, 16, 64),
    (262144, 8, 8, 64), (1 << 20, 8, 16, 64)]


def _poisoned_v2_out(G, Lp, pack, C, device):
    """index_v2_empty's arrays, every byte 0x5A: a value no arena holds
    (an element K10 leaves unwritten shows, whatever memory the allocator
    hands back)."""
    out = tav.index_v2_empty(G, Lp, pack, C, device)
    for t in out:
        t.view(torch.int8).fill_(0x5A)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize('Lp,k,C,pack', K10_SHAPES)
def test_k10_kernel_matches_plain(cuda_device, Lp, k, C, pack):
    """K10 == index_block_plain, every array, one launch: buckets 4,096 to
    2^20, C = 1-32, k 4 (one radix pass) and 8 (two), both pack widths,
    on the poly-A run (one value over ~65 blocks), the all-N genome (no
    valid seed), a genome to the bucket's edge and blocks with fewer valid
    positions than C."""
    fwd, rc = _index_on(cuda_device, Lp)
    before = tav._index_block.launches
    got = tav._index_block(fwd, rc, k, pack, C)
    assert tav._index_block.launches == before + 1
    want = tav.index_block_plain(fwd, rc, k, pack, C)
    _same_arrays(got, want, tav._V2_KEYS)
    if pack == 64:
        assert got[4] is got[3] and got[7] is got[6]


@pytest.mark.gpu
@pytest.mark.parametrize('Lp,k,C,pack', K10_SHAPES)
def test_k10_kernel_writes_every_element(cuda_device, Lp, k, C, pack):
    """K10 into `out` arrays filled with a poison value ==
    index_block_plain, every array: no element is left to what the memory
    held before."""
    fwd, rc = _index_on(cuda_device, Lp)
    out = _poisoned_v2_out(fwd.shape[0], Lp, pack, C, cuda_device)
    assert tav._index_block(fwd, rc, k, pack, C, out=out) is out
    _same_arrays(out, tav.index_block_plain(fwd, rc, k, pack, C),
                 tav._V2_KEYS)


@pytest.mark.gpu
def test_k10_kernel_after_other_shapes(cuda_device):
    """K10's state outlives a call, and a call of other shapes lays it
    out otherwise (its totals, counts and look-back words over an earlier
    call's words of another kind). On one stream: calls of other buckets,
    C, k (4, one radix pass, then 8, two) and pack widths in turn, larger
    and smaller, each into poisoned arrays == index_block_plain, every
    array."""
    seq = [(65536, 8, 32, 32), (4096, 4, 8, 32), (4096, 8, 8, 32),
           (262144, 8, 16, 64), (4096, 8, 1, 32), (65536, 4, 16, 64),
           (65536, 8, 16, 64), (4096, 4, 32, 64), (262144, 8, 8, 64),
           (4096, 8, 16, 32)]
    st = torch.cuda.Stream(cuda_device)
    st.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(st):
        for seed, (Lp, k, C, pack) in enumerate(seq):
            fwd, rc = _index_on(cuda_device, Lp, seed)
            out = _poisoned_v2_out(fwd.shape[0], Lp, pack, C, cuda_device)
            tav._index_block(fwd, rc, k, pack, C, out=out)
            _same_arrays(out, tav.index_block_plain(fwd, rc, k, pack, C),
                         tav._V2_KEYS)


@pytest.mark.gpu
def test_k10_kernel_stale_count_word(cuda_device):
    """A call's digit totals lying over an earlier call's row counts:
    call A (1 genome, 2 rows) leaves its rows' valid counts at state byte
    64 + 8 * 2 * 2 * 256; there call B (2 genomes, 4 rows) keeps its
    second pass's total of digit 0 in row 0. A's genome gives both its
    rows as many valid slots (C = 1: a slot a block) as the epoch B tags
    its totals with, so a count word that carried no epoch of its own
    would read as B's fresh total. B == index_block_plain, every array."""
    rng = np.random.default_rng(11)
    dev = cuda_device
    st = torch.cuda.Stream(dev)
    st.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(st):
        # A state larger than A's and B's (neither grows it, which would
        # zero it).
        fwd, rc = _index_on(dev, 65536)
        tav._index_block(fwd, rc, 8, 32, 32)
        torch.cuda.synchronize()
        state = tav._K10_STATE[fwd.device.index, st.cuda_stream]
        m = int(state[2]) + 2       # B's epoch: A's two passes on
        assert 1 <= m <= 65536 // 32, m
        calls = [([rng.integers(0, 4, 32 * m).astype(np.int8)], 65536, 1),
                 ([rng.integers(0, 4, n).astype(np.int8)
                   for n in (3000, 4000)], 4096, 16)]
        for i, (codes, Lp, C) in enumerate(calls):
            fwd, rc = (torch.from_numpy(x).to(dev)
                       for x in padded(codes, Lp))
            got = tav._index_block(fwd, rc, 8, 32, C)
            want = tav.index_block_plain(fwd, rc, 8, 32, C)
            _same_arrays(got, want, tav._V2_KEYS)
            if i == 0:
                assert [int((sv < tav.BIG).sum()) for sv in
                        (want[2], want[5])] == [m, m]
        assert int(state[2]) == m + 2


@pytest.mark.gpu
def test_k10_kernel_groups_of_rows(cuda_device):
    """K10 over 40 genomes at 262,144 and C = 32: 80 (genome, strand) rows
    of 262,144 8-byte items go in groups of what 128 MiB of items hold (64
    rows, then 16), through one scratch; == index_block_plain, every
    array, one launch. 4-byte items (buckets up to 65,536) hold twice the
    rows."""
    Lp = 262144
    codes = [c for s in range(6) for c in index_genomes(s, Lp)][:40]
    fwd, rc = (torch.from_numpy(x).to(cuda_device)
               for x in padded(codes, Lp))
    lib = tav.cuda.library('index', tav.cuda.INDEX_SIGNATURES)
    assert lib.k10_group_rows(40, Lp, 32) == 64
    assert lib.k10_group_rows(600, 65536, 32) == 512
    assert lib.k10_group_rows(600, 65536, 16) == 1024
    assert lib.k10_items_bytes(40, Lp, 32) == 64 * Lp * 8
    before = tav._index_block.launches
    got = tav._index_block(fwd, rc, 8, 64, 32)
    assert tav._index_block.launches == before + 1
    _same_arrays(got, tav.index_block_plain(fwd, rc, 8, 64, 32),
                 tav._V2_KEYS)


@pytest.mark.gpu
def test_k10_kernel_one_value_rows(cuda_device):
    """Rows whose valid slots all hold one value: a poly-A genome at
    262,144 and C = 32 (0 on the forward strand, 65,535 on the reverse),
    each of its 64 tiles a row one run of one digit in both passes, beside
    two random genomes; == index_block_plain, every array."""
    Lp = 262144
    rng = np.random.default_rng(7)
    codes = [np.zeros(Lp - 300, np.int8),
             rng.integers(0, 4, Lp - 5000).astype(np.int8),
             rng.integers(0, 4, 9000).astype(np.int8)]
    fwd, rc = (torch.from_numpy(x).to(cuda_device)
               for x in padded(codes, Lp))
    got = tav._index_block(fwd, rc, 8, 64, 32)
    want = tav.index_block_plain(fwd, rc, 8, 64, 32)
    _same_arrays(got, want, tav._V2_KEYS)
    for sv, value in ((want[2][0], 0), (want[5][0], 65535)):
        n = int((sv < tav.BIG).sum())
        assert n > Lp // 32 * 31 and (sv[:n] == value).all()


@pytest.mark.gpu
def test_k10_kernel_streams(cuda_device):
    """K10 twice back to back on one stream (the second launch's look-back
    must not take the first's words: an epoch tells them apart), then on
    each of two streams at once (a scratch each); each call == its
    index_block_plain, every array."""
    calls = [(_index_on(cuda_device, Lp, seed), Lp, C, pack)
             for Lp, C, pack, seed in ((65536, 16, 32, 3), (65536, 8, 32, 4),
                                       (262144, 16, 64, 5),
                                       (262144, 8, 64, 6))]
    before = tav._index_block.launches
    got = [tav._index_block(*codes, 8, pack, C)
           for codes, Lp, C, pack in calls[:2]]
    main = torch.cuda.current_stream(cuda_device)
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    for st, (codes, Lp, C, pack) in zip(streams, calls[2:]):
        st.wait_stream(main)
        with torch.cuda.stream(st):
            got.append(tav._index_block(*codes, 8, pack, C))
    for st in streams:
        main.wait_stream(st)
    assert tav._index_block.launches == before + 4
    for out, (codes, Lp, C, pack) in zip(got, calls):
        _same_arrays(out, tav.index_block_plain(*codes, 8, pack, C),
                     tav._V2_KEYS)


@pytest.mark.gpu
def test_k10_kernel_more_tiles_than_resident(cuda_device):
    """A pass launch of more (row, tile) CTAs than the card holds at once:
    7 genomes at 2^20 and C = 32, 14 rows of 256 tiles (3,584 CTAs
    against at most 8 of 256 threads an SM), so later tiles' CTAs start
    only as earlier ones finish; == index_block_plain, every array."""
    Lp, C = 1 << 20, 32
    props = torch.cuda.get_device_properties(cuda_device)
    resident = props.multi_processor_count * getattr(
        props, 'max_threads_per_multi_processor', 2048) // 256
    assert 14 * (Lp // 32 * C // 4096) > resident
    fwd, rc = _index_on(cuda_device, Lp)
    assert fwd.shape[0] == 7
    got = tav._index_block(fwd, rc, 8, 64, C)
    _same_arrays(got, tav.index_block_plain(fwd, rc, 8, 64, C),
                 tav._V2_KEYS)


@pytest.mark.gpu
@pytest.mark.parametrize('kind', ['v3', 'v2'])
def test_index_arena_of_two_chunks(cuda_device, kind):
    """600 genomes at bucket 4,096 through GenomeIndex (two chunks of
    _INDEX_ROWS_CHUNK written into one arena, no copy) == the plain build
    of the same codes, key by key; K9 or K10 launched once a chunk."""
    codes = [c for s in range(86) for c in index_genomes(s, 4096)][:600]
    idx = tav.GenomeIndex(codes, device=cuda_device)
    counter = tav._index_block_v3 if kind == 'v3' else tav._index_block
    before = counter.launches
    if kind == 'v3':
        got = idx.ensure_v3(4096, range(600))
        keys = tav._V3_KEYS
    else:
        got = idx.ensure(4096, range(600), C=16)
        keys = tav._V2_KEYS
    assert counter.launches == before + 2
    fwd, rc = padded(codes, 4096)
    fwd, rc = (torch.from_numpy(x).to(cuda_device) for x in (fwd, rc))
    want = (tav.index_block_v3_plain(fwd, rc, tav.SEED_K, 4096)
            if kind == 'v3' else
            tav.index_block_plain(fwd, rc, tav.SEED_K, 32, 16))
    _same_arrays([got[k] for k in keys], want, keys)
    assert torch.equal(got['fwd'], fwd)


@pytest.mark.gpu
def test_index_wrappers_raise_on_bad_arguments(cuda_device, monkeypatch):
    """On the card K9's and K10's wrappers raise, and neither launch nor
    fall back to the plain version, where the kernels cannot take their
    arguments."""
    fwd, rc = _index_on(cuda_device, 4096)
    before = (tav._index_block_v3.launches, tav._index_block.launches)
    shifted = torch.empty(fwd.numel() + 4, dtype=torch.int8,
                          device=cuda_device)[4:].view(fwd.shape)
    shifted.copy_(fwd)
    with pytest.raises(ValueError, match='16-byte aligned'):
        tav._index_block_v3(shifted, rc, 8, 4096)
    with pytest.raises(ValueError, match='16-byte aligned'):
        tav._index_block(fwd, shifted, 8, 32, 16)
    with pytest.raises(ValueError, match='C 1-32'):
        tav._index_block(fwd, rc, 8, 32, 33)
    with pytest.raises(ValueError, match='is on'):
        tav._index_block(fwd, rc.cpu(), 8, 32, 16)
    with pytest.raises(ValueError, match='must be'):
        tav._index_block(fwd, rc, 8, 32, 16,
                         out=tav.index_v2_empty(7, 4096, 32, 8, cuda_device))
    monkeypatch.setattr(tav, 'V3_H', 1000)
    with pytest.raises(ValueError, match='multiple of 16'):
        tav._index_block_v3(fwd, rc, 8, 4096)
    assert (tav._index_block_v3.launches,
            tav._index_block.launches) == before


def test_cpu_tensors_take_the_plain_index_builds():
    """K9's and K10's wrappers answer CPU tensors with their plain
    versions, without a launch, and write them into `out` when given."""
    before = (tav._index_block_v3.launches, tav._index_block.launches)
    fwd, rc = _index_on('cpu', 4096)
    got = tav._index_block_v3(fwd, rc, tav.SEED_K, 4096)
    want = tav.index_block_v3_plain(fwd, rc, tav.SEED_K, 4096)
    out = tav.index_v3_empty(len(fwd), 4096, 'cpu')
    assert tav._index_block_v3(fwd, rc, tav.SEED_K, 4096, out=out) is not \
        None
    for g, o, w in zip(got, out, want):
        assert torch.equal(g, w) and torch.equal(o, w)
    for pack in (32, 64):
        got = tav._index_block(fwd, rc, tav.SEED_K, pack, 8)
        want = tav.index_block_plain(fwd, rc, tav.SEED_K, pack, 8)
        out = tav.index_v2_empty(len(fwd), 4096, pack, 8, 'cpu')
        tav._index_block(fwd, rc, tav.SEED_K, pack, 8, out=out)
        for g, o, w in zip(got, out, want):
            assert torch.equal(g, w) and torch.equal(o, w)
    assert (tav._index_block_v3.launches,
            tav._index_block.launches) == before


@pytest.mark.parametrize('kind', ['v3', 'v2'])
def test_index_chunks_write_one_arena(monkeypatch, kind):
    """GenomeIndex writes each chunk of genomes into its slice of one
    arena: with chunks of 3 genomes, the 7 genomes' arena == one chunk's,
    key by key (on the CPU)."""
    codes = index_genomes(6, 4096)
    whole = tav.GenomeIndex(codes, device='cpu')
    monkeypatch.setattr(tav, '_INDEX_ROWS_CHUNK', 3)
    cut = tav.GenomeIndex(codes, device='cpu')
    if kind == 'v3':
        a, b = (i.ensure_v3(4096, range(7)) for i in (whole, cut))
        keys = tav._V3_KEYS
    else:
        a, b = (i.ensure(4096, range(7), C=8) for i in (whole, cut))
        keys = tav._V2_KEYS
    for key in keys:
        assert torch.equal(a[key], b[key]), key
    assert cut.prep_s > 0


# --------------------------------------------------------------------------
# K11: connected components (csrc/cc.cu)
# --------------------------------------------------------------------------

CC_GRAPHS = model_graphs()


def test_cpu_tensors_take_cc_plain():
    """K11's wrapper answers CPU tensors with cc_plain (int32 labels),
    without a launch."""
    before = tcc._cc_run.launches
    for name, n, edges in CC_GRAPHS:
        e = torch.from_numpy(edges)
        got = tcc._cc_run(e, n)
        assert got.dtype == torch.int32, name
        assert torch.equal(got.long(), tcc.cc_plain(e.long(), n)), name
    assert tcc._cc_run.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize('name,n,edges', CC_GRAPHS,
                         ids=[g[0] for g in CC_GRAPHS])
def test_k11_kernel_matches_plain(cuda_device, name, n, edges):
    e = torch.from_numpy(edges).to(cuda_device)
    before = tcc._cc_run.launches
    got = tcc._cc_run(e, n)
    assert tcc._cc_run.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), tcc.cc_plain(e.long(), n))
    assert np.array_equal(got.cpu().numpy(), union_find(n, edges))


@pytest.mark.gpu
@pytest.mark.parametrize('kind', ['near_ids', 'giant'])
def test_k11_kernel_at_two_million_nodes(cuda_device, kind):
    """IMG/VR scale: 2,000,000 nodes, (a) 1,500,000 draws of edges between
    ids fewer than 64 apart, (b) 8,000,000 random edges."""
    n = 2_000_000
    n, edges = (near_ids(n, 1_500_000, seed=13) if kind == 'near_ids'
                else random_graph(n, 8_000_000, seed=14))
    e = torch.from_numpy(edges).to(cuda_device)
    got = tcc._cc_run(e, n)
    assert torch.equal(got.long(), tcc.cc_plain(e.long(), n))
    assert np.array_equal(got.cpu().numpy(), least_member_labels(n, edges))


@pytest.mark.gpu
@pytest.mark.parametrize('name,n,edges', CC_GRAPHS,
                         ids=[g[0] for g in CC_GRAPHS])
def test_k11_kernel_in_build_edges_order(cuda_device, name, n, edges):
    """The graphs as `cluster` passes them: unique pairs i < j, sorted, so
    that a warp's lanes share ends (and roots)."""
    edges = build_edges_order(edges)
    e = torch.from_numpy(edges).to(cuda_device)
    got = tcc._cc_run(e, n)
    assert torch.equal(got.long(), tcc.cc_plain(e.long(), n))
    assert np.array_equal(got.cpu().numpy(), union_find(n, edges))


def _k11_sorted_graph(kind):
    if kind == 'random_sorted_2m':      # graph (b) in cluster's order
        n, edges = random_graph(2_000_000, 8_000_000, seed=14)
    elif kind == 'star_sorted':         # (k, n - 1): one shared root
        n, edges = star(200_000)
    else:                               # E >= 2n: sample, compress, skip
        n, edges = random_graph(20_000, 100_000, seed=15)
        if kind == 'sampled_given':
            return n, edges
    return n, build_edges_order(edges)


@pytest.mark.gpu
@pytest.mark.parametrize('kind', ['random_sorted_2m', 'star_sorted',
                                  'sampled_given', 'sampled_sorted'])
def test_k11_kernel_sorted_and_sampled(cuda_device, kind):
    """The sorted giant component and star, and a graph of E >= 2n (the
    sample, the compress and the skipped blocks) as given and sorted."""
    n, edges = _k11_sorted_graph(kind)
    e = torch.from_numpy(edges).to(cuda_device)
    got = tcc._cc_run(e, n)
    assert torch.equal(got.long(), tcc.cc_plain(e.long(), n))
    assert np.array_equal(got.cpu().numpy(), least_member_labels(n, edges))


@pytest.mark.gpu
def test_k11_kernel_after_other_sizes_on_one_stream(cuda_device):
    """Calls of other sizes and paths (every edge hooked once, or sampled
    first; inside L2's access-policy window, whose edges exceed L2, or
    not) in turn on one stream, each into labels whose memory the caching
    allocator hands back poisoned from a tensor just freed."""
    graphs = [random_graph(300_000, 1_500_000, seed=16), star(1_000),
              random_graph(1_000_000, 7_000_000, seed=20),
              near_ids(50_000, 40_000, seed=17),
              (300_000, build_edges_order(random_graph(300_000, 900_000,
                                                       seed=18)[1])),
              random_graph(7, 30, seed=19), (5, np.zeros((0, 2), np.int32))]
    for k, (n, edges) in enumerate(graphs * 2):
        e = torch.from_numpy(edges).to(cuda_device)
        poison = torch.full((n,), -7, dtype=torch.int32, device=cuda_device)
        del poison
        got = tcc._cc_run(e, n).cpu().numpy()
        assert np.array_equal(got, least_member_labels(n, edges)
                              if len(edges) else np.arange(n)), k


@pytest.mark.gpu
def test_k11_wrapper_raises_on_bad_arguments(cuda_device):
    """On the card K11's wrapper raises, and neither launches nor falls
    back to the plain version, on an edge outside [0, n), the wrong dtype,
    layout or alignment, and n >= 2^31."""
    e = torch.tensor([[0, 1], [2, 5]], dtype=torch.int32, device=cuda_device)
    before = tcc._cc_run.launches
    with pytest.raises(ValueError, match=r'\[0, 5\)'):
        tcc._cc_run(e, 5)
    with pytest.raises(ValueError, match=r'\[0, 6\)'):
        tcc._cc_run(-e, 6)
    with pytest.raises(TypeError, match='int32'):
        tcc._cc_run(e.long(), 6)
    with pytest.raises(ValueError, match='contiguous'):
        tcc._cc_run(e.t(), 6)
    with pytest.raises(ValueError, match='2\\^31'):
        tcc._cc_run(e, 2 ** 31)
    with pytest.raises(ValueError, match='8-byte aligned'):
        tcc._cc_run(torch.zeros(11, dtype=torch.int32,
                                device=cuda_device)[1:].view(5, 2), 6)
    assert tcc._cc_run.launches == before
