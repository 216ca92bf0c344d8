"""The port's mesh paths (vclust_tpu_torch/parallel/) on the CPU.

A mesh of n CPU shards stands in for n cards (`make_mesh(n, device='cpu')`).
Held bit for bit:
- the sharded K1 count (each pass's work list cut among the shards) against
  the JAX package's mesh-sharded count on the conftest's 8 virtual CPU
  devices, and against the host counts;
- `run_prefilter` over a mesh, batched and not, against the host backend;
- the dense sharded products and prefilter step against the JAX
  package's parallel/mesh.py, and `entry()` against its `entry`;
- the sharded device align engine (v3 alone, the hybrid, records, a
  MAX_ARENA cap, several dispatches of ragged slices) against the port's
  single-device run. No JAX align program is compiled here: the port's
  single-device engine equals the JAX package's in test_torch_align_v3.py
  and test_torch_align_v2.py.
"""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, '.')

import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402
from vclust_tpu.ops import prefilter as jpf                    # noqa: E402
from vclust_tpu.parallel import mesh as jmesh                  # noqa: E402
from vclust_tpu_torch import entry as tentry                   # noqa: E402
from vclust_tpu_torch.models.input import Genome               # noqa: E402
from vclust_tpu_torch.models.prefilter import run_prefilter    # noqa: E402
from vclust_tpu_torch.ops import align_gpu as ag               # noqa: E402
from vclust_tpu_torch.ops import prefilter as tpf              # noqa: E402
from vclust_tpu_torch.parallel import mesh as tmesh            # noqa: E402
from test_torch_kernels import _hybrid_codes                   # noqa: E402

# Six pytest workers share the machine: one torch thread each.
torch.set_num_threads(1)


def _cpu_mesh(n):
    return tmesh.make_mesh(n, device='cpu')


def _random_sets(n, rng):
    # tests/test_mesh.py:_random_sets
    return [np.unique(rng.integers(0, 200_000, rng.integers(200, 800))
                      .astype(np.uint64)) for _ in range(n)]


@pytest.fixture(scope='module')
def sets37():
    """tests/test_mesh.py's 37 sets (not divisible by the mesh), the JAX
    package's index of them and its count over its 8-device mesh."""
    if len(jax.devices()) < 8:
        pytest.skip('needs the conftest\'s 8 virtual CPU devices')
    sets = _random_sets(37, np.random.default_rng(0))
    ji = jpf.PrefilterIndex(sets)
    want = jpf.shared_kmer_counts_indexed(ji, mesh=jmesh.make_mesh())
    return sets, ji, want


@pytest.mark.parametrize('shards', [2, 3, 8])
def test_sharded_counts_match_jax(sets37, monkeypatch, shards):
    sets, ji, want = sets37
    idx = tpf.index_from_numpy(ji.n, ji.sizes, ji.gids, ji.lens, ji.weights)
    parts = []
    real = tpf.occupancy_count

    def spy(counts, chunk):
        parts.append(len(chunk.work))
        return real(counts, chunk)

    monkeypatch.setattr(tpf, 'occupancy_count', spy)
    got = tpf.shared_kmer_counts_indexed(idx, mesh=_cpu_mesh(shards))
    assert np.array_equal(got, want)
    assert np.array_equal(got, jpf.shared_kmer_counts_host(sets))
    # The work list was cut: each shard launched a part of it (one item at
    # least, so 8 shards share the one tile's 4 k-blocks 4 ways).
    _, (chunk,) = tpf.device_chunks(idx, 'cpu', shards=shards)
    assert len(parts) == min(shards, len(chunk.work)) > 1
    assert sum(parts) == len(chunk.work)


def test_sharded_counts_of_a_mesh_of_one_and_of_batches(sets37):
    sets, ji, want = sets37
    idx = tpf.index_from_numpy(ji.n, ji.sizes, ji.gids, ji.lens, ji.weights)
    assert np.array_equal(
        tpf.shared_kmer_counts_indexed(idx, mesh=_cpu_mesh(1)), want)
    # tests/test_mesh.py:test_batched_prefilter_under_mesh_matches_host
    sets = _random_sets(23, np.random.default_rng(5))
    expect = jpf.shared_kmer_counts_host(sets)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        store = tpf.BatchIndexStore(tmp)
        for lo in range(0, 23, 10):
            store.add_batch(sets[lo:lo + 10], lo)
        got = np.zeros_like(expect)
        nb = len(store.batches)
        for i in range(nb):
            for j in range(i, nb):
                ro, co, blk = store.pair_block(i, j, mesh=_cpu_mesh(3))
                got[ro:ro + blk.shape[0], co:co + blk.shape[1]] = blk
                if i != j:
                    got[co:co + blk.shape[1], ro:ro + blk.shape[0]] = blk.T
    assert np.array_equal(got, expect)


def _mutant_genomes(n_base, length, seed):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b'ACGT', dtype='S1')
    genomes = []
    for i in range(n_base):
        s = acgt[rng.integers(0, 4, length)]
        genomes.append(Genome(name=f'g{i}', seqs=[s.tobytes()]))
        mut = s.copy()
        mask = rng.random(len(mut)) < 0.02
        mut[mask] = acgt[rng.integers(0, 4, mask.sum())]
        genomes.append(Genome(name=f'g{i}m', seqs=[mut.tobytes()]))
    return genomes


@pytest.mark.parametrize('n_base,length,batch_size', [(20, 3000, 0),
                                                     (12, 2500, 7)])
def test_run_prefilter_under_mesh_matches_host(n_base, length, batch_size):
    """tests/test_mesh.py's run_prefilter cases, batched and not."""
    genomes = _mutant_genomes(n_base, length, 1 if batch_size == 0 else 6)
    a = run_prefilter(genomes, k=15, batch_size=batch_size,
                      mesh=_cpu_mesh(3))
    b = run_prefilter(genomes, k=15, backend='host')
    assert a.entries == b.entries and len(a.entries) >= n_base


@pytest.fixture(scope='module')
def dense():
    """A (64, 512) {0,1} occupancy and set sizes at least its row sums."""
    rng = np.random.default_rng(3)
    occ = (rng.random((64, 512)) < rng.uniform(0.05, 0.4, (64, 1))).astype(
        np.int8)
    sizes = occ.sum(axis=1) + rng.integers(0, 40, 64)
    return occ, sizes


def test_sharded_pair_counts_match_jax(dense):
    occ, _ = dense
    want = np.asarray(jmesh.sharded_pair_counts(
        jmesh.make_mesh(), jnp.asarray(occ, jnp.bfloat16)))
    for shards in (1, 4):
        got = tmesh.sharded_pair_counts(_cpu_mesh(shards), occ)
        assert got.dtype == np.int32
        assert np.array_equal(got, want)


def test_sharded_prefilter_step_matches_jax(dense):
    occ, sizes = dense
    args = dict(k=25, min_ident=0.985, min_kmers=20)
    jc, jkeep, jn = jmesh.sharded_prefilter_step(
        jmesh.make_mesh(), jnp.asarray(occ, jnp.bfloat16),
        jnp.asarray(sizes), **args)
    jkeep = np.asarray(jkeep)
    assert 0 < jkeep.sum() < jkeep.size // 4
    for shards in (2, 8):
        counts, keep, n = tmesh.sharded_prefilter_step(
            _cpu_mesh(shards), occ, sizes, **args)
        assert np.array_equal(counts, np.asarray(jc))
        assert np.array_equal(keep, jkeep)
        assert n == int(jn) == keep.sum()


def test_entry_matches_jax_entry():
    import __graft_entry__ as graft
    jfn, jargs = graft.entry()
    jc, jsim, jkeep = (np.asarray(x) for x in jax.jit(jfn)(*jargs))
    fn, args = tentry.entry(device='cpu')
    assert args[0].dtype == torch.int8 and tuple(args[0].shape) == (128, 8192)
    assert np.array_equal(args[0].numpy(), np.asarray(jargs[0], np.int8))
    counts, sim, keep = (x.numpy() for x in fn(*args))
    assert counts.dtype == np.int32 and np.array_equal(counts, jc)
    assert sim.dtype == np.float32
    finite = np.isfinite(jsim)
    assert np.array_equal(np.isfinite(sim), finite)
    assert np.array_equal(sim[~finite], jsim[~finite])
    np.testing.assert_allclose(sim[finite], jsim[finite], rtol=1e-6, atol=0)
    assert np.array_equal(keep, jkeep)


def _pairs(n):
    return np.array([(i, j) for i in range(n) for j in range(i + 1, n)],
                    np.int32)


def _equal(a, b, keep):
    if not keep:
        return np.array_equal(a, b)
    return (np.array_equal(a[0], b[0]) and np.array_equal(a[1][0], b[1][0])
            and np.array_equal(a[1][1], b[1][1]))


def _spy_cores(setattr_, calls):
    """Route the row cores through spies that log (pipe, rows) a call."""
    cores = {'v3': ag._row_core_v3, 'v2': ag._row_core}

    def spy(pipe):
        def core(b, r_rows, *args, **kw):
            calls.append((pipe, len(r_rows)))
            return cores[pipe](b, r_rows, *args, **kw)
        return core

    setattr_(ag, '_row_core_v3', spy('v3'))
    setattr_(ag, '_row_core', spy('v2'))
    return cores


@pytest.fixture(scope='module')
def hybrid_single():
    """The hybrid corpus's single-device runs: all2all_gpu (hybrid) and v3
    alone, with and without records, and the dispatches' rows of each."""
    codes = _hybrid_codes()
    pairs = _pairs(len(codes))
    out, calls = {}, {}
    for keep in (False, True):
        for path in ('hybrid', 'v3'):
            calls[path, keep] = []
            cores = _spy_cores(setattr, calls[path, keep])
            try:
                out[path, keep] = (
                    ag.all2all_gpu(codes, pairs, device='cpu',
                                   keep_alignments=keep) if path == 'hybrid'
                    else ag._all2all_single(codes, pairs, device='cpu',
                                            keep_alignments=keep, pipe='v3'))
            finally:
                ag._row_core_v3, ag._row_core = cores['v3'], cores['v2']
    return codes, pairs, out, calls


@pytest.mark.parametrize('keep', [False, True])
@pytest.mark.parametrize('path,shards,rows,cap', [
    ('v3', 2, None, 0), ('v3', 3, 2, 0), ('hybrid', 2, None, 0),
    ('hybrid', 3, 4, 0), ('hybrid', 3, None, 3)])
def test_sharded_align_matches_single_device(hybrid_single, monkeypatch,
                                             keep, path, shards, rows, cap):
    """The sharded engine == the single device's, bit for bit: dispatches
    of `rows` rows dealt to the shards (so some shards get none), and
    sub-arenas under a MAX_ARENA cap."""
    codes, pairs, single, single_calls = hybrid_single
    want = single[path, keep]
    if rows is not None:
        monkeypatch.setattr(ag, '_dispatch_rows', lambda L, K, d, a: rows)
        monkeypatch.setattr(ag, '_dispatch_rows_v2', lambda L, K, a: rows)
    monkeypatch.setattr(ag, 'MAX_ARENA', cap)
    mesh = _cpu_mesh(shards)
    calls = []
    _spy_cores(monkeypatch.setattr, calls)
    if path == 'v3':
        got = ag._all2all_single(codes, pairs, keep_alignments=keep,
                                 pipe='v3', mesh=mesh)
    else:
        got = ag.all2all_gpu(codes, pairs, keep_alignments=keep, mesh=mesh)
    assert _equal(got, want, keep)
    # Whole dispatches of at most B rows, none cut among the shards: at
    # the single device's B, the single device's dispatches. The hybrid
    # re-ran hard pairs on v2 over the mesh too.
    assert calls and all(n <= (rows or 10 ** 9) for _, n in calls)
    if rows is None and not cap:
        assert calls == single_calls[path, keep]
    assert ('v2' in {p for p, _ in calls}) == (path == 'hybrid')


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('this box has CUDA')
    assert tmesh.auto_mesh() is None
    with pytest.raises(RuntimeError):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError):
        tentry.entry()
    with pytest.raises(RuntimeError):
        tentry.dryrun_multichip(2)
    mesh = _cpu_mesh(3)
    assert mesh.devices == (torch.device('cpu'),) * 3 and mesh.group is None
    assert tmesh.local_shards(mesh) == (
        [(s, torch.device('cpu')) for s in range(3)], 3)


def test_dryrun_multichip_on_cpu_shards(capsys):
    tentry.dryrun_multichip(4, device='cpu')
    assert 'dryrun_multichip(4): OK' in capsys.readouterr().out
