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

from vclust_tpu_torch.ops import extend as tx      # noqa: E402
from vclust_tpu_torch.ops import prefilter as tpf  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _index(seed, n, n_patterns, max_len, max_w):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, max_len + 1, n_patterns).astype(np.int32)
    gids = np.concatenate([np.sort(rng.choice(n, ln, replace=False))
                           for ln in lens])
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


def _k1_both(index, device, **chunking):
    n = index.n
    n_limbs, chunks = tpf.device_chunks(index, device, **chunking)
    k = torch.zeros((n, n), dtype=torch.int32, device=device)
    p = torch.zeros_like(k)
    for gids, offs, w in chunks:
        tpf.occupancy_count(k, gids, offs, w, n_limbs)
        tpf.occupancy_count_plain(p, gids, offs, w)
    return k, p, len(chunks)


@pytest.mark.gpu
@pytest.mark.parametrize('n,n_patterns,max_len,max_w', [
    (6, 40, 6, 300), (70, 3000, 20, 255), (200, 5000, 64, 70000),
    (1000, 300, 256, 2 ** 24 - 1)])
def test_k1_kernel_matches_plain(cuda_device, n, n_patterns, max_len, max_w):
    idx = _index(n + n_patterns, n, n_patterns, min(max_len, n), max_w)
    k, p, n_chunks = _k1_both(idx, cuda_device, rows_chunk=1024,
                              nnz_chunk=max(2048, n + 1))
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert n_chunks >= 1


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


@pytest.mark.gpu
def test_kernel_launches_counted(cuda_device):
    q, ref = _seqs()
    before = tx.extend.launches
    tx.batched_extend(tx.pad_codes(q), tx.pad_codes(ref),
                      np.zeros(3, np.int32), np.zeros(3, np.int32), len(q),
                      len(ref), device=cuda_device)
    assert tx.extend.launches == before + 1
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
