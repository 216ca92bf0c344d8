"""The torch port stands apart from the JAX package.

- Importing vclust_tpu_torch and every submodule loads neither jax nor any
  vclust_tpu module (checked in a fresh interpreter).
- No source file of the port imports jax or names the JAX package.
- Entry points called without a device, on a box without CUDA, raise
  rather than fall back to the CPU.
"""

import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import FASTA_FILE, REPO

sys.path.insert(0, str(REPO))

# Six pytest workers share the machine: one torch thread each.
torch.set_num_threads(1)

PKG = REPO / 'vclust_tpu_torch'

_IMPORT_ALL = r'''
import importlib, json, pkgutil, sys
import vclust_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vclust_tpu_torch.__path__,
                                               'vclust_tpu_torch.')]
for name in names:
    importlib.import_module(name)
print(json.dumps({
    'imported': names,
    'jax': sorted(m for m in sys.modules if m == 'jax' or
                  m.startswith('jax.') or m.startswith('jaxlib')),
    'reference': sorted(m for m in sys.modules if m == 'vclust_tpu' or
                        m.startswith('vclust_tpu.')),
}))
'''


def test_import_loads_no_jax_and_no_reference():
    env = {'PATH': '/usr/bin:/bin', 'PYTHONPATH': str(REPO),
           'JAX_PLATFORMS': 'cpu'}
    p = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=REPO,
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert 'vclust_tpu_torch.ops.prefilter' in got['imported']
    assert 'vclust_tpu_torch.cli' in got['imported']
    assert got['jax'] == []
    assert got['reference'] == []


@pytest.mark.parametrize('pattern', [
    r'^\s*(import|from)\s+jax\b',
    r'\bjax\.',
    r'vclust_tpu(?!_torch)',
])
def test_sources_never_name_the_jax_package(pattern):
    rx = re.compile(pattern, re.M)
    sources = [p for p in PKG.rglob('*')
               if p.suffix in ('.py', '.cu', '.cuh', '.h')]
    assert sources
    hits = []
    for path in sources:
        text = path.read_text()
        hits += [f'{path.relative_to(REPO)}:{m.group(0)}'
                 for m in rx.finditer(text)]
    assert hits == []


def _no_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('this box has CUDA')
    monkeypatch.delenv('VCLUST_TORCH_DEVICE', raising=False)


def _sets():
    rng = np.random.default_rng(0)
    return [np.unique(rng.integers(0, 500, 200).astype(np.uint64))
            for _ in range(40)]


def _entry_points():
    from vclust_tpu_torch.io.formats import read_ani, read_ids
    from vclust_tpu_torch.models.cluster import ClusterParams, run_cluster
    from vclust_tpu_torch.models.align import run_align
    from vclust_tpu_torch.models.input import load_genomes
    from vclust_tpu_torch.models.prefilter import run_prefilter
    from vclust_tpu_torch.ops import align_gpu, cc, extend, prefilter
    gold = FASTA_FILE.parent / 'output'
    return {
        'shared_kmer_counts': lambda: prefilter.shared_kmer_counts(_sets()),
        'shared_kmer_counts_indexed': lambda:
            prefilter.shared_kmer_counts_indexed(
                prefilter.PrefilterIndex(_sets()), engine='device'),
        'batched_extend': lambda: extend.batched_extend(
            extend.pad_codes(np.zeros(10, np.int8)),
            extend.pad_codes(np.zeros(10, np.int8)),
            np.zeros(1, np.int32), np.zeros(1, np.int32), 10, 10),
        'connected_components': lambda: cc.connected_components_device(
            3, np.array([[0, 1]])),
        'all2all_v3': lambda: align_gpu._all2all_single(
            [np.zeros(100, np.int8)] * 2, np.array([[0, 1]]), pipe='v3'),
        'all2all_gpu': lambda: align_gpu.all2all_gpu(
            [np.zeros(100, np.int8)] * 2, np.array([[0, 1]])),
        'run_align_gpu': lambda: run_align(
            load_genomes(FASTA_FILE)[0][:2], engine='gpu'),
        'run_prefilter': lambda: run_prefilter(
            load_genomes(FASTA_FILE)[0]),
        'run_cluster': lambda: run_cluster(
            *read_ani(gold / 'ani.tsv'), read_ids(gold / 'ani.ids.tsv'),
            ClusterParams(metric='tani', metric_threshold=0.95)),
    }


@pytest.mark.parametrize('name', ['shared_kmer_counts',
                                  'shared_kmer_counts_indexed',
                                  'batched_extend', 'connected_components',
                                  'all2all_v3', 'all2all_gpu',
                                  'run_align_gpu', 'run_prefilter',
                                  'run_cluster'])
def test_entry_point_without_device_raises(monkeypatch, name):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        _entry_points()[name]()


def test_entry_point_with_cpu_device_runs(monkeypatch):
    _no_cuda(monkeypatch)
    from vclust_tpu_torch.ops import prefilter
    got = prefilter.shared_kmer_counts(_sets(), device='cpu')
    assert np.array_equal(got, prefilter.shared_kmer_counts_host(_sets()))


def test_cli_without_device_exits_1(monkeypatch, tmp_path):
    _no_cuda(monkeypatch)
    p = subprocess.run(
        [sys.executable, '-m', 'vclust_tpu_torch', 'prefilter', '-i',
         str(FASTA_FILE), '-o', str(tmp_path / 'fltr.txt'), '-v', '0'],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={'PATH': '/usr/bin:/bin', 'PYTHONPATH': str(REPO)})
    assert p.returncode == 1
    assert 'CUDA is not available' in p.stderr


def test_cuda_tensor_without_cuda_raises():
    """A wrapper never answers a CUDA tensor with its plain version."""
    if torch.cuda.is_available():
        pytest.skip('this box has CUDA')
    from vclust_tpu_torch.utils.device import resolve_device
    with pytest.raises(RuntimeError):
        resolve_device('cuda')
    assert resolve_device('cpu') == torch.device('cpu')


def test_build_dir_is_ignored():
    ignored = (REPO / '.gitignore').read_text().splitlines()
    assert 'vclust_tpu_torch/_build/' in ignored
    assert pathlib.Path(PKG / 'csrc' / 'occupancy.cu').exists()
    assert pathlib.Path(PKG / 'csrc' / 'extend.cu').exists()
    assert pathlib.Path(PKG / 'csrc' / 'align_v3.cu').exists()
