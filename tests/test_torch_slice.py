"""The torch port's slice end to end on the CPU, against the JAX package.

The port's CLI (`python -m vclust_tpu_torch`, run in-process with
VCLUST_TORCH_DEVICE=cpu) drives prefilter -> align -> cluster; its output
files must be byte-identical to the JAX CLI's and, where the JAX package
matches them (fltr.txt, clusters.tsv), to the goldens in example/output/.
The JAX CLI runs once per corpus, shared by the tests of this file.
"""

import contextlib
import io
import json
import sys

import numpy as np
import pytest
import torch

from conftest import (DATASET_FILES, FASTA_FILE, GOLD_DIR, REPO,
                      run_vclust)
from hybrid_cases import write_hybrid_dir

sys.path.insert(0, str(REPO))

# Six pytest workers share the machine: one torch thread each.
torch.set_num_threads(1)


@pytest.fixture(scope='module', autouse=True)
def _cpu_device():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VCLUST_TORCH_DEVICE', 'cpu')
        yield


def run_port(args):
    """The port's CLI in-process; returns (exit code, stdout, stderr)."""
    from vclust_tpu_torch.cli import main
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            main([str(a) for a in args])
        except SystemExit as exc:
            code = int(exc.code or 0)
    return code, out.getvalue(), err.getvalue()


def _pipeline(run, fasta, out):
    """prefilter -> align --filter (native engine) -> cluster into `out`."""
    steps = [
        ['prefilter', '-i', fasta, '-o', out / 'fltr.txt', '-v', '0'],
        ['align', '-i', fasta, '-o', out / 'ani.tsv', '--filter',
         out / 'fltr.txt', '--filter-threshold', '0.7', '--engine',
         'native', '-v', '0'],
        ['cluster', '-i', out / 'ani.tsv', '--ids', out / 'ani.ids.tsv',
         '-o', out / 'clusters.tsv', '--metric', 'tani', '--tani', '0.95',
         '-v', '0'],
    ]
    for args in steps:
        code = run(args)
        assert code == 0, args
    return out


def _jax(args):
    p = run_vclust(args)
    assert p.returncode == 0, p.stderr
    return p.returncode


def _port(args):
    code, _, err = run_port(args)
    assert code == 0, err
    return code


def _corpus48():
    """bench.py:33-45: the 12 example genomes plus 3 mutants of each at 5%
    substitutions."""
    from vclust_tpu_torch.models.input import Genome, load_genomes
    genomes, _ = load_genomes(FASTA_FILE)
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


@pytest.fixture(scope='module')
def jax_example(tmp_path_factory):
    return _pipeline(_jax, FASTA_FILE, tmp_path_factory.mktemp('jax_ex'))


@pytest.fixture(scope='module')
def port_example(tmp_path_factory):
    return _pipeline(_port, FASTA_FILE, tmp_path_factory.mktemp('port_ex'))


@pytest.fixture(scope='module')
def corpus48(tmp_path_factory):
    from vclust_tpu_torch.io.fasta import FastaRecord, write_fasta
    path = tmp_path_factory.mktemp('c48') / 'corpus48.fna'
    write_fasta(path, [FastaRecord(g.name, g.name, g.seqs[0])
                       for g in _corpus48()])
    return path


@pytest.mark.parametrize('name', ['fltr.txt', 'ani.tsv', 'ani.ids.tsv',
                                  'clusters.tsv'])
def test_example_slice_matches_jax(jax_example, port_example, name):
    assert (port_example / name).read_bytes() == \
        (jax_example / name).read_bytes()


@pytest.mark.parametrize('name', ['fltr.txt', 'clusters.tsv'])
def test_example_slice_matches_golden(port_example, name):
    assert (port_example / name).read_bytes() == \
        (GOLD_DIR / name).read_bytes()


def test_corpus48_fltr_matches_jax(corpus48, tmp_path):
    """48 genomes: above the 32-genome host threshold, so both packages
    count on their device path (the port's K1 plain version here)."""
    _jax(['prefilter', '-i', corpus48, '-o', tmp_path / 'jax.txt',
          '-v', '0'])
    _port(['prefilter', '-i', corpus48, '-o', tmp_path / 'port.txt',
           '-v', '0'])
    assert (tmp_path / 'port.txt').read_bytes() == \
        (tmp_path / 'jax.txt').read_bytes()


def test_corpus48_batched_fltr_matches_unbatched(corpus48, tmp_path):
    """--batch-size runs the batch store's blockwise counts."""
    _port(['prefilter', '-i', corpus48, '-o', tmp_path / 'a.txt', '-v', '0'])
    _port(['prefilter', '-i', corpus48, '-o', tmp_path / 'b.txt', '-v', '0',
           '--batch-size', '20'])
    assert (tmp_path / 'a.txt').read_bytes() == \
        (tmp_path / 'b.txt').read_bytes()


@pytest.mark.parametrize('algorithm', ['single', 'complete', 'uclust',
                                       'cd-hit', 'set-cover', 'leiden'])
def test_cluster_algorithms_match_jax(jax_example, tmp_path, algorithm):
    args = ['-i', jax_example / 'ani.tsv', '--ids',
            jax_example / 'ani.ids.tsv', '--algorithm', algorithm,
            '--metric', 'ani', '--ani', '0.9', '-v', '0']
    for extra in ([], ['-r']):
        _jax(['cluster', *args, '-o', tmp_path / 'jax.tsv', *extra])
        _port(['cluster', *args, '-o', tmp_path / 'port.tsv', *extra])
        assert (tmp_path / 'port.tsv').read_bytes() == \
            (tmp_path / 'jax.tsv').read_bytes()


def test_align_py_engine_matches_native(tmp_path):
    """The Python oracle engine and the native engine agree on a few
    pairs (bit-identical measures)."""
    from vclust_tpu_torch.models.align import run_align
    from vclust_tpu_torch.models.input import load_genomes
    genomes, _ = load_genomes(FASTA_FILE)
    few = [genomes[i] for i in (0, 1, 4)]
    a = run_align(few, engine='py')
    b = run_align(few, engine='native')
    assert [vars(r) for r in a.rows] == [vars(r) for r in b.rows]


def test_align_gpu_engine_runs(tmp_path):
    """`align --engine gpu` (the device engine; on the CPU here) runs from
    the CLI: 3 kb pieces of three example genomes and a 5% mutant of one,
    with records."""
    from vclust_tpu_torch.io.fasta import FastaRecord, write_fasta
    from vclust_tpu_torch.models.input import load_genomes
    genomes, _ = load_genomes(FASTA_FILE)
    rng = np.random.default_rng(2)
    seqs = [np.frombuffer(g.seqs[0][5000:8000], dtype='S1').copy()
            for g in genomes[:5:2]]
    mut = seqs[0].copy()
    hit = rng.random(len(mut)) < 0.05
    mut[hit] = np.frombuffer(b'ACGT', dtype='S1')[rng.integers(0, 4,
                                                               hit.sum())]
    fasta = tmp_path / 'small.fna'
    write_fasta(fasta, [FastaRecord(f'g{k}', f'g{k}', s.tobytes())
                        for k, s in enumerate(seqs + [mut])])
    code, _, err = run_port(['align', '-i', fasta, '-o', tmp_path / 'ani.tsv',
                             '--out-aln', tmp_path / 'aln.tsv', '--engine',
                             'gpu', '-v', '0'])
    assert code == 0, err
    rows = (tmp_path / 'ani.tsv').read_text().splitlines()
    assert rows[0].startswith('qidx') and len(rows) >= 3
    assert {'g0', 'g3'} <= {r.split('\t')[2] for r in rows[1:]}
    assert (tmp_path / 'aln.tsv').read_text().count('\n') > 2
    assert (tmp_path / 'ani.ids.tsv').read_text().count('\n') == 5


def test_deduplicate_matches_jax(tmp_path):
    _jax(['deduplicate', '-i', *DATASET_FILES, '-o', tmp_path / 'jax.fna',
          '-v', '0'])
    _port(['deduplicate', '-i', *DATASET_FILES, '-o', tmp_path / 'port.fna',
           '-v', '0'])
    for suffix in ('', '.duplicates.txt'):
        assert (tmp_path / f'port.fna{suffix}').read_bytes() == \
            (tmp_path / f'jax.fna{suffix}').read_bytes()


def test_cli_surface(tmp_path):
    code, out, err = run_port([])
    assert code == 0 and out and not err
    code, out, _ = run_port(['prefilter'])
    assert code == 0 and 'prefilter' in out
    code, _, err = run_port(['cluster', '-i', FASTA_FILE, '-o',
                             tmp_path / 'c.tsv', '--ids', FASTA_FILE])
    assert code == 2 and 'error:' in err
    code, out, _ = run_port(['info'])
    assert code == 0 and 'torch' in out and 'csrc/occupancy.cu' in out


@pytest.mark.parametrize('stage', ['prefilter', 'align_gpu'])
def test_profile_trace(stage, tmp_path, monkeypatch):
    """VCLUST_PROFILE writes the stage's Chrome trace with the tracer's
    track (empty for the prefilter, which has no spans) and counters; on
    the CPU the spans keep the host clock, and the trace says so."""
    monkeypatch.setenv('VCLUST_PROFILE', str(tmp_path / 'prof'))
    if stage == 'prefilter':
        args = ['prefilter', '-i', FASTA_FILE, '-o', tmp_path / 'fltr.txt']
    else:
        args = ['align', '-i', write_hybrid_dir(tmp_path / 'genomes'), '-o',
                tmp_path / 'ani.tsv', '--engine', 'gpu']
    code, _, err = run_port(args + ['-v', '0'])
    assert code == 0, err
    path = tmp_path / 'prof' / f'{args[0]}.trace.json'
    trace = json.loads(path.read_text())
    meta = trace['vclust']
    assert 'host' in meta['clock']
    events = trace['traceEvents']
    track = [e for e in events if e.get('ph') == 'M'
             and e.get('args', {}).get('name') == 'vclust host spans']
    assert len(track) == 1
    spans = [e for e in events if e.get('cat') == 'vclust']
    assert {e['pid'] for e in spans} <= {track[0]['pid']}
    if stage == 'prefilter':
        assert not spans and meta['counters'] == {}
        return
    names = {e['name'] for e in spans}
    assert {'job', 'pipe', 'index.fill', 'pipe.group',
            'dispatch.launch'} <= names
    assert meta['counters']['dispatches'] > 0
    assert len(spans) == meta['spans']


def test_single_linkage_device_route_matches_jax():
    """From 50,000 objects single linkage runs the device connected
    components in both packages; the labels must agree."""
    from vclust_tpu.models.cluster import ClusterParams as JaxParams
    from vclust_tpu.models.cluster import run_cluster as jax_run_cluster
    from vclust_tpu_torch.models.cluster import ClusterParams, run_cluster
    rng = np.random.default_rng(5)
    n, n_rows = 50_000, 20_000
    objects = [(f'g{i}', 1000, 1) for i in range(n)]
    header = ['qidx', 'ridx', 'tani']
    rows = [[str(a), str(b), f'{v:.4f}'] for a, b, v in zip(
        rng.integers(0, n, n_rows), rng.integers(0, n, n_rows),
        rng.random(n_rows))]
    want = jax_run_cluster(header, rows, objects,
                           JaxParams(metric='tani', metric_threshold=0.5))
    got = run_cluster(header, rows, objects,
                      ClusterParams(metric='tani', metric_threshold=0.5),
                      device='cpu')
    assert got == want
    assert len(set(got)) < n
