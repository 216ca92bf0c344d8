"""BENCHMARK.json against its required form, the files it names, the
import boundary, and the result line's keys."""

import ast
import json
import re

import pytest

from conftest import BENCH, ROOT

SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'vclust_tpu'}


def test_top_level_keys():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['benchmark']
    assert 1 <= SPEC['run_seconds'] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_and_units():
    names = []
    for c in SPEC['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        names.append(c['name'])
        assert all(NAME.match(k) for k in c['reduced'])
    for w in SPEC['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and len(w['why']) <= 200
        names += [w['name'], w['config'], w['traffic']]
    for m in SPEC['end_to_end'] + SPEC['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'layer', 'moves', 'workloads'}
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        names.append(m['name'])
    assert all(NAME.match(n) for n in names), names
    for field in [c['source'] for c in SPEC['configs']] + [
            c['why'] for c in SPEC['configs']] + [
            m['layer'] for m in SPEC['per_layer']] + SPEC['command']:
        assert 1 <= len(field) <= 200 and '\n' not in field \
            and '\t' not in field


def test_metrics_and_bounds():
    e2e = {m['name']: m for m in SPEC['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in SPEC['per_layer']:
        assert m['moves'] in e2e and 'bound' not in m
        assert (BENCH / 'metrics' / f"{m['name']}.py").exists()
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')


def test_files_found_by_name():
    for c in SPEC['configs']:
        f = ROOT / c['file']
        assert f.parent == BENCH / 'configs' and f.stem == c['name']
        cfg = json.loads(f.read_text())
        assert cfg['name'] == c['name'] and cfg['reduced'] == c['reduced']
        assert cfg['assumed'] and cfg['source']
    for w in SPEC['workloads']:
        assert (BENCH / 'traffic' / f"{w['traffic']}.json").exists()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split('.')[0]


def test_import_boundary():
    """Nothing under benchmark/ imports jax or the JAX package (top-level
    names compared whole: the port's name begins with the JAX
    package's); the reference imports nothing of the port."""
    for path in BENCH.rglob('*.py'):
        found = set(_imports(path))
        assert not found & FORBIDDEN, (path, found & FORBIDDEN)
        if 'reference' in path.relative_to(BENCH).parts:
            assert 'vclust_tpu_torch' not in found, path


def test_result_line_keys(monkeypatch):
    """A run on the CPU at a tiny size: the required keys, and the
    numbers compared last."""
    import run
    from tiny import traffic
    monkeypatch.setenv('VCLUST_TORCH_DEVICE', 'cpu')
    monkeypatch.setattr(run, 'SAMPLE_PAIRS', 6)
    monkeypatch.setattr(run, 'SAMPLE_FLOOR', 2)
    cell = run.load_cell(SPEC['workloads'][0]['name'])
    cell['traffic'] = traffic()
    res = run.run_cell(cell, 2 ** 31 + 3, 0.5, False, device='cpu')
    assert list(res)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                             'device']
    assert list(res)[-1] == 'checks'
    assert res['correct'] is True and res['failed'] == 0
    assert set(res['metrics']) == {m['name'] for m in SPEC['end_to_end']}
    assert set(res['device']) == {'platform', 'kind', 'count',
                                  'memory_peak_bytes'}
    assert res['checks'] == {'mismatched_pairs': {'value': 0, 'limit': 0}}
    json.dumps(res)


def test_no_card_no_result(monkeypatch, capsys):
    """Without the card the harness exits with an error and prints no
    result."""
    import torch
    import run
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert run.main(['--workload', SPEC['workloads'][0]['name'], '--seed', '1',
                     '--seconds', '1']) != 0
    assert capsys.readouterr().out == ''


@pytest.mark.parametrize('w', [w['name'] for w in SPEC['workloads']])
def test_cells_load(w):
    import run
    cell = run.load_cell(w)
    assert cell['end_to_end'] and cell['per_layer']
