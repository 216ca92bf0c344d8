"""The check's controls, on the card at the cells' own sizes: the program
with one of its own cheaper paths switched on must read `correct` false,
and the program as it stands true, on three seeds each. Each control is a
step a later change could be tempted by:

- VCLUST_ALIGN_V3_H=1024: half the hashed seed buckets of the v3
  occupancies (K2's work halves; stage 1's candidates change). Where v2
  re-runs nearly every pair it reaches only the few that v3 keeps, so it
  reads 1-4 mismatches in the vOTU cell, and 0 on one seed of
  `complete_131k`, which therefore does not list it; where members keep
  their base's length, v3's aggregates stand for nearly every pair;
- VCLUST_ALIGN_V3_COV=0: the hybrid keeps v3's aggregates of the pairs it
  would align again on v2;
- VCLUST_ALIGN_C=8: v2 at half its seed density (the two-phase screen's
  first pass).

Run on the card: python -m pytest -m gpu benchmark/tests/test_bench_control.py
"""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())
CONTROLS = {'v3_h_1024': {'VCLUST_ALIGN_V3_H': '1024'},
            'no_rerun': {'VCLUST_ALIGN_V3_COV': '0'},
            'c8': {'VCLUST_ALIGN_C': '8'}}
# The control each cell must fail (its why names the layer it covers).
MUST_FAIL = {'imgvr_votu.complete': ('v3_h_1024', 'no_rerun', 'c8'),
             'imgvr_votu.whole': ('v3_h_1024', 'no_rerun', 'c8'),
             'imgvr_votu.whole_131k': ('v3_h_1024', 'no_rerun', 'c8'),
             'imgvr_votu.complete_131k': ('no_rerun', 'c8'),
             'ictv_species.genus': ('no_rerun', 'c8')}
SEEDS = (4000001, 4000002, 2 ** 31 + 4000003)
SECONDS = 8


def run_once(workload, seed, env=None):
    """The run's result line, and the end of its stderr (the check's
    numbers and mismatches)."""
    e = dict(os.environ)
    e.update(env or {})
    out = subprocess.run(
        [sys.executable, str(BENCH / 'run.py'), '--workload', workload,
         '--seed', str(seed), '--seconds', str(SECONDS)],
        cwd=ROOT, env=e, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr[-4000:]


CASES = [(w['name'], c) for w in SPEC['workloads']
         for c in MUST_FAIL.get(w['name'], ())]


@pytest.mark.gpu
@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('workload,control', CASES)
def test_control_is_not_correct(cuda_device, workload, control, seed):
    res, err = run_once(workload, seed, CONTROLS[control])
    print(res['checks'])
    assert res['correct'] is False, err
    assert res['checks']['mismatched_pairs']['value'] > 0


@pytest.mark.gpu
@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('workload', [w['name'] for w in SPEC['workloads']])
def test_program_is_correct(cuda_device, workload, seed):
    res, err = run_once(workload, seed)
    assert res['correct'] is True, err
