"""The port's shared back half (`blocks_to_measures_plain`, the plain version
of kernel K4 in vclust_tpu_torch/ops/align_gpu.py) against the JAX
package's `_blocks_to_measures` (vclust_tpu/ops/align_tpu.py), called
directly on the CPU, bit for bit.

The inputs come from tests/back_half_cases.py at Lq = 4,096 (seeded numpy):
random flags with runs and mismatches, every block switchable, a break at
every block, all-false and all-true rows, segments across fine-block and
1,024-position borders, and a pair with more accepted segments than the
record cap holds. Every output is an integer, so the tolerance is 0: the
aggregates, the records and (the port's own output, which R4's guard
reads) the number of records before the cap, which is the number of
accepted segments.

Each parameter set is one JAX program over all of its cases' pairs (three
XLA compiles, a few seconds each on the CPU).
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from back_half_cases import CASES, PARAMS, back_half_case
from conftest import REPO

sys.path.insert(0, str(REPO))

from vclust_tpu.ops import align_tpu as ja            # noqa: E402
from vclust_tpu_torch.ops import align_gpu as ag      # noqa: E402

# Six pytest workers share the machine: one torch thread each.
torch.set_num_threads(1)

LQ = 4096
PAIRS = 3          # directed pairs a case


@functools.lru_cache(maxsize=None)
def _reference(params):
    """The cases of a parameter set as one batch, and the JAX package's
    aggregates and records for it (K = every pair; each pair's reference
    length broadcast from a column)."""
    cases = ('cap',) if params == 'cap' else CASES
    batch = [np.concatenate(xs) for xs in zip(*(
        back_half_case(case, LQ, seed, PAIRS)
        for seed, case in enumerate(cases)))]
    mqd, mrd, reg = PARAMS[params]
    fn = jax.jit(functools.partial(
        ja._blocks_to_measures, K=len(batch[0]), Lq=LQ, mqd=mqd, mrd=mrd,
        reg=reg, with_alns=True))
    *flags, rlen = batch
    agg, recs = fn(*(jnp.asarray(x) for x in flags),
                   jnp.asarray(rlen[:, None]))
    return cases, batch, np.asarray(agg), np.asarray(recs)


def _port(params, case):
    cases, batch, agg, recs = _reference(params)
    rows = slice(PAIRS * cases.index(case), PAIRS * (cases.index(case) + 1))
    mqd, mrd, reg = PARAMS[params]
    got = ag.blocks_to_measures_plain(
        *(torch.from_numpy(x[rows]) for x in batch), Lq=LQ, mqd=mqd, mrd=mrd,
        reg=reg, with_alns=True)
    return [x.numpy() for x in got], agg[rows], recs[rows]


@pytest.mark.parametrize('params', ['default', 'tight'])
@pytest.mark.parametrize('case', CASES)
def test_back_half_matches_reference(params, case):
    (agg, recs, nrec), want_agg, want_recs = _port(params, case)
    assert np.array_equal(agg, want_agg)
    assert np.array_equal(recs, want_recs)
    assert np.array_equal(nrec, want_agg[:, 0])
    if case != 'empty_full':
        assert (agg[:, 0] > 0).all()
    if case == 'empty_full':
        assert agg[0].tolist() == [0, 0, 0] and (agg[1:, 0] > 0).all()


def test_back_half_record_cap_matches_reference():
    """More accepted segments than MAXSEG: the first MAXSEG records in
    order, equal to the JAX package's, and the count before the cap."""
    (agg, recs, nrec), want_agg, want_recs = _port('cap', 'cap')
    maxseg = ag._maxseg(LQ, PARAMS['cap'][2])
    assert recs.shape == (PAIRS, maxseg, 6)
    assert np.array_equal(agg, want_agg)
    assert np.array_equal(recs, want_recs)
    assert (nrec == LQ // 12).all() and (nrec > maxseg).all()
    assert (recs[..., 0] >= 0).all()
    assert np.array_equal(recs[0, :3, :2], [[0, 10], [12, 22], [24, 34]])
