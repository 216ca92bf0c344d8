"""The plain versions of the index builds (`index_block_plain`, K10's, and
`index_block_v3_plain`, K9's, in vclust_tpu_torch/ops/align_gpu.py)
against the JAX package's `_index_block` and `_index_block_v3`
(vclust_tpu/ops/align_tpu.py), on the CPU, bit for bit, at bucket 4,096
on tests/index_cases.py's hard rows: a poly-A run of 2,100 bases, a
genome of N only, one that ends at the bucket's edge, a tandem repeat,
blocks with fewer valid positions than C, a short genome. The v2 index at
both pack widths (C = 16, and 8 at 32-bit packs), the v3 index at the
defaults. Every output is an integer, so the tolerance is 0; the index
programs are small XLA compiles (seconds)."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO

sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / 'tests'))

from index_cases import index_genomes, padded         # noqa: E402
from vclust_tpu.ops import align_tpu as ja            # noqa: E402
from vclust_tpu_torch.ops import align_gpu as ag      # noqa: E402

torch.set_num_threads(1)

BUCKET = 4096


@pytest.mark.parametrize('pack,C', [(32, 16), (64, 16), (32, 8)])
def test_index_block_plain_hard_rows_match_reference(pack, C):
    fwd, rc = padded(index_genomes(7, BUCKET), BUCKET)
    with ja._x64(pack):
        want = [np.asarray(a) for a in ja._index_block(
            jnp.asarray(fwd), jnp.asarray(rc), ja.SEED_K, pack, C)]
    got = ag.index_block_plain(torch.from_numpy(fwd), torch.from_numpy(rc),
                               ag.SEED_K, pack, C)
    for key, g, w in zip(ag._V2_KEYS, got, want):
        assert g.shape == w.shape, key
        assert np.array_equal(g.numpy().astype(np.int64),
                              w.astype(np.int64)), key
    # The all-N genome (row 1) has no valid seed; the poly-A run a long
    # run of value 0 with previous positions.
    assert (want[0][1] == -1).all() and (want[2][1] == ag.BIG).all()
    assert (want[2][0] == 0).sum() > 60


def test_index_block_v3_plain_hard_rows_match_reference():
    fwd, rc = padded(index_genomes(8, BUCKET), BUCKET)
    want = [np.asarray(a) for a in ja._index_block_v3(
        jnp.asarray(fwd), jnp.asarray(rc), ja.SEED_K, BUCKET)]
    got = ag.index_block_v3_plain(torch.from_numpy(fwd),
                                  torch.from_numpy(rc), ag.SEED_K, BUCKET)
    for key, g, w in zip(ag._V3_KEYS, got, want):
        assert g.shape == w.shape and np.array_equal(g.numpy(), w), key
    # The all-N genome marks only the last hash bucket (ROADMAP R8).
    assert (want[1][1, :, -1] == 1).all() and not want[1][1, :, :-1].any()
