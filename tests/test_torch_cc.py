"""The port's connected components on the CPU (`_cc_run`'s plain version,
cc_plain) against the JAX package's `connected_components_device` and the
host union-find, on the graphs that are hard for label propagation: paths
with identity and permuted ids, a star on the largest id, isolated nodes
with self loops and duplicate reversed edges, one giant component, many
small ones. Labels are integers: equal, bit for bit. Each (n, E) shape is
one XLA compile of the JAX side, so the graphs share four shapes."""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, 'tests')

from cc_cases import (mixed, near_ids, path, random_graph,  # noqa: E402
                      star, union_find)
from vclust_tpu.ops.cc import connected_components_device as jcc  # noqa
from vclust_tpu_torch.ops import cc as tcc  # noqa: E402

torch.set_num_threads(1)

N = 5000
GRAPHS = {
    # n = 5,000, E = 4,999: one shape for all three.
    'path': lambda: path(N),
    'path_permuted': lambda: path(N, seed=7),
    'star_on_largest': lambda: star(N),
    # n = 2,000: 1,000 edges among half the nodes, each twice (once
    # reversed), 250 self loops.
    'mixed': lambda: mixed(2000, seed=8),
    # One giant component plus stragglers, and many small components:
    # n = 4,000 with 16,000 edges; 5,000 with 2,500 at two seeds.
    'giant': lambda: random_graph(4000, 16000, seed=9),
    'random_sparse_a': lambda: random_graph(N, 2500, seed=10),
    'random_sparse_b': lambda: random_graph(N, 2500, seed=11),
}


@pytest.mark.parametrize('name', list(GRAPHS))
def test_cc_port_matches_jax_and_union_find(name):
    n, edges = GRAPHS[name]()
    got = tcc.connected_components_device(n, edges, device='cpu')
    assert got.dtype == np.int32
    want = union_find(n, edges)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jcc(n, edges)))


def test_cc_near_ids_matches_jax():
    """chip_smoke.py's recipe (ids fewer than 64 apart) at n = 5,000,
    2,500 edges, the shape of the sparse graphs above."""
    n, edges = near_ids(N, 2600, seed=12)
    edges = edges[:2500]
    assert len(edges) == 2500
    got = tcc.connected_components_device(n, edges, device='cpu')
    assert np.array_equal(got, union_find(n, edges))
    assert np.array_equal(got, np.asarray(jcc(n, edges)))


def test_cc_wrapper_raises_on_bad_input():
    e = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    with pytest.raises(ValueError, match=r'\[0, 3\)'):
        tcc._cc_run(e, 3)
    with pytest.raises(ValueError, match=r'\[0, 4\)'):
        tcc._cc_run(torch.tensor([[0, -1]], dtype=torch.int32), 4)
    with pytest.raises(TypeError, match='int32'):
        tcc._cc_run(e.long(), 4)
    with pytest.raises(ValueError, match='2\\^31'):
        tcc._cc_run(e, 2 ** 31)
    with pytest.raises(ValueError, match=r'\(E, 2\)'):
        tcc._cc_run(torch.zeros((2, 3), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match=r'\[0, 3\)'):
        tcc.connected_components_device(3, np.array([[0, 3]]), device='cpu')
