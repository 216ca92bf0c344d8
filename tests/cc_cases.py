"""Graphs for the connected-components tests (K11 and its plain version):
the shapes that break label propagation or union-find, made from a seed
with numpy. Each returns (n, edges) with edges an (E, 2) int32 array."""

import numpy as np


def path(n, seed=None):
    """A path through all n nodes; with a seed, in a random order of ids
    (pointer jumping's worst case)."""
    ids = (np.arange(n) if seed is None
           else np.random.default_rng(seed).permutation(n))
    return n, np.stack([ids[:-1], ids[1:]], axis=1).astype(np.int32)


def star(n):
    """Every node joined to the largest id."""
    leaves = np.arange(n - 1)
    return n, np.stack([np.full(n - 1, n - 1), leaves],
                       axis=1).astype(np.int32)


def mixed(n, seed):
    """Isolated nodes (half of them), self loops, and edges among the other
    half each given twice, the second time reversed."""
    rng = np.random.default_rng(seed)
    live = rng.choice(n, n // 2, replace=False)
    pairs = live[rng.integers(0, len(live), (n // 4, 2))]
    loops = rng.choice(n, n // 8, replace=False)
    edges = np.concatenate([pairs, pairs[:, ::-1],
                            np.stack([loops, loops], axis=1)])
    return n, edges[rng.permutation(len(edges))].astype(np.int32)


def random_graph(n, n_edges, seed):
    """Uniform random edges: one giant component above n / 2 edges, many
    small ones below."""
    rng = np.random.default_rng(seed)
    return n, rng.integers(0, n, (n_edges, 2)).astype(np.int32)


def near_ids(n, draws, seed, gap=64):
    """chip_smoke.py's recipe: edges between ids fewer than `gap` apart,
    unique pairs (many small components)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, draws)
    b = a + rng.integers(1, gap, draws)
    return n, np.unique(np.stack([a, b], axis=1)[b < n],
                        axis=0).astype(np.int32)


def build_edges_order(edges):
    """The edges as `cluster`'s build_edges hands them to K11: self loops
    dropped, each pair as (i, j) with i < j, unique, sorted by (i, j)."""
    e = np.sort(np.asarray(edges).reshape(-1, 2), axis=1)
    return np.unique(e[e[:, 0] != e[:, 1]], axis=0).astype(np.int32)


def union_find(n, edges):
    """The host union-find's labels: each component's least member id."""
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges.tolist():
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return np.array([find(i) for i in range(n)], dtype=np.int32)


def least_member_labels(n, edges):
    """scipy's connected components, each mapped to its least member id
    (a host reference for graphs too large for a Python union-find)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    m = coo_matrix((np.ones(len(edges), np.int8), (edges[:, 0], edges[:, 1])),
                   shape=(n, n))
    _, comp = connected_components(m, directed=False)
    least = np.full(comp.max() + 1, n, dtype=np.int64)
    np.minimum.at(least, comp, np.arange(n))
    return least[comp].astype(np.int32)


def model_graphs():
    """(name, n, edges): the small graphs every K11 check runs."""
    return [
        ('path', *path(300)),
        ('path_permuted', *path(300, seed=1)),
        ('star_on_largest', *star(300)),
        ('isolated', 200, np.array([[5, 9], [150, 3]], np.int32)),
        ('self_loops', 100, np.stack([np.arange(100)] * 2,
                                     axis=1).astype(np.int32)),
        ('duplicates_reversed', 250, np.concatenate(
            [path(250, seed=6)[1]] * 2 + [path(250, seed=6)[1][:, ::-1]])),
        ('mixed', *mixed(400, seed=2)),
        ('giant', *random_graph(300, 1200, seed=3)),
        ('random_sparse', *random_graph(400, 150, seed=4)),
        ('near_ids', *near_ids(500, 300, seed=5, gap=8)),
    ]
