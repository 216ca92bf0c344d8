"""A model, in numpy, of K11 (csrc/cc.cu), held against the host
union-find's labels on the CPU. No JAX.

K11 is union-find on the edge list: `cc_init` sets parent[v] = v; in
`cc_hook` a thread an edge finds both roots, halving the path with plain
stores, and while the roots differ CASes the larger root's parent from
itself to the smaller root, finding again from what a failed CAS saw;
`cc_flatten` sets parent[v] to v's root, walked without stores (a
halving store there could put an ancestor back over a node's finished
label). The model runs the hook and the flatten in batches of threads:
each batch's finds read the state from before the batch, then its
stores and CASes land in a random order, and a CAS that fails retries
in the next batch from (what it saw, the smaller root). The hook's
finds read parent through L1, so each read returns any value that
location has held (a stale line), not only the newest; the CAS reads the
newest. After every hook batch parent[x] <= x must hold, and no thread may
retry more than n times (the kernel's cap). The labels must be each
component's least member index, whatever the order.
"""

import sys

import numpy as np
import pytest

sys.path.insert(0, 'tests')

from cc_cases import model_graphs, union_find  # noqa: E402

GRAPHS = model_graphs()


def _find(parent, x, read=None):
    """find_root on a fixed state: (root, the halving stores it makes).
    `read(x)`, where given, reads parent[x] in its place."""
    read = read or parent.__getitem__
    stores = []
    while True:
        p = read(x)
        if p == x:
            return x, stores
        gp = read(p)
        if gp != p:
            stores.append((x, gp))
        x = gp


def _walk(parent, x):
    """walk_root: the root of x, read only."""
    while parent[x] != x:
        x = parent[x]
    return x


def k11_model(n, edges, rng, max_batch):
    parent = np.arange(n)                              # cc_init
    # Every value each parent[x] has held: the hook's loads go through L1
    # and may return any of them (a stale line), not only the newest.
    history = [[x] for x in range(n)]

    def stale_read(x):
        h = history[x]
        return h[int(rng.integers(0, len(h)))]
    # A thread's state: (edge index, start of its two finds, retries).
    threads = [(i, int(a), int(b), 0) for i, (a, b) in enumerate(edges)
               if a != b]
    threads = [threads[i] for i in rng.permutation(len(threads))]
    while threads:
        k = int(rng.integers(1, max_batch + 1))
        batch, threads = threads[:k], threads[k:]
        events = []
        for i, x, y, tries in batch:
            ra, sa = _find(parent, x, stale_read)
            rb, sb = _find(parent, y, stale_read)
            events += [('store', s) for s in sa + sb]
            if ra != rb:
                events.append(('cas', (i, min(ra, rb), max(ra, rb), tries)))
        for j in rng.permutation(len(events)):
            kind, what = events[j]
            if kind == 'store':
                x, gp = what
                parent[x] = gp
                history[x].append(gp)
                continue
            i, lo, hi, tries = what
            seen = parent[hi]                          # the CAS reads L2
            if seen == hi:
                parent[hi] = lo
                history[hi].append(lo)
                continue
            assert tries < n, 'a thread passed the retry cap'
            # Retried later, in a batch of its own order.
            threads.insert(int(rng.integers(0, len(threads) + 1)),
                           (i, int(seen), lo, tries + 1))
        assert (parent <= np.arange(n)).all()
    for a, b in edges:
        assert _find(parent, a)[0] == _find(parent, b)[0]
    # cc_flatten: threads in batches that walk the state from before the
    # batch, without stores, each then storing its own node's root.
    order = rng.permutation(n)
    while len(order):
        k = int(rng.integers(1, max_batch + 1))
        batch, order = order[:k], order[k:]
        state = parent.copy()
        stores = [(v, _walk(state, v)) for v in batch]
        for j in rng.permutation(len(stores)):
            v, root = stores[j]
            parent[v] = root
    return parent


@pytest.mark.parametrize('name,n,edges', GRAPHS,
                         ids=[g[0] for g in GRAPHS])
@pytest.mark.parametrize('max_batch', [1, 16, 256])
def test_k11_model_matches_union_find(name, n, edges, max_batch):
    want = union_find(n, edges)
    for seed in range(3):
        got = k11_model(n, edges, np.random.default_rng(seed), max_batch)
        assert np.array_equal(got, want), (name, seed)


def test_k11_model_retries_under_contention():
    """Every edge of a star races for the same root: CASes fail and retry,
    and the labels still come out right."""
    n, edges = 64, np.stack([np.full(63, 63), np.arange(63)], axis=1)
    got = k11_model(n, edges, np.random.default_rng(0), max_batch=63)
    assert (got == 0).all()
