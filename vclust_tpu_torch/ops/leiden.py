"""Leiden community detection (host implementation, CPM objective).

Replaces clusty's igraph-backed Leiden mode (reference vclust.py:549-569;
flags --leiden-resolution/--leiden-beta/--leiden-iterations). The
reference's parameter set (resolution 0.7, beta 0.01, iterations 2) is
igraph `community_leiden`'s signature, whose objective is the Constant
Potts Model (CPM, Traag et al. 2019): quality = sum_C [W_in(C) -
resolution * n_C (n_C - 1) / 2]. CPM makes `resolution` a direct edge-
density threshold — natural for ANI-similarity graphs with weights in
[0, 1] (a pair merges when its weight exceeds ~resolution) — and is
aggregation-invariant, so the multi-level passes optimize one fixed
objective (no per-level renormalization by the remaining edge mass).

Standard Leiden structure: queue-based local moving, refinement with
beta-randomness restricted to each community, graph aggregation over the
*refined* partition. Deterministically seeded so repeated runs are
md5-stable, matching the reference's determinism contract (SURVEY.md
section 4.3). Semantic oracle: tests/test_leiden_semantics.py (planted
partitions, CPM-quality bounds, connectivity guarantee).

The graph lives in CSR arrays and all per-node work is vectorized numpy
(community-weight sums via unique+bincount on the neighbor slice), so the
million-contig vOTU configurations in BASELINE.md fit: cost is
O(E log deg) per local-move pass with no per-edge Python objects.
"""

from typing import List

import numpy as np


class _Graph:
    """CSR with per-node sizes; edges stored once per direction."""

    def __init__(self, n, src, dst, w, node_w):
        self.n = n
        order = np.lexsort((dst, src))
        self.dst = dst[order]
        self.w = w[order]
        counts = np.bincount(src, minlength=n)
        self.indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=self.indptr[1:])
        self.node_w = node_w

    def row(self, i):
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.dst[lo:hi], self.w[lo:hi]


def _comm_weights(labels, nb, wrow):
    """(unique communities among nb, summed edge weight to each)."""
    uc, inv = np.unique(labels[nb], return_inverse=True)
    return uc, np.bincount(inv, weights=wrow)


def _local_move(g: '_Graph', comm, resolution):
    """Queue-based local moving; mutates comm. Returns True if changed.

    CPM move gain for node i (size s_i) into community C (total size n_C,
    i excluded): w(i, C) - resolution * s_i * n_C. Monotone in the global
    CPM quality, so the pass terminates.
    """
    n = g.n
    comm_w = np.bincount(comm, weights=g.node_w, minlength=n)
    queue = list(range(n))
    in_queue = np.ones(n, dtype=bool)
    changed = False
    head = 0
    while head < len(queue):
        i = queue[head]
        head += 1
        in_queue[i] = False
        nb, wrow = g.row(i)
        if len(nb) == 0:
            continue
        ci = comm[i]
        comm_w[ci] -= g.node_w[i]
        uc, w_to = _comm_weights(comm, nb, wrow)
        gains = w_to - resolution * g.node_w[i] * comm_w[uc]
        pos = np.searchsorted(uc, ci)
        if pos < len(uc) and uc[pos] == ci:
            best_gain = gains[pos]
        else:
            best_gain = -resolution * g.node_w[i] * comm_w[ci]
        best_c = ci
        j = int(np.argmax(gains))
        if uc[j] != ci and gains[j] > best_gain + 1e-12:
            # ties among non-current communities: smallest id (uc sorted,
            # argmax returns the first maximum)
            best_c, best_gain = int(uc[j]), gains[j]
        elif uc[j] == ci and len(uc) > 1:
            g2 = gains.copy()
            g2[j] = -np.inf
            k = int(np.argmax(g2))
            if g2[k] > best_gain + 1e-12:
                best_c = int(uc[k])
        comm_w[best_c] += g.node_w[i]
        if best_c != ci:
            comm[i] = best_c
            changed = True
            requeue = nb[(comm[nb] != best_c) & ~in_queue[nb]]
            queue.extend(requeue.tolist())
            in_queue[requeue] = True
    return changed


def _refine(g: '_Graph', comm, resolution, beta, rng):
    """Refinement phase: within each community, grow well-connected
    subcommunities starting from singletons; beta controls randomness."""
    n = g.n
    sub = np.arange(n)
    sub_w = g.node_w.astype(float).copy()
    order = rng.permutation(n)
    for i in order:
        if sub_w[sub[i]] != g.node_w[i]:
            continue  # only singleton subcommunities may move
        nb, wrow = g.row(i)
        sel = comm[nb] == comm[i]
        if not sel.any():
            continue
        us, w_to = _comm_weights(sub, nb[sel], wrow[sel])
        keep = us != sub[i]
        us, w_to = us[keep], w_to[keep]
        if len(us) == 0:
            continue
        gains = w_to - resolution * g.node_w[i] * sub_w[us]
        ok = gains >= 0
        if not ok.any():
            continue
        gains, us = gains[ok], us[ok]
        if beta > 0:
            # Stable softmax: gains/beta easily exceeds exp()'s range for
            # the default beta=0.01; shifting by the max is exact.
            z = gains / max(beta, 1e-9)
            probs = np.exp(z - z.max())
            probs /= probs.sum()
            pick = int(rng.choice(len(us), p=probs))
        else:
            pick = int(np.argmax(gains))
        target = int(us[pick])
        sub_w[target] += g.node_w[i]
        sub_w[sub[i]] -= g.node_w[i]
        sub[i] = target
    return sub


def leiden(n: int, edges: np.ndarray, weights: np.ndarray,
           resolution: float = 0.7, beta: float = 0.01,
           iterations: int = 2, seed: int = 0) -> List[int]:
    """Cluster a weighted undirected graph; returns a label per node."""
    if n == 0:
        return []
    rng = np.random.default_rng(seed)
    mapping = np.arange(n)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    ww = np.asarray(weights, dtype=np.float64)
    # Self loops never change CPM move gains; drop them from the move graph.
    keep = edges[:, 0] != edges[:, 1]
    src = np.concatenate([edges[keep, 0], edges[keep, 1]])
    dst = np.concatenate([edges[keep, 1], edges[keep, 0]])
    w = np.concatenate([ww[keep], ww[keep]])
    cur_n = n
    node_w = np.ones(cur_n)

    for _ in range(max(1, iterations)):
        if len(w) == 0:
            break
        g = _Graph(cur_n, src, dst, w, node_w)
        comm = np.arange(cur_n)
        while _local_move(g, comm, resolution):
            pass
        sub = _refine(g, comm, resolution, beta, rng)
        uniq, sub_ids = np.unique(sub, return_inverse=True)
        new_n = len(uniq)
        # Aggregate edges between refined subcommunities.
        sa, sb = sub_ids[src], sub_ids[dst]
        off = sa * new_n + sb
        uo, inv = np.unique(off, return_inverse=True)
        w_agg = np.bincount(inv, weights=w)
        src2 = (uo // new_n).astype(np.int64)
        dst2 = (uo % new_n).astype(np.int64)
        keep = src2 != dst2
        new_node_w = np.bincount(sub_ids, weights=node_w, minlength=new_n)
        mapping = sub_ids[mapping]
        src, dst, w = src2[keep], dst2[keep], w_agg[keep]
        if new_n == cur_n:
            cur_n = new_n
            node_w = new_node_w
            break
        cur_n = new_n
        node_w = new_node_w
    return [int(x) for x in mapping]
