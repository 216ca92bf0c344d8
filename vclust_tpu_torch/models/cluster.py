"""Cluster stage: graph clustering of the sparse ANI similarity matrix.

Replaces clusty (reference contract vclust.py:1184-1278; SURVEY.md section
2.6). Input: an ani.tsv-like table (directed rows qidx/ridx + measure
columns) and the objects (ids) table; output: per-object cluster labels in
objects order.

Semantics pinned by the reference:
- edge pre-filters: --min on any column (and --max for num_alns); the
  clustering threshold itself arrives as a min-filter on the metric column
  (reference vclust.py:1260-1266);
- objects file is sorted by length descending, so "longest-first" greedy
  algorithms process objects in index order;
- cluster ids (golden example/output/clusters.tsv): multi-member clusters
  are numbered first, in order of their smallest member index, then
  singletons in objects order;
- --out-representatives: label = name of the longest member (= smallest
  index, since objects are length-sorted).

Six algorithms: single, complete, uclust, cd-hit, set-cover, leiden.
For very large graphs (n >= 50,000) the single-linkage path runs on the
device via ops/cc.py (iterative min-label propagation, the same labels as
the host union-find, which serves smaller graphs). A failure there is
raised, never answered on the host instead.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.device import resolve_device

ALGORITHMS = ('single', 'complete', 'uclust', 'cd-hit', 'set-cover', 'leiden')

# Columns where the pre-filter is a maximum (reference vclust.py:529-537).
MAX_FILTER_COLUMNS = ('num_alns',)

# Single linkage runs on the device from this many objects up.
_DEVICE_SINGLE_MIN_NODES = 50_000


@dataclass
class ClusterParams:
    algorithm: str = 'single'
    metric: str = 'tani'
    metric_threshold: float = 0.0
    min_filters: Dict[str, float] = field(default_factory=dict)
    max_filters: Dict[str, float] = field(default_factory=dict)
    out_representatives: bool = False
    leiden_resolution: float = 0.7
    leiden_beta: float = 0.01
    leiden_iterations: int = 2


def build_edges(header: Sequence[str], rows, params: ClusterParams,
                n_objects: int):
    """Filter directed rows -> symmetric edge list with metric weights.

    Returns (edges, weights): unique undirected pairs (i, j) with i < j and
    the maximum passing metric value over the two directed rows.
    """
    col = {name: k for k, name in enumerate(header)}
    qi, ri = col['qidx'], col['ridx']
    mi = col[params.metric]
    checks = []
    for name, v in params.min_filters.items():
        if v:
            checks.append((col[name], v, True))
    for name, v in params.max_filters.items():
        if v:
            checks.append((col[name], v, False))
    best: Dict[Tuple[int, int], float] = {}
    for row in rows:
        value = float(row[mi])
        if value < params.metric_threshold:
            continue
        ok = True
        for k, v, is_min in checks:
            x = float(row[k])
            if (x < v) if is_min else (x > v):
                ok = False
                break
        if not ok:
            continue
        a, b = int(row[qi]), int(row[ri])
        if a == b or a >= n_objects or b >= n_objects:
            continue
        key = (a, b) if a < b else (b, a)
        prev = best.get(key)
        if prev is None or value > prev:
            best[key] = value
    if not best:
        return (np.empty((0, 2), dtype=np.int64),
                np.empty(0, dtype=np.float64))
    pairs = np.array(sorted(best), dtype=np.int64)
    weights = np.array([best[tuple(p)] for p in pairs], dtype=np.float64)
    return pairs, weights


class _CSR:
    """Symmetric CSR adjacency (neighbor lists sorted ascending)."""

    def __init__(self, n: int, edges: np.ndarray, weights: np.ndarray):
        self.n = n
        if len(edges) == 0:
            self.indptr = np.zeros(n + 1, dtype=np.int64)
            self.dst = np.empty(0, dtype=np.int64)
            self.w = np.empty(0, dtype=np.float64)
            return
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        w = np.concatenate([weights, weights])
        order = np.lexsort((dst, src))
        src, self.dst, self.w = src[order], dst[order], w[order]
        counts = np.bincount(src, minlength=n)
        self.indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=self.indptr[1:])

    def row(self, i: int):
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.dst[lo:hi], self.w[lo:hi]


# ---------------------------------------------------------------------------
# Algorithms: each returns a raw member->group mapping (any int labels).
# ---------------------------------------------------------------------------

def _single(n, edges, weights, adj, params, device):
    # Large graphs: device union-find (K11; identical labels: each
    # component's least member index, as the union-find below gives).
    if n >= _DEVICE_SINGLE_MIN_NODES and len(edges):
        from ..ops.cc import connected_components_device
        return connected_components_device(n, edges, device=device).tolist()
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            if ra < rb:
                parent[rb] = ra
            else:
                parent[ra] = rb
    return [find(i) for i in range(n)]


def _complete(n, edges, weights, adj, params, device):
    # Greedy longest-first: an object joins the first existing cluster
    # (creation order) it is connected to every member of; otherwise it
    # founds a new one. Per-object cost O(deg log deg): count neighbor
    # labels among already-placed neighbors and compare against cluster
    # sizes — no pairwise membership rescans.
    labels = np.full(n, -1, dtype=np.int64)
    csize = np.zeros(n, dtype=np.int64)
    n_clusters = 0
    for i in range(n):
        nb, _ = adj.row(i)
        nb = nb[nb < i]
        placed = -1
        if len(nb):
            lc, cnt = np.unique(labels[nb], return_counts=True)
            full = lc[cnt == csize[lc]]
            if len(full):
                placed = int(full[0])   # smallest id = creation order
        if placed < 0:
            placed = n_clusters
            n_clusters += 1
        labels[i] = placed
        csize[placed] += 1
    return labels.tolist()


def _uclust(n, edges, weights, adj, params, device):
    # Longest-first greedy: assign to the best-scoring centroid (ties ->
    # earliest-founded = smallest index), else found a new centroid.
    is_centroid = np.zeros(n, dtype=bool)
    labels = np.zeros(n, dtype=np.int64)
    for i in range(n):
        nb, w = adj.row(i)
        sel = is_centroid[nb] & (nb < i)
        if sel.any():
            wc, nc = w[sel], nb[sel]
            best = wc.max()
            labels[i] = nc[wc == best][0]
        else:
            labels[i] = i
            is_centroid[i] = True
    return labels.tolist()


def _cdhit(n, edges, weights, adj, params, device):
    # Longest-first greedy: assign to the earliest-founded centroid
    # neighbor (= smallest index, neighbor lists are sorted).
    is_centroid = np.zeros(n, dtype=bool)
    labels = np.zeros(n, dtype=np.int64)
    for i in range(n):
        nb, _ = adj.row(i)
        sel = is_centroid[nb] & (nb < i)
        if sel.any():
            labels[i] = nb[sel][0]
        else:
            labels[i] = i
            is_centroid[i] = True
    return labels.tolist()


def _set_cover(n, edges, weights, adj, params, device):
    # MMseqs2-style: repeatedly pick the node covering the most uncovered
    # neighbors (ties -> smallest index); it founds a cluster of itself
    # plus its uncovered neighbors. Lazy max-heap: gains only decrease, so
    # a popped entry matching its recomputed gain is globally maximal —
    # O(E log V) instead of rescanning all uncovered nodes per pick.
    import heapq
    labels = np.full(n, -1, dtype=np.int64)
    covered = np.zeros(n, dtype=bool)
    degs = np.diff(adj.indptr)
    heap = [(-int(degs[i]), i) for i in range(n)]
    heapq.heapify(heap)
    n_covered = 0
    while n_covered < n:
        neg_gain, i = heapq.heappop(heap)
        if covered[i]:
            continue   # only uncovered nodes found clusters
        nb, _ = adj.row(i)
        gain = int(np.count_nonzero(~covered[nb]))
        if -neg_gain != gain:
            heapq.heappush(heap, (-gain, i))
            continue
        members = nb[~covered[nb]]
        labels[i] = i
        labels[members] = i
        covered[i] = True
        covered[members] = True
        n_covered += 1 + len(members)
    return labels.tolist()


def _leiden(n, edges, weights, adj, params, device):
    from ..ops.leiden import leiden
    return leiden(n, edges, weights,
                  resolution=params.leiden_resolution,
                  beta=params.leiden_beta,
                  iterations=params.leiden_iterations)


_ALGOS = {
    'single': _single,
    'complete': _complete,
    'uclust': _uclust,
    'cd-hit': _cdhit,
    'set-cover': _set_cover,
    'leiden': _leiden,
}


def _renumber(raw: List[int]) -> List[int]:
    """Apply the reference's id scheme: multi-member clusters first (ordered
    by smallest member index), then singletons in objects order."""
    groups: Dict[int, List[int]] = {}
    for i, g in enumerate(raw):
        groups.setdefault(g, []).append(i)
    multi = sorted((min(m) for m in groups.values() if len(m) > 1))
    singles = sorted(min(m) for m in groups.values() if len(m) == 1)
    order = {}
    next_id = 0
    for first in multi:
        order[raw[first]] = next_id
        next_id += 1
    for first in singles:
        order[raw[first]] = next_id
        next_id += 1
    return [order[g] for g in raw]


def run_cluster(
    header: Sequence[str],
    rows,
    objects: Sequence[Tuple[str, int, int]],
    params: ClusterParams,
    device=None,
):
    """Cluster objects; returns labels column for clusters.tsv (ints, or
    representative names with out_representatives). Device work runs on
    `device` (default cuda, see utils/device)."""
    device = resolve_device(device)
    n = len(objects)
    edges, weights = build_edges(header, rows, params, n)
    adj = _CSR(n, edges, weights)
    raw = _ALGOS[params.algorithm](n, edges, weights, adj, params, device)
    ids = _renumber(raw)
    if not params.out_representatives:
        return ids
    groups: Dict[int, int] = {}
    for i, g in enumerate(ids):
        if g not in groups:
            groups[g] = i   # smallest index = longest member
    return [objects[groups[g]][0] for g in ids]
