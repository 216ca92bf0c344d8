"""A model, in numpy, of K11 (csrc/cc.cu), held against the host
union-find's labels on the CPU. No JAX.

K11 is union-find on the edge list. `cc_init` sets parent[v] = v. In
`cc_hook` a warp takes a block of 32 edges, a lane one of them: the lane
finds the roots of both ends (halving the paths with plain stores where
the hook runs once over every edge). Where two neighbouring lanes owe a
union under one larger root `hi`, the lanes whose hi is the same elect
the lane with the least smaller root `lo_min`, which alone CASes
parent[hi] from hi to lo_min; on success every other lane of the group
still owes (its lo, lo_min), on failure each lane goes on from (what the
CAS saw, its lo). Then each lane CASes its own pair's larger root under
the smaller until its pair is united. With E >= 2n the hook first takes
every s-th block (s = E // n, the sample), `cc_compress` points every
node at its root, and the hook takes the other blocks, each lane first
replacing both ends of its edge by their parents: ends that read one
parent owe nothing. `cc_flatten` sets parent[v] to v's root, walked
without stores.

The model runs each launch's warps (the hook) or threads (compress,
flatten) as programs in batches: each batch's programs read the state,
then their stores and CASes land in a random order, and a CAS's outcome
reaches its warp in a later batch. Loads go through L1, which other SMs'
stores do not update but which starts each launch empty, so each read
returns any value the location has held since the launch began (a stale
line), not only the newest; the CAS reads the newest. The compress and
the flatten rely on that launch boundary: a read of a node's own id from
an older line would store parent[v] = v and cut v's subtree off (the
`stale_roots` mutation, which must fail). After every batch parent[x] <=
x must hold, and no find or union may take more than n turns (the
kernel's caps). The labels must
be each component's least member index, whatever the order, on the
graphs as given and in the order `cluster` passes them (unique pairs
i < j, sorted).
"""

import sys

import numpy as np
import pytest

sys.path.insert(0, 'tests')

from cc_cases import build_edges_order, model_graphs, star, union_find  # noqa

GRAPHS = model_graphs()
ALL, SAMPLE, REST = 0, 1, 2


class Memory:
    """`parent` and every value each location has held."""

    def __init__(self, n, rng):
        self.parent = np.arange(n)
        self.history = [[x] for x in range(n)]
        self.launch = [0] * n      # a location's first value this launch
        self.rng = rng
        self.cas_on = {}           # CASes sent to each word
        self.skipped = self.tested = 0  # the skip's edges: skipped, tested

    def read(self, x, since_launch=True):
        """An L1 load: any value x has held since this launch began (L1
        starts each launch empty), or ever."""
        h = self.history[x]
        lo = self.launch[x] if since_launch else 0
        return h[int(self.rng.integers(lo, len(h)))]

    def store(self, x, v):
        self.parent[x] = v
        self.history[x].append(v)

    def new_launch(self):
        self.launch = [len(h) - 1 for h in self.history]


def run_launch(mem, programs, max_batch):
    """Each program a generator that yields a list of events, ('store', x,
    v) or ('cas', x, expect, new), and is sent back each CAS's seen value.
    Batches of programs read, then their events land in a random order."""
    rng, n = mem.rng, len(mem.parent)
    live = [[g, None] for g in programs]
    while live:
        k = int(rng.integers(1, max_batch + 1))
        pick = rng.permutation(len(live))[:k]
        events, done = [], set()
        for i in pick:
            g, sent = live[i]
            try:
                events += [(i, j, ev) for j, ev in enumerate(g.send(sent))]
            except StopIteration:
                done.add(i)
        results = {i: {} for i in pick}
        for m in rng.permutation(len(events)):
            i, j, ev = events[m]
            if ev[0] == 'store':
                mem.store(ev[1], ev[2])
                continue
            _, x, expect, new = ev
            mem.cas_on[x] = mem.cas_on.get(x, 0) + 1
            seen = int(mem.parent[x])          # the CAS reads L2
            if seen == expect:
                mem.store(x, new)
            results[i][j] = seen
        for i in pick:
            live[i][1] = [results[i][j] for j in sorted(results[i])]
        live = [t for i, t in enumerate(live) if i not in done]
        assert (mem.parent <= np.arange(n)).all()


def find(mem, x, halve):
    """find_roots for one chain on stale reads: (root, its halving
    stores)."""
    stores, n = [], len(mem.parent)
    for _ in range(n + 1):
        p = mem.read(x)
        if p == x:
            return x, stores
        gp = mem.read(p)
        if halve and gp != p:
            stores.append(('store', x, gp))
        x = gp
    raise AssertionError('a find passed the cap')


def hook_block(mem, edges, b, phase, lanes, mutation):
    """One warp's block b: an edge a lane, the skip (REST), the finds, the
    election where neighbouring lanes share a larger root, then each
    lane's own CASes in turns."""
    n, E = len(mem.parent), len(edges)
    halve = phase == ALL
    r = np.zeros((lanes, 2), np.int64)          # equal ends owe nothing
    for lane in range(min(lanes, E - b * lanes)):
        r[lane] = edges[b * lanes + lane]
    if phase == REST:
        for lane in range(lanes):
            ends = r[lane, [0, 0]] if mutation == 'skip_one_end' else r[lane]
            r[lane] = [mem.read(v) for v in ends]
        live = b * lanes + np.arange(lanes) < E
        mem.tested += int(live.sum())
        mem.skipped += int((live & (r[:, 0] == r[:, 1])).sum())
    stores = []

    def refind(lane):
        if r[lane, 0] != r[lane, 1]:
            for c in (0, 1):
                r[lane, c], st = find(mem, r[lane, c], halve)
                stores.extend(st)

    for lane in range(lanes):
        refind(lane)
    owe = r[:, 0] != r[:, 1]
    lo, hi = r.min(axis=1), r.max(axis=1)
    if mutation != 'no_election' and (owe[1:] & owe[:-1]
                                      & (hi[1:] == hi[:-1])).any():
        groups = {}
        for lane in np.flatnonzero(owe):
            groups.setdefault(int(hi[lane]), []).append(lane)
        cas = [('cas', h, h, int(lo[m].min())) for h, m in groups.items()]
        seen = yield stores + cas
        stores = []
        for (h, members), s, c in zip(groups.items(), seen, cas):
            for lane in members:
                if s == h:        # h hangs under lo_min: (lo, lo_min) owed
                    r[lane] = (lo[lane], lo[lane] if
                               mutation == 'drop_owed' else c[3])
                else:             # h fell under s < h meanwhile
                    r[lane] = (s, lo[lane])
                refind(lane)
    for turn in range(n + 2):
        owe = np.flatnonzero(r[:, 0] != r[:, 1])
        if not len(owe):
            break
        assert turn <= n, 'a lane passed the retry cap'
        lo, hi = r.min(axis=1), r.max(axis=1)
        seen = yield stores + [('cas', int(hi[m]), int(hi[m]), int(lo[m]))
                               for m in owe]
        stores = []
        for m, s in zip(owe, seen):
            if s != hi[m]:        # hi fell under s < hi meanwhile
                r[m] = (s, lo[m])
                refind(m)
            else:
                r[m] = (lo[m], lo[m])
    else:
        raise AssertionError('a warp passed the retry cap')
    if stores:
        yield stores


def point_at_root(mem, v, since_launch):
    """walk_root, read only, then the thread's one store."""
    n, x = len(mem.parent), v
    for _ in range(n + 1):
        p = mem.read(x, since_launch)
        if p == x:
            break
        x = p
    else:
        raise AssertionError('a walk passed the cap')
    yield [('store', v, x)]


def rest_blocks(blocks, s):
    """The kernel's block_of<REST>: the k-th block that is not every s-th."""
    count = blocks - -(-blocks // s)
    return [k // (s - 1) * s + k % (s - 1) + 1 for k in range(count)]


def k11_model(n, edges, rng, max_batch, lanes=32, stride=None,
              mutation=None):
    """K11's labels on `edges` under one random schedule. `stride` forces
    the sample's stride (the kernel takes E // n); `mutation` breaks one
    part on purpose."""
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    mem, E = Memory(n, rng), len(edges)
    blocks = -(-E // lanes)
    s = E // n if stride is None else stride

    def hook(phase, bs):
        mem.new_launch()
        run_launch(mem, [hook_block(mem, edges, b, phase, lanes, mutation)
                         for b in bs], max_batch)

    if s >= 2:
        hook(SAMPLE, range(0, blocks, s))
        rest = rest_blocks(blocks, s)
        if rest:
            mem.new_launch()
            run_launch(mem, [point_at_root(mem, v, mutation != 'stale_roots')
                             for v in range(n)], max_batch)
            hook(REST, rest)
    elif E:
        hook(ALL, range(blocks))
    def root(x):
        while mem.parent[x] != x:
            x = mem.parent[x]
        return x

    for a, b in edges:
        assert root(a) == root(b) or mutation
    mem.new_launch()
    run_launch(mem, [point_at_root(mem, v, mutation != 'stale_roots')
                     for v in range(n)], max_batch)
    return mem.parent, mem


@pytest.mark.parametrize('name,n,edges', GRAPHS,
                         ids=[g[0] for g in GRAPHS])
@pytest.mark.parametrize('max_batch', [1, 16, 256])
def test_k11_model_matches_union_find(name, n, edges, max_batch):
    """The kernel's own shape (32 lanes, s = E // n) on the graph as given
    and in `cluster`'s order."""
    want = union_find(n, edges)
    for order, e in (('given', edges), ('build_edges', build_edges_order(
            edges))):
        for seed in range(3):
            got, _ = k11_model(n, e, np.random.default_rng(seed), max_batch)
            assert np.array_equal(got, want), (name, order, seed)


@pytest.mark.parametrize('order', ['given', 'build_edges'])
@pytest.mark.parametrize('name,n,edges', GRAPHS,
                         ids=[g[0] for g in GRAPHS])
def test_k11_model_sampled_matches_union_find(name, n, edges, order):
    """Warps of 4 lanes and a sample of every 3rd block, so that every
    graph of more than two blocks goes through the sample, the compress
    and the skip."""
    e = build_edges_order(edges) if order == 'build_edges' else edges
    want = union_find(n, edges)
    for seed, max_batch in enumerate((1, 8, 64)):
        got, _ = k11_model(n, e, np.random.default_rng(seed), max_batch,
                           lanes=4, stride=3)
        assert np.array_equal(got, want), (name, seed)


def test_k11_model_retries_under_contention():
    """Every edge of a star races for the same root: CASes fail and retry,
    and the labels still come out right."""
    n, edges = 64, np.stack([np.full(63, 63), np.arange(63)], axis=1)
    got, _ = k11_model(n, edges, np.random.default_rng(0), max_batch=63,
                       lanes=4)
    assert (got == 0).all()


def test_k11_model_one_cas_a_warp_on_a_shared_root():
    """The star in `cluster`'s order, (k, n - 1): the warp's election sends
    the hub about one CAS a warp, not one an edge. (Each lane's read here
    may return its own past value, where a warp's one load on the card
    reads one line, so a warp's lanes can split between two roots.)"""
    n, edges = star(300)
    edges = build_edges_order(edges)
    blocks = -(-len(edges) // 32)
    for seed in range(3):
        got, mem = k11_model(n, edges, np.random.default_rng(seed), 4)
        assert (got == 0).all()
        assert mem.cas_on[n - 1] <= 2 * blocks, mem.cas_on[n - 1]
        _, cut = k11_model(n, edges, np.random.default_rng(seed), 4,
                           mutation='no_election')
        assert cut.cas_on[n - 1] > 4 * blocks


def test_k11_model_skips_inside_the_giant_component():
    """On a random graph with a giant component the sample builds it, and
    most of the other blocks' edges read one parent at both ends."""
    rng = np.random.default_rng(5)
    n = 400
    edges = build_edges_order(rng.integers(0, n, (2400, 2)))
    assert len(edges) // n >= 2
    for seed in range(3):
        got, mem = k11_model(n, edges, np.random.default_rng(seed), 16,
                             lanes=8)
        assert np.array_equal(got, union_find(n, edges))
        assert mem.tested > len(edges) // 2
        assert mem.skipped > mem.tested // 2, (mem.skipped, mem.tested)


@pytest.mark.parametrize('blocks', [1, 2, 3, 7, 64, 1001])
def test_k11_rest_blocks_are_the_others(blocks):
    """block_of<REST> walks every block that block_of<SAMPLE> does not,
    once each, in order."""
    for s in (2, 3, 4, 7):
        want = [b for b in range(blocks) if b % s]
        assert rest_blocks(blocks, s) == want
