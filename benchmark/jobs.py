"""Job streams of the align benchmark: families of related genomes, and
every pair inside a family as the candidates, made from a seed.

A cell's traffic file (traffic/<name>.json) fixes the plan of a job: the
number of families, their sizes (quantiles of a power law), their genome
lengths (quantiles of a log-normal), paired by a fixed layout, and, where
it gives `kept_share`, the share of its family's length each member keeps
(else every member keeps the whole length). So every job of a cell, on
every seed, holds the same multiset of (family size, genome length) and
the same candidate pairs. The configuration (configs/<name>.json) fixes
how the genomes of a family descend from its base: the levels of the
tree, each level's divergences (spread evenly over its nodes), its short
indels and its gene-sized replacements. The seed draws only the sequences
and the positions of the mutations and cuts.

Family bases are spliced from segments of four phage genomes
(data/phage_pool.fna.gz, both strands) and then scrambled by
substitutions, so that their composition is near a phage's while distinct
families, and the segments of one base, share no seeds to speak of.

Genomes come in the order the align stage passes them (longest first) and
pairs (i, j) with i < j, as int8 codes 0-3 (no N).
"""

import gzip
import math
import pathlib
import statistics

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
_CODE = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate(b'ACGT'):
    _CODE[_b] = _CODE[_b + 32] = _i


def load_pool(path=HERE / 'data' / 'phage_pool.fna.gz') -> np.ndarray:
    """The pool's genomes and their reverse complements, concatenated, as
    codes 0-3 (anything else dropped)."""
    seqs, cur = [], []
    with gzip.open(path, 'rb') as fh:
        for line in fh:
            if line.startswith(b'>'):
                if cur:
                    seqs.append(b''.join(cur))
                cur = []
            else:
                cur.append(line.strip())
    if cur:
        seqs.append(b''.join(cur))
    fwd = [_CODE[np.frombuffer(s, dtype=np.uint8)] for s in seqs]
    fwd = [c[c < 4] for c in fwd]
    rc = [(3 - c)[::-1] for c in fwd]
    return np.ascontiguousarray(np.concatenate(fwd + rc))


def family_sizes(spec: dict, n: int) -> np.ndarray:
    """n family sizes: the quantiles (k + 1/2) / n of a discrete power law
    P(f) ~ f^-exponent on [min, max]."""
    f = np.arange(spec['min'], spec['max'] + 1)
    p = f.astype(np.float64) ** -spec['exponent']
    cdf = np.cumsum(p / p.sum())
    q = (np.arange(n) + 0.5) / n
    return f[np.minimum(np.searchsorted(cdf, q), len(f) - 1)]


def genome_lengths(spec: dict, n: int) -> np.ndarray:
    """n lengths: the quantiles (k + 1/2) / n of a log-normal (median,
    sigma of its log), clipped to [min, max] where the spec gives them."""
    nd = statistics.NormalDist()
    q = (np.arange(n) + 0.5) / n
    x = spec['median'] * np.exp(spec['sigma'] * np.array(
        [nd.inv_cdf(float(v)) for v in q]))
    x = np.round(x)
    if 'min' in spec or 'max' in spec:
        x = np.clip(x, spec.get('min'), spec.get('max'))
    return x.astype(np.int64)


def plan(traffic: dict) -> list:
    """[(family size, genome length), ...] of one job, largest family
    first: the same for every job and seed of a cell. The k-th largest
    family takes the length at quantile frac(1/2 + k * golden ratio) of the
    length law, so that the lengths of the large families, which hold
    most pairs, spread over the law as the families' own lengths do."""
    n = traffic['families']
    sizes = np.sort(family_sizes(traffic['family_size'], n))[::-1]
    u = (0.5 + np.arange(n) * (math.sqrt(5) - 1) / 2) % 1.0
    lengths = np.sort(genome_lengths(traffic['length'], n))
    at = np.minimum((u * n).astype(np.int64), n - 1)
    return [(int(s), int(lengths[a])) for s, a in zip(sizes, at)]


def spread(lo_hi, n: int) -> np.ndarray:
    """n divergences spread evenly over [lo, hi] (the midpoints of n equal
    parts)."""
    lo, hi = lo_hi
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


class Maker:
    """Sequences from one seed's generator and the pool."""

    def __init__(self, rng: np.random.Generator, pool: np.ndarray,
                 config: dict):
        self.rng, self.pool = rng, pool
        self.base = config['base']

    def substitute(self, seq: np.ndarray, n: int) -> None:
        """n substitutions in place, each to another base."""
        if n:
            pos = self.rng.integers(0, len(seq), n)
            seq[pos] = (seq[pos] + self.rng.integers(1, 4, n)) % 4

    def fresh(self, L: int) -> np.ndarray:
        """L bases spliced from pool segments, then scrambled."""
        lo, hi = self.base['segment']
        n = -(-L // lo) + 1
        lens = self.rng.integers(lo, hi + 1, n)
        starts = self.rng.integers(0, len(self.pool) - hi, n)
        out = np.concatenate([self.pool[s:s + m]
                              for s, m in zip(starts, lens)])[:L].copy()
        self.substitute(out, int(round(self.base['scramble'] * L)))
        return out

    def descend(self, seq: np.ndarray, level: dict, d: float) -> np.ndarray:
        """A copy of seq at divergence d by the level's rules: substitutions
        and short indels, a share `indel_share` of the events indels (half
        deletions, half insertions of the same lengths), and
        round(gene_events_per_100kb * L / 100 kb) gene-sized replacements (a deletion and an insertion of fresh bases
        of one length elsewhere). The length stays len(seq): the end is cut
        or filled with random bases where the indels do not balance."""
        L = len(seq)
        rng = self.rng
        out = seq.copy()
        share = level.get('indel_share', 0.0)
        self.substitute(out, int(round(d * (1 - share) * L)))
        ilo, ihi = level.get('indel_len', (1, 1))
        n_ind = int(round(d * share * L / ((ilo + ihi) / 2))) // 2
        lens = rng.integers(ilo, ihi + 1, n_ind)
        dels = list(zip(rng.integers(0, L, n_ind).tolist(), lens.tolist()))
        bases = rng.integers(0, 4, int(lens.sum())).astype(np.int8)
        ins = list(zip(rng.integers(0, L, n_ind).tolist(),
                       np.split(bases, np.cumsum(lens)[:-1])
                       if n_ind else []))
        glo, ghi = level.get('gene_len', (0, 0))
        for _ in range(int(round(level.get('gene_events_per_100kb', 0)
                                 * L / 1e5))):
            m = int(rng.integers(glo, ghi + 1))
            dels.append((int(rng.integers(0, L)), m))
            ins.append((int(rng.integers(0, L)), self.fresh(m)))
        out = apply_indels(out, dels, ins)
        if len(out) >= L:
            return np.ascontiguousarray(out[:L])
        return np.concatenate(
            [out, rng.integers(0, 4, L - len(out)).astype(np.int8)])


def apply_indels(seq: np.ndarray, dels: list, ins: list) -> np.ndarray:
    """seq with the ranges [p, p + m) of `dels` (p, m) removed and each
    insertion (p, bases) placed before position p of seq."""
    L = len(seq)
    cut = []                              # merged deleted ranges
    for a, b in sorted((p, min(p + m, L)) for p, m in dels):
        if cut and a <= cut[-1][1]:
            cut[-1][1] = max(cut[-1][1], b)
        else:
            cut.append([a, b])
    points = sorted({0, L, *(p for p, _ in ins), *(x for c in cut
                                                   for x in c)})
    at = {}
    for p, b in ins:
        at.setdefault(p, []).append(b)
    pieces, k = [], 0
    for x, y in zip(points[:-1], points[1:]):
        pieces += at.get(x, [])
        while k < len(cut) and cut[k][1] <= x:
            k += 1
        if not (k < len(cut) and cut[k][0] <= x):
            pieces.append(seq[x:y])
    pieces += at.get(L, [])
    return np.concatenate(pieces)


def kept_shares(lo_hi, n: int) -> np.ndarray:
    """The shares of its length that each of n genomes keeps: spread evenly
    over [lo, hi], dealt in the order frac(1/2 + k * golden ratio), so that
    a genome's share does not follow its divergence."""
    at = (((0.5 + np.arange(n) * (math.sqrt(5) - 1) / 2) % 1.0) * n)
    return spread(lo_hi, n)[np.minimum(at.astype(np.int64), n - 1)]


def member_lengths(L: int, level: dict, n: int) -> np.ndarray:
    """The lengths of the n genomes a level makes from a node of L bases:
    round(L * share) by `kept_share`, or L where the level keeps all."""
    if 'kept_share' not in level:
        return np.full(n, L, dtype=np.int64)
    return np.round(L * kept_shares(level['kept_share'], n)).astype(np.int64)


def job_levels(config: dict, traffic: dict) -> list:
    """The configuration's levels, the last (one node a genome) with the
    traffic's `kept_share` where it gives one."""
    out = [dict(level) for level in config['levels']]
    if 'kept_share' in traffic:
        out[-1]['kept_share'] = traffic['kept_share']
    return out


def make_family(mk: Maker, size: int, L: int, levels: list) -> list:
    """The `size` genomes of one family of length L: a fresh base, then each
    level's nodes descend from the level above (a level with `split`
    'sqrt' has ceil(sqrt(size)) nodes, spread over the nodes above in
    turn; the last level has one node a genome). A level with `kept_share`
    then cuts from each of its nodes one stretch, at a place drawn from
    the seed, so that the node keeps its share of the length
    (member_lengths): genomes of one family differ in gene content, so a
    pair's coverage falls as low as the lower share."""
    nodes = [mk.fresh(L)]
    for li, level in enumerate(levels):
        last = li == len(levels) - 1
        n = size if last else max(1, math.ceil(math.sqrt(size)))
        ds = spread(level['divergence'], n)
        nodes = [mk.descend(nodes[k % len(nodes)], level, float(ds[k]))
                 for k in range(n)]
        if 'kept_share' in level:
            keep = member_lengths(L, level, n)
            cut = [len(x) - int(m) for x, m in zip(nodes, keep)]
            at = mk.rng.integers(0, np.array([len(x) - c + 1 for x, c in
                                              zip(nodes, cut)]))
            nodes = [np.concatenate([x[:a], x[a + c:]])
                     for x, a, c in zip(nodes, at.tolist(), cut)]
    return nodes


class Job:
    """One align call's inputs: codes_list (int8 arrays, longest first),
    pairs (P, 2) int32 with i < j, and each genome's family."""

    def __init__(self, codes_list, pairs, family):
        self.codes_list = codes_list
        self.pairs = pairs
        self.family = family
        self.lens = np.array([len(c) for c in codes_list], dtype=np.int64)


def make_job(config: dict, traffic: dict, rng: np.random.Generator,
             pool: np.ndarray, families=None) -> Job:
    """One job of the cell (see the module docstring), of the plan's
    families or of `families`, a list of (size, length) of its own."""
    mk = Maker(rng, pool, config)
    genomes, fam = [], []
    for f, (size, L) in enumerate(plan(traffic) if families is None
                                  else families):
        genomes += make_family(mk, size, L, job_levels(config, traffic))
        fam += [f] * size
    fam = np.array(fam)
    lens = np.array([len(g) for g in genomes])
    order = np.argsort(-lens, kind='stable')
    pos = np.empty_like(order)
    pos[order] = np.arange(len(order))
    fam_sorted = fam[order]
    pairs = []
    for f in range(len(set(fam.tolist()))):
        members = np.sort(pos[fam == f])
        i, j = np.triu_indices(len(members), 1)
        pairs.append(np.stack([members[i], members[j]], axis=1))
    pairs = np.concatenate(pairs).astype(np.int32)
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    return Job([genomes[k] for k in order], pairs, fam_sorted)


def make_jobs(config: dict, traffic: dict, seed: int, pool=None) -> list:
    """The cell's `traffic['jobs']` distinct jobs for `seed` (any whole
    number; it seeds numpy's generator as is)."""
    pool = load_pool() if pool is None else pool
    rng = np.random.default_rng(int(seed))
    return [make_job(config, traffic, rng, pool)
            for _ in range(traffic['jobs'])]


def family_buckets(config: dict, traffic: dict, size: int, L: int) -> set:
    """The buckets of the pairs of a family of `size` genomes from a base of
    L bases (a pair's bucket is its longer genome's)."""
    lens = member_lengths(L, job_levels(config, traffic)[-1], size)
    return {pad_bucket(int(x)) for x in np.sort(lens)[1:]}


# The members' shares of their base's length in the warm-up job of a cell
# whose members keep the whole length (see make_warmup).
WARMUP_KEPT_SHARE = (0.85, 1.0)


def make_warmup(config: dict, traffic: dict, seed: int, pool=None) -> Job:
    """The job that warms up a cell's shapes before its window: for each
    bucket the cell's pairs reach, the plan's smallest family with pairs
    there, made from a stream of the seed that the cell's jobs do not use.
    Its members keep the traffic's `kept_share`, or WARMUP_KEPT_SHARE where
    the traffic keeps them whole, so that its pairs run both pipes at each
    bucket (the hybrid re-runs pairs of unequal lengths on v2, as it does
    the cell's pairs that v3 leaves hard; v2 alone above 131,072)."""
    pool = load_pool() if pool is None else pool
    fams = sorted(set(plan(traffic)))
    want = set().union(*(family_buckets(config, traffic, s, L)
                         for s, L in fams))
    warm = dict(traffic, kept_share=traffic.get('kept_share',
                                                WARMUP_KEPT_SHARE))
    chosen = []
    for kb in sorted(want):
        if any(kb in family_buckets(config, warm, s, L) for s, L in chosen):
            continue
        has = [f for f in fams if kb in family_buckets(config, warm, *f)]
        chosen.append(min(has or [f for f in fams if kb in family_buckets(
            config, traffic, *f)], key=lambda f: (f[0], f[1])))
    rng = np.random.default_rng([int(seed), 2])
    return make_job(config, warm, rng, pool, families=chosen)


def job_stats(config: dict, traffic: dict) -> dict:
    """What the plan gives a job, from the files alone: genomes, pairs,
    pairs a genome, the pairs at each bucket of the align engine, and the
    pairs whose two lengths differ by more than 0.3% (the hybrid's
    coverage rule, 0.997, then aligns them again on v2 whatever their
    bases)."""
    p = plan(traffic)
    n = sum(s for s, _ in p)
    by_bucket, unequal = {}, 0
    for s, L in p:
        lens = member_lengths(L, job_levels(config, traffic)[-1], s)
        i, j = np.triu_indices(s, 1)
        lo, hi = np.minimum(lens[i], lens[j]), np.maximum(lens[i], lens[j])
        unequal += int((lo < 0.997 * hi).sum())
        for kb in (pad_bucket(int(x)) for x in hi):
            by_bucket[kb] = by_bucket.get(kb, 0) + 1
    pairs = sum(by_bucket.values())
    return dict(genomes=n, pairs=pairs, pairs_per_genome=pairs / n,
                families=len(p), unequal_pairs=unequal,
                pairs_by_bucket=dict(sorted(by_bucket.items())))


# The align engine's length buckets (a frozen copy, for the plan's
# statistics and the checks' sampling).
BUCKETS = sorted({4096 << i for i in range(8)} | {6144 << i for i in range(8)})


def pad_bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return -(-n // 131072) * 131072
