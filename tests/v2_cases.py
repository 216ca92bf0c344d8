"""Inputs of the v2 front end's kernels (K6, the seed votes and their
two-scale election; K7, the propagation and flags), made with numpy from a
seed and the port's own v2 index (`_index_block`, torch on the CPU). Used
by tests/test_torch_v2_model.py (numpy models of the kernels against the
plain versions) and tests/test_torch_kernels.py (the kernels against the
plain versions on the card)."""

import numpy as np
import torch

from vclust_tpu_torch.core.seq import revcomp_codes
from vclust_tpu_torch.ops import align_gpu as ag

FINE = 32


def _mutant(rng, s, rate):
    s = s.copy()
    hit = (rng.random(len(s)) < rate) & (s < 4)
    s[hit] = (s[hit] + rng.integers(1, 4, hit.sum())) % 4
    return s


def v2_genomes(seed, n):
    """Eight genomes of about n bases: a reference whose first 12 bases are
    A (the 8-mer value 0 at position 0) with a tandem repeat (values that
    occur 3+ times) and a copy of bases 300-900 near its end (twice); its
    5% mutant with an N run; the reverse complement of a 4% mutant; a
    mosaic of its halves, the first inverted; an unrelated genome; a
    genome of N only; a short piece of the mutant; a 2% mutant whose
    first half is the reference's second."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, n).astype(np.int8)
    ref[:12] = 0
    ref[1000:1400] = np.tile(ref[1000:1010], 40)
    ref[-700:-100] = ref[300:900]
    mut = _mutant(rng, ref, 0.05)
    mut[1500:1600] = 4
    rcm = revcomp_codes(_mutant(rng, ref, 0.04))
    mosaic = np.concatenate([ref[n // 2:], revcomp_codes(ref[:n // 2])])
    other = rng.integers(0, 4, n - 200).astype(np.int8)
    swap = _mutant(rng, np.concatenate([ref[n // 2:], ref[:n // 2]]), 0.02)
    return [ref, mut, rcm, mosaic, other, np.full(n // 2, 4, np.int8),
            mut[:n // 3].copy(), swap]


def v2_arena(codes, Lp, pack_bits, C, device='cpu'):
    """The port's v2 bucket dict of `codes` at bucket Lp (a multiple of 32)
    on `device`, as `GenomeIndex.ensure` builds it, at pack_bits and C
    seeds a block."""
    G = len(codes)
    fwd = np.full((G, Lp), 4, np.int8)
    rc = fwd.copy()
    for r, c in enumerate(codes):
        fwd[r, :len(c)] = c
        rc[r, :len(c)] = revcomp_codes(c)
    fwd_t = torch.from_numpy(fwd).to(device)
    arrs = ag._index_block(fwd_t, torch.from_numpy(rc).to(device),
                           ag.SEED_K, pack_bits, C)
    b = dict(zip(ag._V2_KEYS, arrs))
    b.update(fwd=fwd_t, pack_bits=pack_bits, rows={i: i for i in range(G)})
    return b


def v2_rows(codes, seed, R, K, refs=(0,)):
    """R dispatch rows of K queries over the genomes: r_rows, rlens (R,),
    q_rows, qlens (R, K) int32; the first rows' references are `refs`, the
    others drawn; row 0's queries are the genomes after its reference in
    turn, so every kind of pair occurs."""
    rng = np.random.default_rng(seed)
    G = len(codes)
    lens = np.array([len(c) for c in codes], np.int32)
    r_rows = rng.integers(0, G, R).astype(np.int32)
    q_rows = rng.integers(0, G, (R, K)).astype(np.int32)
    r_rows[:len(refs)] = refs[:R]
    q_rows[0] = (np.arange(K) + r_rows[0] + 1) % G
    return (torch.from_numpy(r_rows), torch.from_numpy(lens[r_rows]),
            torch.from_numpy(q_rows), torch.from_numpy(lens[q_rows]))


def random_election(seed, R, K, NBF, Lr):
    """A K7 election at any block count: 70% of the blocks assigned, most
    at diagonal 0 on the forward strand (the self and mutant pairs of
    `v2_genomes` match there), the rest at random diagonals on either
    strand, some clipped at -32 or past Lr - 1."""
    rng = np.random.default_rng(seed)
    shape = (R, K, NBF)
    A = rng.random(shape) < 0.7
    f = np.arange(NBF)
    D = np.where(rng.random(shape) < 0.6, 0,
                 rng.integers(-FINE, Lr, shape) - FINE * f)
    S = rng.random(shape) < 0.25
    D = np.where(rng.random(shape) < 0.03, -FINE * f - 40, D)
    return (torch.from_numpy(A), torch.from_numpy(S & (D != 0)),
            torch.from_numpy(D.astype(np.int32)))


def votes_case(seed, R, K, NBF, C, Lq, Lr):
    """Votes (R, K, NBF * C, 4) int32 of vote codes below 2 DSPAN + 64
    (DSPAN = Lq + Lr + 64) or BIG: per coarse block a centre on either
    strand drawing most votes of its fine blocks; some fine blocks with a
    centre of their own, some with two clusters of equal size, some empty;
    the rest random. Coarse block 0 of pair 0: fine block 0 holds h votes
    at a smaller centre and h at the coarse one, so its election (ties to
    the smallest start) gives as many votes as its support for the coarse
    mode (use_f false); coarse block 1 of pair 0 holds no vote at all."""
    rng = np.random.default_rng(seed)
    dspan = Lq + Lr + 64
    top = 2 * dspan + 64
    N, NBC, C4 = R * K, NBF // 4, 4 * C
    v = np.full((N, NBF, C4), ag.BIG, np.int64)
    for n in range(N):
        for cb in range(NBC):
            centre = int(rng.integers(0, top - 40))
            for q in range(4):
                f = 4 * cb + q
                kind = rng.choice(['coarse', 'own', 'two', 'empty', 'noise'],
                                  p=[0.5, 0.15, 0.1, 0.1, 0.15])
                m = int(rng.integers(0, C4 + 1))
                if kind == 'coarse':
                    v[n, f, :m] = centre + rng.integers(0, 14, m)
                elif kind == 'own':
                    c2 = int(rng.integers(0, top - 40))
                    v[n, f, :m] = c2 + rng.integers(0, 10, m)
                elif kind == 'two':
                    h = C4 // 2
                    c2 = int(rng.integers(0, top - 40))
                    v[n, f, :h] = centre + rng.integers(0, 3, h)
                    v[n, f, h:2 * h] = c2 + rng.integers(0, 3, h)
                elif kind == 'noise':
                    v[n, f, :m] = rng.integers(0, top, m)
                rng.shuffle(v[n, f])
    if NBC:
        c1 = top // 2
        h = min(2 * C, 32)   # the coarse sample keeps fewer than SMAX + 1
        v[0, :4] = c1 + rng.integers(0, 3, (4, C4))
        v[0, 0] = ag.BIG
        v[0, 0, :h] = c1 - 500
        v[0, 0, h:2 * h] = c1
    if NBC > 1:
        v[0, 4:8] = ag.BIG
    return torch.from_numpy(v.reshape(R, K, NBF * C, 4).astype(np.int32))



def crafted_arena(votes, Lq, Lr, pack_bits, C, seed, reverse):
    """An arena whose seed votes (votes_v2_plain) are crafted ones: R
    reference rows, R * K query rows, r_rows (R,) and q_rows (R, K) of
    pairs r * K + k. votes (R, K, NBF, M) int32: each fine block's M <= 4C
    vote codes (BIG where none), as votes_case makes them. Every vote of
    coarse block cb moves by Lq - 128 cb, and by DSPAN more with
    `reverse`, so a block's votes keep their gaps and ties. Each vote is
    one reference position of a fresh seed value, a seed's two candidates
    on a strand the last two positions of its value there. With `reverse`
    a vote may lie on either strand (a forward one at a position past
    Lr + 64), so a fine block takes 4C votes; without, on the forward
    strand only, 2C. The other slots of a coarse block with a vote hold no
    seed (-1) or a value the reference lacks. Returns the arena, r_rows,
    q_rows and the moved votes (R, K, NBF, 4C), BIG past each block's."""
    rng = np.random.default_rng(seed)
    R, K, NBF, M = votes.shape
    NQ = NBF * C
    dspan = Lq + Lr + 64
    pmax = (1 << (16 if pack_bits == 32 else 20)) - 2   # largest position
    cols = 4 if reverse else 2
    assert M <= cols * C
    v = votes.numpy().astype(np.int64)
    shift = Lq - ag.BLOCK * (np.arange(NBF) // 4) + (dspan if reverse else 0)
    moved = np.full((R, K, NBF, 4 * C), ag.BIG, np.int64)
    moved[..., :M] = np.where(v < ag.BIG, v + shift[:, None], ag.BIG)
    qsv = np.full((R * K, NQ), -1, np.int64)
    qoff = rng.integers(0, FINE, (R * K, NQ))
    values = rng.permutation(0xFFFF)       # the largest value, 0xFFFF, out
    entries = [[[], []] for _ in range(R)]  # (value, position) a strand
    used = [0] * R
    busy = (moved < ag.BIG).reshape(R, K, NBF // 4, -1).any(-1)
    for r, k, cb in zip(*np.nonzero(busy)):
        n = r * K + k
        for f in range(4 * cb, 4 * cb + 4):
            ws = moved[r, k, f][moved[r, k, f] < ag.BIG]
            rng.shuffle(ws)
            order = rng.permutation(C)
            for i, c in enumerate(order):
                mine = ws[cols * i:cols * (i + 1)]
                if not len(mine) and rng.random() < 0.5:
                    continue                  # no seed
                val = int(values[used[r]])
                used[r] += 1
                qsv[n, f * C + c] = val
                qpos = f * FINE + qoff[n, f * C + c]
                for st in (0, 1):
                    d = np.sort(mine[2 * st:2 * st + 2])
                    pos = d - Lq - st * dspan + qpos
                    assert ((pos >= 0) & (pos <= pmax)).all()
                    entries[r][st] += [(val, int(p)) for p in pos]
    NR = max(4, -(-max(len(e) for row in entries for e in row) // 4) * 4)
    b = dict(qsv=torch.from_numpy(qsv.astype(np.int32)),
             qoff=torch.from_numpy(qoff.astype(np.int32)),
             pack_bits=pack_bits)
    for st, tag in enumerate('fr'):
        sv = np.full((R, NR), ag.BIG, np.int64)
        pk1 = np.zeros((R, NR), np.int64)
        pk2 = np.zeros((R, NR), np.int64)
        for r in range(R):
            e = sorted(entries[r][st])
            for i, (val, p) in enumerate(e):
                prev = e[i - 1][1] + 1 if i and e[i - 1][0] == val else 0
                sv[r, i] = val
                if pack_bits == 32:
                    pk1[r, i] = val << 16 | p + 1
                    pk2[r, i] = val << 16 | prev if prev else 0
                else:
                    pk1[r, i] = pk2[r, i] = (val << 40 | (p + 1) << 20
                                             | prev)
        b.update({f'sv_{tag}': torch.from_numpy(sv.astype(np.int32)),
                  f'pk1_{tag}': torch.from_numpy(pk1),
                  f'pk2_{tag}': torch.from_numpy(pk2)})
    r_rows = torch.arange(R, dtype=torch.int32)
    q_rows = torch.arange(R * K, dtype=torch.int32).view(R, K)
    return b, r_rows, q_rows, torch.from_numpy(moved.astype(np.int32))


# (Lq, C, pack_bits) of the crafted arenas: at 2^20 the election's pack
# needs 32 bits of vote code (2 DSPAN + 64 >= 2^22).
CRAFTED = [(4096, 5, 32), (4096, 16, 64), (4096, 32, 32), (1 << 20, 16, 64)]


def crafted_case(Lq, C, pack_bits):
    """crafted_arena of votes_case's votes at bucket Lq (Lr = Lq). Below
    2^20, 2 rows x 4 queries, votes_case's votes moved to the reverse
    strand. At 2^20, 1 x 2, the votes of votes_case at 4,096 and C / 2
    seeds a block (forward only, 2C a block) in the first 32 and the last
    32 fine blocks, the rest empty."""
    if Lq <= 65536:
        votes = votes_case(Lq + C, 2, 4, Lq // FINE, C, Lq, Lq)
        votes = votes.view(2, 4, Lq // FINE, 4 * C)
        return crafted_arena(votes, Lq, Lq, pack_bits, C, C, True)
    small = votes_case(C + 7, 1, 2, 64, C // 2, 4096, 4096).view(
        1, 2, 64, 2 * C)
    votes = torch.full((1, 2, Lq // FINE, 2 * C), ag.BIG, dtype=torch.int32)
    votes[:, :, :32] = small[:, :, :32]
    votes[:, :, -32:] = small[:, :, 32:]
    return crafted_arena(votes, Lq, Lq, pack_bits, C, C, False)

def election_case(b, rows, Lq, Lr, C, seed):
    """An election for K7: the plain votes and election of the rows on the
    arena, then a third of the assigned blocks unassigned (so neighbours
    adopt into them), some diagonals moved by a few bases, and windows
    clipped at -32 and past Lr - 1 in some assigned blocks."""
    r_rows, rlens, q_rows, qlens = rows
    votes = ag.votes_v2_plain(b, r_rows, q_rows, Lq=Lq, Lr=Lr, C=C)
    A, S, D, _ = (x.numpy().copy() for x in ag.elect_v2_plain(votes, Lq=Lq,
                                                              Lr=Lr))
    rng = np.random.default_rng(seed)
    NBF = A.shape[-1]
    f = np.arange(NBF)
    A &= rng.random(A.shape) >= 0.33
    move = rng.random(A.shape) < 0.1
    D = np.where(move, D + rng.integers(-3, 4, A.shape), D).astype(np.int32)
    lo = A & (rng.random(A.shape) < 0.03)
    D = np.where(lo, -FINE * f - rng.integers(28, 40, A.shape), D)
    hi = A & (rng.random(A.shape) < 0.03)
    D = np.where(hi, Lr - FINE * f - rng.integers(-4, 4, A.shape), D)
    return (torch.from_numpy(A), torch.from_numpy(S),
            torch.from_numpy(D.astype(np.int32)))


def chain_election(q_rows, NBF, c0):
    """K7's election where only block c0 of every pair is assigned, at
    diagonal 0 on the forward strand: a genome queried against itself (or
    a close mutant) hands that state on one block each way a round (2
    EXT_ITERS + 1 blocks assigned at the end)."""
    R, K = q_rows.shape
    A = np.zeros((R, K, NBF), bool)
    A[..., c0] = True
    return (torch.from_numpy(A), torch.zeros((R, K, NBF), dtype=torch.bool),
            torch.zeros((R, K, NBF), dtype=torch.int32))


def distinct_election(NBF, R, K, Lr, c0=None):
    """K7's election where every block is assigned and no two blocks of
    any 35 in a row share a state (diagonal 3 + 5 (f mod 7) on the forward
    strand where f mod 5 is even, else diagonal 1 - 4 (f mod 7) reversed),
    so no window of candidates repeats one; with c0, blocks c0 of every
    pair and its neighbours at diagonal 0 forward (its own and its
    neighbours' match the self and mutant pairs best)."""
    f = np.arange(NBF)
    rev = (f % 5) % 2 == 1
    D = np.where(rev, 1 - 4 * (f % 7) - 40 * (f % 5), 3 + 5 * (f % 7)
                 + 50 * (f % 5))
    if c0 is not None:
        D[max(c0 - 1, 0):c0 + 2] = 0
        rev[max(c0 - 1, 0):c0 + 2] = False
    shape = (R, K, NBF)
    return (torch.ones(shape, dtype=torch.bool),
            torch.from_numpy(np.tile(rev, shape[:2] + (1,))),
            torch.from_numpy(np.tile(D.astype(np.int32), shape[:2] + (1,))))


def relay_election(NBF, R, K, c0):
    """K7's election where every block is assigned, each at another
    diagonal than its neighbours (3 + f mod 5, forward), block c0 of every
    pair at diagonal 0: on the self and mutant pairs each step hands the
    state at 0 on to the next block, which adopts it a step after its
    neighbour did (over assigned blocks, not empty ones)."""
    f = np.arange(NBF)
    D = 3 + f % 5
    D[c0] = 0
    shape = (R, K, NBF)
    return (torch.ones(shape, dtype=torch.bool),
            torch.zeros(shape, dtype=torch.bool),
            torch.from_numpy(np.tile(D.astype(np.int32), shape[:2] + (1,))))


def clipped_election(NBF, R, K, Lr, seed):
    """K7's election of windows at and past the clips: in every tenth
    block starts at -32 (kept), -33 (clipped), Lr - 1 (kept) and Lr
    (clipped), on either strand, the other blocks at diagonal 0 forward or
    unassigned (the clipped blocks adopt their neighbours' state)."""
    rng = np.random.default_rng(seed)
    shape = (R, K, NBF)
    f = np.arange(NBF)
    starts = np.array([-32, -33, Lr - 1, Lr])
    at = f % 10 == 3
    D = np.where(at, starts[rng.integers(0, 4, shape)] - FINE * f, 0)
    A = at | (rng.random(shape) < 0.8)
    S = at & (rng.random(shape) < 0.3)
    return (torch.from_numpy(A), torch.from_numpy(S),
            torch.from_numpy(D.astype(np.int32)))
