"""Inputs of the v2 front end's kernels (K8, the seed votes; K6, the
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
