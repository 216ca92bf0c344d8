"""The hybrid corpus: seven genomes at bucket 4,096 that send a non-empty
proper subset of their pairs from the v3 pipe to the v2 re-run, shared by
tests/test_torch_align_v2.py (the JAX package), tests/test_torch_trace.py
and tests/test_torch_slice.py (the port alone). numpy and the port only."""

import numpy as np

from vclust_tpu_torch.io.fasta import FastaRecord, write_fasta
from vclust_tpu_torch.models.input import Genome


def hybrid_genomes(cls=Genome):
    """Seven genomes: a 3,300-base reference with an internal repeat, its
    5% mutant, the reverse complement of a 4% mutant and a 3% mutant of
    its first 1,400 bases (bucket 4,096); a random junk genome; and the
    multi-contig case of tests/test_align_tpu.py at 1,500 + 1,000 + 1,200
    bases, with a 4% mutant whose contigs are reordered: all in bucket
    4,096."""
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b'ACGT', dtype='S1')

    def mut(s, rate):
        s = s.copy()
        m = rng.random(len(s)) < rate
        s[m] = acgt[rng.integers(0, 4, m.sum())]
        return s

    comp = bytes.maketrans(b'ACGT', b'TGCA')
    a = acgt[rng.integers(0, 4, 3300)]
    a[2500:3100] = a[300:900]
    parts = [acgt[rng.integers(0, 4, n)] for n in (1500, 1000, 1200)]
    mp = [mut(p, 0.04) for p in parts]
    return [cls('a', [a.tobytes()]), cls('a.mut5', [mut(a, .05).tobytes()]),
            cls('a.rc', [mut(a, .04).tobytes()[::-1].translate(comp)]),
            cls('a.part', [mut(a[:1400], .03).tobytes()]),
            cls('multi', [p.tobytes() for p in parts]),
            cls('multi.mut', [mp[1].tobytes(), mp[0].tobytes(),
                              mp[2].tobytes()]),
            cls('junk', [acgt[rng.integers(0, 4, 3000)].tobytes()])]


def write_hybrid_dir(gdir):
    """The corpus as a directory of one FASTA a genome, a record a contig
    (the CLI's input); returns gdir."""
    gdir.mkdir(parents=True, exist_ok=True)
    for g in hybrid_genomes():
        write_fasta(gdir / f'{g.name}.fna',
                    [FastaRecord(f'{g.name}_{k}', f'{g.name}_{k}', s)
                     for k, s in enumerate(g.seqs)])
    return gdir
