"""The seeds on which the check met the open fault F2 (PERF.md's Open
questions): the generator and the cells' files still make the jobs those
seeds made, so the change that repairs F2 meets the same pairs, and adds
the cells kept out as they are.

On the card, `python3 benchmark/witness.py --workload <cell> --seed <seed>
--job <k> --pair <i>,<j> --swap k7,k6` replays such a run."""

import json
import zlib

import pytest

import jobs
from conftest import BENCH

# (config, traffic, seed, job, pair, lengths, crc32 of the two genomes'
# codes, the job's pairs and genomes)
FAILING = [
    ('ictv_species', 'genus', 3000003, 2, (536, 562), (33991, 33991),
     (3265672214, 3970004085), (11189, 833)),
    ('ictv_species', 'genus', 3000001, 2, (429, 430), (45354, 45354),
     (2973693953, 909988607), (11189, 833)),
    ('imgvr_votu', 'complete', 2147483659, 1, (8, 17), (133278, 122078),
     (4083540265, 2845704916), (23764, 1735)),
    ('imgvr_votu', 'complete_131k', 4294967357, 1, (13, 16),
     (119354, 119009), (2114322893, 1342969708), (23764, 1735)),
    ('imgvr_votu', 'whole', 5000000153, 2, (12, 13), (134398, 134398),
     (2110794569, 2232630117), (23764, 1735)),
    ('imgvr_votu', 'whole', 4000002, 1, (15, 18), (134398, 134398),
     (3068203260, 3616770010), (23764, 1735))]


@pytest.mark.parametrize('cfg,mix,seed,job,pair,lengths,crcs,size', FAILING)
def test_failing_seeds_make_the_same_jobs(cfg, mix, seed, job, pair, lengths,
                                          crcs, size):
    config = json.loads((BENCH / 'configs' / f'{cfg}.json').read_text())
    traffic = json.loads((BENCH / 'traffic' / f'{mix}.json').read_text())
    j = jobs.make_jobs(config, traffic, seed)[job]
    assert (len(j.pairs), len(j.codes_list)) == size
    assert tuple(pair) in set(map(tuple, j.pairs.tolist()))
    for g, length, crc in zip(pair, lengths, crcs):
        assert j.lens[g] == length
        assert zlib.crc32(j.codes_list[g].tobytes()) == crc
