"""v2_pairs_per_pair: the pairs the hybrid passed to the v2 pipe's
`_all2all_single` call over all pairs of the window's align calls."""


def read(t: dict):
    if not t['counters']['pairs']:
        return None
    return t['counters']['pairs_v2_calls'] / t['counters']['pairs']
