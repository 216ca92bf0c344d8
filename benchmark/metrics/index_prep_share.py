"""index_prep_share: the program's own `GenomeIndex.prep_s` (the host's
padding, reverse complements and uploads of every arena build) over the
window, in %."""


def read(t: dict):
    if t['window_s'] <= 0:
        return None
    return 100.0 * t['counters']['prep_s'] / t['window_s']
