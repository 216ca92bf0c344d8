"""index_share: the share of the window, in %, that the genome index takes:
the program's own `GenomeIndex.prep_s` (the host's padding, reverse
complements and uploads) plus the device time of the index kernels in the
trace (K9 `index_v3_kernel`, K10 `index_v2_select`, `index_v2_pass`,
`index_v2_pack`)."""

KERNELS = ('index_v3_kernel', 'index_v2_select', 'index_v2_pass',
           'index_v2_pack')


def read(t: dict):
    if t['window_s'] <= 0:
        return None
    dev = sum(s for n, s in t['device_ops'].items()
              if n.startswith(KERNELS))
    if dev <= 0:
        return None
    return 100.0 * (t['counters']['prep_s'] + dev) / t['window_s']
