"""k6_roofline: K6's least time over the window's v2 pairs (the larger of
its bytes at the memory rate and its int32 slots at the int32 rate,
roofline.k6_least) over K6's device time (`front_kernel` in the trace),
in %."""

import roofline


def read(t: dict):
    dev = sum(s for n, s in t['device_ops'].items() if 'front_kernel' in n)
    c = t['counters']
    least = roofline.k6_least_s(c['k6_bytes'], c['k6_slots'])
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev
