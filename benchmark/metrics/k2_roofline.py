"""k2_roofline: the least int8 operations of v3 stage 1 over the window's
v3 pairs (roofline.k2_ops) at the card's int8 peak, over K2's device time
(`stage1_kernel` in the trace), in %."""

import roofline


def read(t: dict):
    dev = sum(s for n, s in t['device_ops'].items() if 'stage1_kernel' in n)
    ops = t['counters']['k2_ops']
    if dev <= 0 or ops <= 0:
        return None
    return 100.0 * ops / roofline.INT8_TENSOR_OPS_PER_S / dev
