"""device_idle_share: the share of the traced window, in %, in which no
kernel, copy or memset ran on the card (torch.profiler)."""


def read(t: dict):
    if t['window_s'] <= 0 or t['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])
