"""peak_device_gib: torch.cuda.max_memory_allocated() over the window,
after a reset at its start, in GiB."""


def read(t: dict):
    if not t['peak_bytes']:
        return None
    return t['peak_bytes'] / 2 ** 30
