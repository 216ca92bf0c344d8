"""Host memory-arena policy for the numpy staging path.

The index build and interchange writers stream hundreds of MB of host
arrays per batch (k-mer COO grouping, pattern dedup, TSV staging). glibc's
default malloc serves every allocation above 128 KiB from a fresh mmap and
returns it on free, so each numpy temporary pays first-touch page faults
for its whole extent — on virtualized hosts that throttles linear numpy
passes to ~100 MB/s (measured: 5.3 s to copy a 576 MB array cold vs 0.07 s
warm).

This module pins the large-allocation path to the main heap instead: big
blocks are carved from sbrk space whose pages stay resident across
free/realloc cycles, so the second and every later temporary of a streaming
loop runs at memory speed. This is the host-side analog of keeping a
persistent device arena (reference kmer-db keeps one growable pattern arena
for the same reason [EXTERNAL]; contract SURVEY.md section 2.4).

Applied once at package import; no-op (with a debug log) on non-glibc
platforms.
"""

import ctypes
import logging

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_MMAP_MAX = -4

_applied = False


def tune_host_allocator() -> bool:
    """Route large allocations to the persistent heap; never trim it.

    Returns True if the tuning took effect, False otherwise. Idempotent.
    """
    global _applied
    if _applied:
        return True
    try:
        libc = ctypes.CDLL('libc.so.6', use_errno=True)
        ok = (libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30) == 1
              and libc.mallopt(_M_TRIM_THRESHOLD, 1 << 30) == 1
              and libc.mallopt(_M_MMAP_MAX, 0) == 1)
    except Exception:
        ok = False
    if ok:
        _applied = True
    else:  # pragma: no cover - non-glibc hosts
        logging.getLogger('vclust-tpu').debug(
            'host allocator tuning unavailable; large numpy temporaries '
            'will pay first-touch page faults')
    return ok
