"""ctypes binding for the native index-build engine (native/kmerindex.cpp).

The kmer-db `build` analog (reference contract vclust.py:953-964): turns
per-genome sorted distinct k-mer arrays into the pattern-compressed COO
consumed by the device occupancy count (kernel K1). Semantically identical
to the numpy
path in ops/prefilter.py (`_group_coo` + `_dedup_patterns`); the native
engine fuses partition/sort/group/dedup into cache-resident passes and is
~10x faster on large corpora. Builds with g++ into the port's build
directory on first use (utils/build.py); callers fall back to the numpy
path when no compiler exists.
"""

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils.build import BUILD_DIR, NATIVE_SRC_DIR, build_host_library

_LIB_PATH = BUILD_DIR / 'libkmerindex.so'
_SRC = NATIVE_SRC_DIR / 'kmerindex.cpp'

_lib = None
_build_failed = False


def get_library():
    """Load (building if needed) the native library, or None."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if not build_host_library(_SRC, _LIB_PATH, ('-lpthread',)):
        _build_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        _build_failed = True
        return None
    lib.kidx_build.restype = ctypes.c_void_p
    lib.kidx_build.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),                  # kmer_ptrs
        ctypes.POINTER(ctypes.c_int64),                   # set_lens
        ctypes.c_int32, ctypes.c_int32,                   # n_genomes, threads
        ctypes.POINTER(ctypes.c_int64),                   # out_n_groups
        ctypes.POINTER(ctypes.c_int64),                   # out_n_patterns
        ctypes.POINTER(ctypes.c_int64),                   # out_nnz_d
    ]
    lib.kidx_fill.restype = None
    lib.kidx_fill.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.kidx_free.restype = None
    lib.kidx_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return get_library() is not None


def build_index(kmer_sets: Sequence[np.ndarray],
                n_threads: Optional[int] = None
                ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """Native pattern-compressed grouping of per-genome k-mer sets.

    Returns (gids, lens, weights, n_groups) matching the numpy pipeline
    `_dedup_patterns(*_group_coo(kmer_sets))`, or None if the native
    library is unavailable.
    """
    lib = get_library()
    if lib is None:
        return None
    n = len(kmer_sets)
    n_threads = n_threads or min(os.cpu_count() or 1, 64)
    arrs = [np.ascontiguousarray(s, dtype=np.uint64) for s in kmer_sets]
    ptrs = (ctypes.c_void_p * n)(*[
        a.ctypes.data_as(ctypes.c_void_p) for a in arrs])
    set_lens = np.array([len(a) for a in arrs], dtype=np.int64)
    og = ctypes.c_int64()
    op = ctypes.c_int64()
    onnz = ctypes.c_int64()
    handle = lib.kidx_build(
        ptrs, set_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, n_threads, ctypes.byref(og), ctypes.byref(op), ctypes.byref(onnz))
    if not handle:
        return None
    try:
        gids = np.empty(onnz.value, dtype=np.int32)
        lens = np.empty(op.value, dtype=np.int32)
        weights = np.empty(op.value, dtype=np.int64)
        if op.value:
            lib.kidx_fill(
                handle,
                gids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                weights.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    finally:
        lib.kidx_free(handle)
    return gids, lens, weights, og.value
