"""ctypes binding for the native C++ LZ-parse engine (native/lzparse.cpp).

Drop-in replacement for ops/lz_parse_py.parse_pair with identical semantics
(the Python implementation is the oracle; tests/test_align_native.py checks
bit-identical output). Builds the shared library with g++ into the port's
build directory on first use (utils/build.py); falls back to the Python
engine when no compiler exists.
"""

import ctypes
import os
from typing import List, Optional

import numpy as np

from ..utils.build import BUILD_DIR, NATIVE_SRC_DIR, build_host_library
from .lz_parse_py import AlignParams, Alignment

_LIB_PATH = BUILD_DIR / 'liblzparse.so'
_SRC = NATIVE_SRC_DIR / 'lzparse.cpp'

_lib = None
_build_failed = False

_GAP_POLICY = {'mismatch': 0, 'prev': 1, 'next': 2, 'split': 3}


class _CParams(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int32) for name in (
        'mal', 'msl', 'mrd', 'mqd', 'reg', 'aw', 'am', 'ar',
        'gap_policy', 'seed_back', 'region_back_ext', 'anchor_in_region',
        'anchor_preempt_len', 'seed_window_qscale')]


def _to_cparams(p: AlignParams) -> _CParams:
    return _CParams(
        mal=p.mal, msl=p.msl, mrd=p.mrd, mqd=p.mqd, reg=p.reg, aw=p.aw,
        am=p.am, ar=p.ar, gap_policy=_GAP_POLICY[p.gap_policy],
        seed_back=p.seed_back, region_back_ext=int(p.region_back_ext),
        anchor_in_region=int(p.anchor_in_region),
        anchor_preempt_len=p.anchor_preempt_len,
        seed_window_qscale=int(p.seed_window_qscale))


def get_library():
    """Load (building if needed) the native library, or None."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if not build_host_library(_SRC, _LIB_PATH, ()):
        _build_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        _build_failed = True
        return None
    lib.lz_index_build.restype = ctypes.c_void_p
    lib.lz_index_build.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
        ctypes.POINTER(_CParams)]
    lib.lz_index_free.argtypes = [ctypes.c_void_p]
    lib.lz_parse.restype = ctypes.c_int32
    lib.lz_parse.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
        ctypes.POINTER(_CParams), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32]
    lib.lz_all2all.restype = ctypes.c_void_p
    lib.lz_all2all.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(_CParams), ctypes.c_int32, ctypes.c_int32]
    lib.lz_all2all_aggregates.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.lz_all2all_total_alns.restype = ctypes.c_int64
    lib.lz_all2all_total_alns.argtypes = [ctypes.c_void_p]
    lib.lz_all2all_copy_alns.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.lz_all2all_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return get_library() is not None


class NativeReferenceIndex:
    """Native twin of lz_parse_py.ReferenceIndex."""

    def __init__(self, codes: np.ndarray, params: AlignParams):
        lib = get_library()
        assert lib is not None, 'native engine unavailable'
        self._lib = lib
        self.params = params
        self.n = len(codes)
        codes = np.ascontiguousarray(codes, dtype=np.int8)
        self._codes = codes   # keep alive
        cp = _to_cparams(params)
        self._handle = lib.lz_index_build(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            len(codes), ctypes.byref(cp))

    def __del__(self):
        try:
            if getattr(self, '_handle', None):
                self._lib.lz_index_free(self._handle)
                self._handle = None
        except Exception:
            pass


def parse_pair_native(q_codes: np.ndarray, ref_index: NativeReferenceIndex,
                      params: Optional[AlignParams] = None,
                      max_alignments: int = 65536) -> List[Alignment]:
    params = params or ref_index.params
    lib = ref_index._lib
    q = np.ascontiguousarray(q_codes, dtype=np.int8)
    out = np.empty((max_alignments, 7), dtype=np.int32)
    cp = _to_cparams(params)
    n = lib.lz_parse(
        ref_index._handle,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), len(q),
        ctypes.byref(cp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_alignments)
    n = min(n, max_alignments)
    return [Alignment(qstart=int(r[0]), qend=int(r[1]), rstart=int(r[2]),
                      rend=int(r[3]), nt_match=int(r[4]),
                      nt_mismatch=int(r[5]), strand=int(r[6]))
            for r in out[:n]]


def all2all_native(codes_list: List[np.ndarray], pairs: np.ndarray,
                   params: AlignParams, n_threads: int = 1,
                   keep_alignments: bool = False):
    """Multithreaded all-vs-all parse over candidate pairs.

    The batch analog of lz-ani's `-t` thread pool (reference contract
    vclust.py:1058-1181): references are indexed once, a worker pool drains
    the pair list, and results are stored by pair index, so the output is
    bit-deterministic (the md5-stability property of the reference's
    large-data CI, SURVEY.md section 4.3).

    codes_list: per-genome int8 code arrays (ids order).
    pairs: (n_pairs, 2) int32 array of (i, j) index pairs, i < j; per pair
      both directions are parsed: (q=j, r=i) then (q=i, r=j).

    Returns (agg, alns):
      agg: (n_pairs, 6) int64 — n_alns/nt_match/alnlen for direction (j->i),
        then for (i->j);
      alns: None unless keep_alignments; else (aln_rows, counts) where
        aln_rows is (total, 7) int32 in (pair, dir ji, dir ij) order and
        counts is the flattened per-direction n_alns to split it by.
    """
    lib = get_library()
    assert lib is not None, 'native engine unavailable'
    pairs = np.ascontiguousarray(pairs, dtype=np.int32).reshape(-1, 2)
    n_pairs = len(pairs)
    offsets = np.zeros(len(codes_list) + 1, dtype=np.int64)
    for g, c in enumerate(codes_list):
        offsets[g + 1] = offsets[g] + len(c)
    codes = (np.concatenate([np.ascontiguousarray(c, dtype=np.int8)
                             for c in codes_list])
             if codes_list else np.empty(0, np.int8))
    cp = _to_cparams(params)
    handle = lib.lz_all2all(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(codes_list),
        pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_pairs, ctypes.byref(cp), max(1, int(n_threads)),
        int(keep_alignments))
    try:
        agg = np.zeros((n_pairs, 6), dtype=np.int64)
        if n_pairs:
            lib.lz_all2all_aggregates(
                handle, agg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        alns = None
        if keep_alignments:
            total = lib.lz_all2all_total_alns(handle)
            rows = np.empty((total, 7), dtype=np.int32)
            if total:
                lib.lz_all2all_copy_alns(
                    handle,
                    rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            counts = agg[:, [0, 3]].reshape(-1)
            alns = (rows, counts)
        return agg, alns
    finally:
        lib.lz_all2all_free(handle)
