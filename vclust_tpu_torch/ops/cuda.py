"""Build, load and launch the port's hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for `sm_90a` into a shared library with a
plain C interface in the port's build directory, at first use, and loaded
with ctypes. `build()` starts one nvcc per source, all at once. Each C
entry point launches on the stream it is given, allocates nothing, and
returns `cudaGetLastError()` after its launches; `check` raises when that
code is not 0.
"""

import ctypes
import os
import shutil
import time

import torch

from ..utils.build import (BUILD_DIR, CSRC_DIR, finish_compile, is_stale,
                           start_compile)

SOURCES = ('occupancy', 'extend', 'align_v3', 'back_half', 'align_v2',
           'index', 'cc')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C entry points of csrc/align_v3.cu, kernels K2, K3 and K5 of the v3
# align pipe (launched by ops/align_gpu.py): {function: argtypes}.
ALIGN_V3_SIGNATURES = {
    # qocc, rocc, r_rows, q_rows, tasks, K, Gq, Gr, M2, NRB, H, p_sum, p_a,
    # p_b, stream
    'k2_stage1': [_P] * 4 + [_I] * 7 + [_P] * 4,
    # roww_f, roww_r, fwd, r_rows, rlens, q_rows, cnt1, g1, cnt2, g2, N, K,
    # NQB, NRB, FPB, tband, smin, smin2, cnt, best, A, S, D, stream
    'k3_row_bands': [_P] * 10 + [_I] * 8 + [_P] * 6,
    # cnt, A0, S0, D0, best, roww_f, roww_r, fwd, r_rows, rlens, q_rows, g1,
    # g2, N, K, NBF, FPB, NRB, roww, band, iters, ext_min, ext_margin, cont,
    # m1, m0, sw, A, S, D, Ap, Sp, Dp, stream
    'k5_propagate': [_P] * 13 + [_I] * 11 + [_P] * 10,
}
# csrc/back_half.cu, kernel K4, the back half both align pipes share.
BACK_HALF_SIGNATURES = {
    # N, Lq
    'k4_scratch_ints': [_I, _I],
    # m1, m0, sw, A, S, D, Ap, Sp, Dp, rlen, N, Lq, mqd, mrd, reg, maxseg,
    # agg, recs, nrec, scratch, scratch_ints, stream
    'k4_back_half': [_P] * 10 + [_I] * 6 + [_P] * 4 + [_I, _P],
}
# csrc/align_v2.cu, kernels K6 (K8 fused in) and K7 of the v2 front end.
ALIGN_V2_SIGNATURES = {
    # qsv, qoff, sv_f, pk1_f, sv_r, pk1_r, r_rows, q_rows, R, K, NBF, NR,
    # C, Lq, Lr, pack_bits, min_f, min_c, A, S, D, vb, votes (or null),
    # stream
    'k6_front': [_P] * 8 + [_I] * 10 + [_P] * 6,
    # q, q_rows, qlens, r2dov, r_rows, rlens, A0, S0, D0, N, K, NBF, Lr,
    # NRT, iters, ext_min, ext_margin, m1, m0, sw, A, S, D, Ap, Sp, Dp,
    # stream
    'k7_propagate': [_P] * 9 + [_I] * 8 + [_P] * 10,
}
# csrc/index.cu, kernels K9 and K10: the v3 and the v2 index builds.
INDEX_SIGNATURES = {
    # fwd, rc, G, Lp, k, ck, H, shift, WQ, ROWW, qocc, rocc, roww_f,
    # roww_r, stream
    'k9_index_v3': [_P] * 2 + [_I] * 8 + [_P] * 5,
    # G, Lp, C
    'k10_group_rows': [_I, _I, _I],
    # G, Lp, C
    'k10_state_bytes': [_I, _I, _I],
    # G, Lp, C
    'k10_items_bytes': [_I, _I, _I],
    # fwd, rc, G, Lp, k, C, pack_bits, qsv, qoff, sv_f, pk1_f, pk2_f,
    # sv_r, pk1_r, pk2_r, r2dov, state, state_bytes, items, items_bytes,
    # stream
    'k10_index_v2': [_P] * 2 + [_I] * 5 + [_P] * 10 + [_L, _P, _L, _P],
}
# csrc/cc.cu, kernel K11: connected components (single linkage's device
# path).
CC_SIGNATURES = {
    # edges, E, n, labels, stream
    'k11_cc': [_P, _L, _I, _P, _P],
}

_libs = {}
# Compiler output (ptxas register and shared-memory report) per source,
# filled by build().
build_log = {}


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')
    return path


def lib_path(name: str):
    return BUILD_DIR / f'lib{name}.so'


def build(names=SOURCES) -> float:
    """Compile the stale sources among `names` in parallel; returns the
    wall seconds. Raises with the compiler's output if any fails."""
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        src, lib = CSRC_DIR / f'{name}.cu', lib_path(name)
        if is_stale(lib, src):
            jobs.append((name, lib, *start_compile(
                [_nvcc(), *NVCC_FLAGS, str(src)], lib)))
    errors = []
    for name, lib, proc, tmp in jobs:
        ok, log = finish_compile(proc, tmp, lib)
        build_log[name] = log
        if not ok:
            errors.append(f'nvcc failed for csrc/{name}.cu:\n{log}')
    if errors:
        raise RuntimeError('\n'.join(errors))
    return time.perf_counter() - t0


def is_built(name: str) -> bool:
    return not is_stale(lib_path(name), CSRC_DIR / f'{name}.cu')


def library(name: str, signatures):
    """The loaded library of csrc/<name>.cu, built if needed.
    signatures: {C function name: argtypes}; every function returns int."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.vk_error_string.argtypes = [ctypes.c_int]
        lib.vk_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib, rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f'{what}: CUDA error {rc}: '
                           f'{lib.vk_error_string(rc).decode()}')


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t: torch.Tensor, name: str, dtype, ndim: int,
            device: torch.device) -> None:
    """Wrapper-side argument check: dtype, rank, device, contiguity."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'{name} must be a torch.Tensor')
    if t.dtype != dtype:
        raise TypeError(f'{name} must be {dtype}, got {t.dtype}')
    if t.dim() != ndim:
        raise ValueError(f'{name} must have {ndim} dimension(s), '
                         f'got shape {tuple(t.shape)}')
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
