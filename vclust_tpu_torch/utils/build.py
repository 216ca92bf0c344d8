"""The port's build directory and the compile step its libraries share.

Every library the port loads is built from the sources in the checkout
into `vclust_tpu_torch/_build/` (listed in .gitignore) at first use: the
host engines from native/*.cpp with g++, the CUDA kernels from csrc/*.cu
with nvcc (ops/cuda.py). A library is rebuilt when it is missing or older
than its source. A build writes to a temporary name and renames it into
place, so processes that build the same library at once never load a
half-written file.
"""

import os
import pathlib
import subprocess

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
REPO_DIR = PKG_DIR.parent
BUILD_DIR = PKG_DIR / '_build'
CSRC_DIR = PKG_DIR / 'csrc'
NATIVE_SRC_DIR = REPO_DIR / 'native'


def is_stale(lib: pathlib.Path, src: pathlib.Path) -> bool:
    return (not lib.exists()
            or (src.exists() and src.stat().st_mtime > lib.stat().st_mtime))


def start_compile(cmd, lib: pathlib.Path):
    """Start `cmd + ['-o', tmp]`; returns (process, tmp). `finish_compile`
    moves tmp into place."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f'.{lib.name}.{os.getpid()}.tmp')
    proc = subprocess.Popen([*cmd, '-o', str(tmp)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp


def finish_compile(proc, tmp: pathlib.Path, lib: pathlib.Path):
    """Wait for a compile; returns (ok, compiler output)."""
    out, err = proc.communicate()
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        return False, (out + err).strip()
    os.replace(tmp, lib)
    return True, (out + err).strip()


def build_host_library(src: pathlib.Path, lib: pathlib.Path,
                       extra=()) -> bool:
    """g++ build of a native host engine; False when no compiler works."""
    if not is_stale(lib, src):
        return True
    try:
        proc, tmp = start_compile(
            ['g++', '-O3', '-march=native', '-std=c++17', '-fPIC', '-Wall',
             '-shared', str(src), *extra], lib)
    except OSError:
        return False
    ok, _ = finish_compile(proc, tmp, lib)
    return ok
