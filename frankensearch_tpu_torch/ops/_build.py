"""Build and load the hand-written Hopper kernels (plain C entry points).

The ``csrc/*.cu`` sources compile with ``nvcc`` into one shared library
under ``build/kernels/`` at the repository root, named by a hash of the
sources and flags, so an unchanged tree reuses its build. The library has
a plain C interface and loads through ``ctypes``: building against
PyTorch's headers would take minutes instead of seconds.

Nothing here runs at import time; the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("group_max.cu", "gather_rescore.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path() -> Path:
    """Compile the kernels if this source tree has no build yet; returns
    the shared library's path. The ptxas report (registers, shared memory,
    spills) is kept beside it as ``.log``."""
    srcs = [CSRC / name for name in SOURCES]
    digest = hashlib.sha256()
    for flag in NVCC_FLAGS:
        digest.update(flag.encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libfs_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent builder never loads a partial file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(library_path()))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fs_group_max.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i64, i32, ptr]
        lib.fs_group_max.restype = i32
        lib.fs_gather_rescore.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i64, i32, ptr]
        lib.fs_gather_rescore.restype = i32
        _lib = lib
    return _lib
