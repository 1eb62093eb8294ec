"""Build and load the hand-written Hopper kernels (plain C entry points).

The ``csrc/*.cu`` sources compile with ``nvcc`` into one shared library
under ``build/kernels/`` at the repository root, named by a hash of the
sources and flags, so an unchanged tree reuses its build. Each source
compiles in its own ``nvcc`` process, all started together, and one more
``nvcc`` links the objects. The library has a plain C interface and loads
through ``ctypes``: building against PyTorch's headers would take minutes
instead of seconds.

Nothing here runs at import time; the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("group_max.cu", "gather_rescore.cu", "flat_score.cu", "tile_topk.cu", "group_candidates.cu")
#: headers the sources include (part of the build's hash): group_scan.cuh
#: is the mma.sync scoring body of K5, hopper.cuh the TMA, mbarrier and
#: wgmma primitives of K1 and K4 (group_max.cu), scan_f32.cuh the FFMA
#: scoring body of K1's f32 form
HEADERS = ("group_scan.cuh", "hopper.cuh", "scan_f32.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None
#: one build and load per process: threads whose first kernel launches
#: come together wait for it (the build's temporary files are named by
#: the pid, so two builds in one process would write the same files)
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> str:
    """Wait for every process; the joined output, or raise on the first
    that failed."""
    logs = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
        logs.append(out + err)
    return "".join(logs)


def library_path() -> Path:
    """Compile the kernels if this source tree has no build yet; returns
    the shared library's path. The ptxas report (registers, shared memory,
    spills) is kept beside it as ``.log``."""
    srcs = [CSRC / name for name in SOURCES]
    digest = hashlib.sha256()
    for flag in NVCC_FLAGS:
        digest.update(flag.encode())
    for src in srcs + [CSRC / name for name in HEADERS]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libfs_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [out.with_name(f"{out.stem}.{src.stem}.{tag}.o") for src in srcs]
    compiles = []
    for src, obj in zip(srcs, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        compiles.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    tmp = out.with_name(f"{out.name}.{tag}")
    try:
        log = _run(compiles)
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp), *map(str, objs)]
        log += _run([(link, subprocess.Popen(link, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
    except BaseException:
        for _, proc in compiles:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent builder never loads a partial file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _load()
    return _lib


def _load() -> ctypes.CDLL:
    """Build (if needed) and load the library, its entry points typed."""
    lib = ctypes.CDLL(str(library_path()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fs_group_max.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i64, i32, ptr]
    lib.fs_group_max.restype = i32
    lib.fs_gather_rescore.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i64, i32, ptr]
    lib.fs_gather_rescore.restype = i32
    lib.fs_gather_rescore_sorted.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i64, i32, ptr]
    lib.fs_gather_rescore_sorted.restype = i32
    lib.fs_gather_plan.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.fs_gather_plan.restype = i32
    lib.fs_flat_fused.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, ptr, ptr, ptr, ptr,
                                  i32, i32, i32, i32, i32, ptr]
    lib.fs_flat_fused.restype = i32
    lib.fs_group_max_int8.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i64, ptr]
    lib.fs_group_max_int8.restype = i32
    lib.fs_gather_rescore_i8.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i64, ptr]
    lib.fs_gather_rescore_i8.restype = i32
    lib.fs_gather_rescore_i8_sorted.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i64, ptr]
    lib.fs_gather_rescore_i8_sorted.restype = i32
    lib.fs_tile_topk.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i64, i32, i32, ptr]
    lib.fs_tile_topk.restype = i32
    lib.fs_tile_topk_wide.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i64, i32, i32, ptr]
    lib.fs_tile_topk_wide.restype = i32
    lib.fs_tile_select.argtypes = [ptr, ptr, ptr, i32, i64, i32, i32, ptr]
    lib.fs_tile_select.restype = i32
    return lib
