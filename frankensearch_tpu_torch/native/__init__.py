"""ctypes bindings for the native C++ ingest kernel (the port's copy).

Copy of frankensearch_tpu/native/__init__.py. It loads the same library,
``native/libfs_native.so`` at the repository root. Where that file is
missing, it compiles ``native/fs_native.cc`` with the flags of
``native/Makefile`` into ``build/native/`` and loads that; it never
writes into ``native/``. Every entry point has a pure-Python fallback, so
the package works without a compiler; the native path is a throughput
optimization (reference parity: Quill's scribe ingest contract, >=20k
docs/s).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass

import numpy as np

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_DIR, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfs_native.so")
_BUILT_LIB_PATH = os.path.join(_REPO_DIR, "build", "native", "libfs_native.so")
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")

_lib: ctypes.CDLL | None = None
_load_attempted = False


class _BuildResult(ctypes.Structure):
    _fields_ = [
        ("n_terms", ctypes.c_uint64),
        ("n_postings", ctypes.c_uint64),
        ("term_blob", ctypes.POINTER(ctypes.c_char)),
        ("term_blob_len", ctypes.c_uint64),
        ("term_offsets", ctypes.POINTER(ctypes.c_uint64)),
        ("post_term", ctypes.POINTER(ctypes.c_uint32)),
        ("post_doc", ctypes.POINTER(ctypes.c_uint32)),
        ("post_tf", ctypes.POINTER(ctypes.c_uint32)),
        ("doc_token_counts", ctypes.POINTER(ctypes.c_uint32)),
    ]


def _library_file() -> str | None:
    """The tracked library, else a build of its source under build/native/
    (compiled here when missing); None when neither can be had."""
    if os.path.exists(_LIB_PATH):
        return _LIB_PATH
    if os.path.exists(_BUILT_LIB_PATH):
        return _BUILT_LIB_PATH
    os.makedirs(os.path.dirname(_BUILT_LIB_PATH), exist_ok=True)
    tmp = f"{_BUILT_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-shared", "-o", tmp,
             os.path.join(_NATIVE_DIR, "fs_native.cc")],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _BUILT_LIB_PATH)
    except (subprocess.SubprocessError, OSError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _BUILT_LIB_PATH


def ensure_built() -> bool:
    """Load the shared library, building it if missing; True when loadable."""
    global _lib, _load_attempted
    if _lib is not None:
        return True
    if _load_attempted and not (os.path.exists(_LIB_PATH) or os.path.exists(_BUILT_LIB_PATH)):
        return False
    _load_attempted = True
    path = _library_file()
    if path is None:
        return False
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return False
    lib.fs_build_postings.restype = ctypes.c_int
    lib.fs_build_postings.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
        ctypes.POINTER(_BuildResult),
    ]
    lib.fs_free_build.argtypes = [ctypes.POINTER(_BuildResult)]
    lib.fs_hash64.restype = ctypes.c_uint64
    lib.fs_hash64.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
    if hasattr(lib, "fs_bm25_bounds"):  # absent in pre-r2 builds of the .so
        lib.fs_bm25_bounds.restype = None
        lib.fs_bm25_bounds.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_uint64,
        ]
    _lib = lib
    return True


def bm25_bounds_native(
    flat_ids: np.ndarray,  # (n_pairs,) i64 term ids
    flat_w: np.ndarray,  # (n_pairs,) f32 weights
    flat_q: np.ndarray,  # (n_pairs,) i64 query index
    bm_ptr: np.ndarray,  # (V+1,) i64
    bm_blk: np.ndarray,  # (nnz,) i32
    bm_max: np.ndarray,  # (nnz,) f32
    n_blk: int,
    b: int,
) -> np.ndarray | None:
    """Block-max bound accumulation in C++; None when unavailable."""
    if not ensure_built() or not hasattr(_lib, "fs_bm25_bounds"):
        return None
    flat_ids = np.ascontiguousarray(flat_ids, dtype=np.int64)
    flat_w = np.ascontiguousarray(flat_w, dtype=np.float32)
    flat_q = np.ascontiguousarray(flat_q, dtype=np.int64)
    bm_ptr = np.ascontiguousarray(bm_ptr, dtype=np.int64)
    bm_blk = np.ascontiguousarray(bm_blk, dtype=np.int32)
    bm_max = np.ascontiguousarray(bm_max, dtype=np.float32)
    bound = np.zeros(n_blk * b, dtype=np.float32)
    _lib.fs_bm25_bounds(
        flat_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        flat_w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        flat_q.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_uint64(len(flat_ids)),
        bm_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        bm_blk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bm_max.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bound.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_uint64(b),
    )
    return bound.reshape(n_blk, b)


def is_available() -> bool:
    return ensure_built()


@dataclass
class BulkPostings:
    """Flat postings build output (term-major, doc-sorted within term)."""

    terms: list[str]
    post_term: np.ndarray  # (P,) u32
    post_doc: np.ndarray  # (P,) u32
    post_tf: np.ndarray  # (P,) u32
    doc_token_counts: np.ndarray  # (n_docs,) u32


def build_postings_native(texts: list[str]) -> BulkPostings | None:
    """Native bulk tokenize+accumulate over UTF-8; None if the kernel is
    unavailable. Tokenization is CPython-exact (generated Unicode tables
    incl. Final_Sigma), differentially pinned against the Python
    tokenizer."""
    if not ensure_built():
        return None
    assert _lib is not None
    blob = b"".join(t.encode("utf-8") for t in texts)
    offsets = np.zeros(len(texts) + 1, dtype=np.uint64)
    pos = 0
    for i, t in enumerate(texts):
        offsets[i] = pos
        pos += len(t.encode("utf-8"))  # BYTE offsets into the utf-8 blob
    offsets[len(texts)] = pos

    result = _BuildResult()
    rc = _lib.fs_build_postings(
        blob,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(texts),
        ctypes.byref(result),
    )
    if rc != 0:
        return None
    try:
        n_terms = result.n_terms
        n_post = result.n_postings
        term_offsets = np.ctypeslib.as_array(result.term_offsets, shape=(n_terms + 1,)).copy()
        term_blob = ctypes.string_at(result.term_blob, result.term_blob_len)
        terms = [
            term_blob[int(term_offsets[i]) : int(term_offsets[i + 1])].decode("utf-8")
            for i in range(n_terms)
        ]
        shape = (max(int(n_post), 1),)
        post_term = np.ctypeslib.as_array(result.post_term, shape=shape)[:n_post].copy()
        post_doc = np.ctypeslib.as_array(result.post_doc, shape=shape)[:n_post].copy()
        post_tf = np.ctypeslib.as_array(result.post_tf, shape=shape)[:n_post].copy()
        doc_counts = np.ctypeslib.as_array(
            result.doc_token_counts, shape=(max(len(texts), 1),)
        )[: len(texts)].copy()
    finally:
        _lib.fs_free_build(ctypes.byref(result))
    return BulkPostings(
        terms=terms, post_term=post_term, post_doc=post_doc,
        post_tf=post_tf, doc_token_counts=doc_counts,
    )


def hash64(data: bytes, seed: int = 0) -> int:
    if ensure_built():
        assert _lib is not None
        return int(_lib.fs_hash64(data, len(data), seed))
    # Python fallback: FNV-1a 64
    h = 0xCBF29CE484222325 ^ seed
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & ((1 << 64) - 1)
    return h
