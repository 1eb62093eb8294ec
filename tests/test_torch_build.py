"""The kernel build sees every kernel source, and builds once per process.

``ops/_build.py`` names the library after a hash of ``SOURCES`` and
``HEADERS``; a file under ``ops/csrc/`` that neither lists would be left
out of the build, or, as a header, let an edit reuse a stale build.
Threads whose first kernel launches come together (readers racing a
refresh worker) share one build: two builds in one process would write
the same pid-named temporary files.
"""

import re
import threading
import time

from frankensearch_tpu_torch.ops import _build


def test_every_kernel_source_is_built_or_hashed():
    on_disk = {p.name for p in _build.CSRC.iterdir() if p.is_file()}
    listed = set(_build.SOURCES) | set(_build.HEADERS)
    assert on_disk == listed
    assert all(name.endswith(".cu") for name in _build.SOURCES)
    assert all(name.endswith(".cuh") for name in _build.HEADERS)


def test_every_local_include_is_a_hashed_header():
    for name in _build.SOURCES + _build.HEADERS:
        for inc in re.findall(r'^#include "([^"]+)"', (_build.CSRC / name).read_text(), re.M):
            assert inc in _build.HEADERS, f"{name} includes {inc}"


class _Entry:
    """A stand-in for a ctypes function (its argtypes and restype are set)."""


class _FakeLibrary:
    def __getattr__(self, name):
        entry = _Entry()
        setattr(self, name, entry)
        return entry


def test_concurrent_first_use_builds_once(monkeypatch):
    built, start = [], threading.Barrier(8)

    def slow_build():
        built.append(threading.get_ident())
        time.sleep(0.2)
        return _build.BUILD_DIR / "libfs_kernels_test.so"

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "library_path", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _FakeLibrary())
    got = []

    def first_launch():
        start.wait(timeout=10)
        got.append(_build.library())

    threads = [threading.Thread(target=first_launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1 and len(got) == 8 and all(lib is got[0] for lib in got)
    assert got[0].fs_group_max.restype is _build.ctypes.c_int
