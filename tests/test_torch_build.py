"""The kernel build sees every kernel source.

``ops/_build.py`` names the library after a hash of ``SOURCES`` and
``HEADERS``; a file under ``ops/csrc/`` that neither lists would be left
out of the build, or, as a header, let an edit reuse a stale build.
"""

import re

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
