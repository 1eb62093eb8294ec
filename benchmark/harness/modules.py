"""What a run may not load: JAX, and the JAX package the port was made
from. Module names are compared by their top-level name whole, since the
port's own name begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "frankensearch_tpu"})


def forbidden_loaded(names=None) -> list[str]:
    names = sys.modules if names is None else names
    return sorted({name.partition(".")[0] for name in names} & FORBIDDEN)
