"""The run-time check that the process measured nothing of the JAX
package: no module whose top-level name (the part before the first dot) is
one of these may be loaded.  Names are compared whole, since the program's
own package name begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "pde_surrogate_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the
    process's ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)
