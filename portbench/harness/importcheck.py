"""The run fails where JAX or the JAX package was loaded in its process."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "multigrid_dolfinx_tpu")


def forbidden_loaded(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def require_clean(when: str) -> None:
    """Raise ImportError naming what is loaded, where anything is."""
    found = forbidden_loaded()
    if found:
        raise ImportError(f"loaded in the run's process {when}: {found}")
