"""The run's guard against the JAX package: no module whose top-level
name (the part before the first dot, compared whole) is JAX's or the JAX
package's may be loaded in the process that prints the result."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "nekstab_next_tpu"})


class ForbiddenImport(RuntimeError):
    def __init__(self, names: List[str]):
        super().__init__("loaded modules of JAX or the JAX package: " + ", ".join(names))
        self.names = names


def forbidden_modules(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: every
    loaded module)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in modules} & FORBIDDEN)
