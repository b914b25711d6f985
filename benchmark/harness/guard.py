"""The check that nothing the run loaded is JAX or the JAX package."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "gandiva_tpu")


def forbidden_modules(modules=None) -> list:
    """Names in ``modules`` (default ``sys.modules``) whose top-level name
    (the part before the first dot) is one of ``FORBIDDEN``, compared
    whole: ``gandiva_tpu_torch`` is not ``gandiva_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
