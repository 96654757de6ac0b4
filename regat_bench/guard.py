"""The check that no process of a run loaded JAX or the JAX package: the
top-level name of every module in sys.modules (the part before the first
dot) is compared whole, so `tf_vqa_regat_tpu_torch` passes and
`tf_vqa_regat_tpu` does not. Standard library only: the load generator's
process runs it too."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "tf_vqa_regat_tpu")


def found(modules: Iterable[str] = None, forbidden: Iterable[str] = FORBIDDEN) -> List[str]:
    """The forbidden top-level names among `modules` (default: sys.modules)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(forbidden))
