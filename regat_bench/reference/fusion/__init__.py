"""ReGAT's fusions, each with the classifier after it, in a file of its own
(`<fusion>.py`) that the configuration's "fusion" names. A fusion's file
holds everything the harness knows of it:

  params(cfg) -> List[Leaf]   its leaves, which follow the relation
                              encoder's in reference/params.py's layout
  FROZEN                      those of its leaves that take no update
  question(seq)               what it reads of the GRU's sequence [b, T,
                              num_hid]; the forward takes it right after
                              the GRU, so that a fusion file cannot change
                              the order in which autograd sums the
                              sequence's gradient over its readers
  logits(model, visual, q, roi_mask, gen) -> [b, answers]
                              from a reference/regat.py Model, the relation
                              encoder's output [b, R, relation_dim], what
                              `question` read and the roi mask [b, R]; its
                              dropout masks drawn from `gen` in forward
                              order
  matmuls(cfg)                its matrix products per question, as
                              flops.matmuls lists them

Like the rest of the reference, a fusion's file imports torch, numpy, the
standard library and the reference's own modules only.
"""

from __future__ import annotations

import importlib
import os
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> ModuleType:
    """The fusion `name`'s module, reference/fusion/<name>.py."""
    if not name.isidentifier() or not os.path.exists(os.path.join(HERE, name + ".py")):
        raise FileNotFoundError(f"fusion {name!r}: no regat_bench/reference/fusion/{name}.py")
    return importlib.import_module(f"{__name__}.{name}")
