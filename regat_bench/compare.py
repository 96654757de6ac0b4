"""The comparison that decides `correct`: the numbers compared between what
the program produced and what the reference computes from the same inputs
and weights, each against its limit (limits/<workload>.json).

- A loss is compared by its relative gap |program - reference| / |reference|.
- A set of tensors (a gradient, a change of the parameters) is compared
  leaf by leaf by the gap between the program's norm and the reference's,
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger; the worst leaf counts, or for the change of the parameters
  the median leaf (train_epoch.py says why).
- A served answer is compared by how far the reference's logit of the
  answer the program served lies below the reference's best logit, and by
  the gap between the served confidence and the sigmoid of the reference's
  logit of that answer; the widest gap counts.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Tuple

import torch

# leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone (a bias that feeds a softmax) and are left out of
# the change of the parameters
NOUGHT_GRADIENT = 1e-3


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between two {leaf: norm} maps, over the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    names = list(reference if names is None else names)
    med = statistics.median(reference[k] for k in names)
    return {k: abs(program[k] - reference[k]) / max(reference[k], med) for k in names}


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             names: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(the worst leaf's gap, its name)."""
    gaps = leaf_gaps(program, reference, names)
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def moving(grad_norms: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(grad_norms.values())
    return [k for k, v in grad_norms.items() if v >= NOUGHT_GRADIENT * med]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every number within its limit, {name: {"value", "limit"}}). A number
    that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in sorted(limits.items()):
        value = numbers.get(name, float("nan"))
        good = value == value and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
