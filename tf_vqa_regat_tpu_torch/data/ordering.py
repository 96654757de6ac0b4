"""The seeded epoch order (counterpart of tf_vqa_regat_tpu/data/ordering.py):
the same formula, so a seed and an epoch give the JAX package's permutation
(a CPU test checks)."""

from __future__ import annotations

import numpy as np

# The version of the formula below, as the JAX package numbers it: a step
# checkpoint records it, and a mid-epoch resume refuses another.
ORDER_VERSION = 2

_M = 2**31
_SEED_MULT = 100003  # spreads nearby seeds apart before the stream fold-in
_BAND = 2**28  # per-kind seed band


def epoch_perm_rng(seed: int, epoch: int) -> np.random.RandomState:
    """The epoch's entry-permutation stream (stream kind 0, shard 0,
    bucket 0 of the JAX package's `_rs`)."""
    return np.random.RandomState((seed * _SEED_MULT + 0 * _BAND + epoch * 2**13) % _M)
