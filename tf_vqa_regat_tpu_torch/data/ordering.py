"""The seeded epoch order (counterpart of tf_vqa_regat_tpu/data/ordering.py):
the same formulas, so a seed and an epoch give the JAX package's entry
permutation and, under roi buckets, its batch order (CPU tests check)."""

from __future__ import annotations

import numpy as np

# The version of the formula below, as the JAX package numbers it: a step
# checkpoint records it, and a mid-epoch resume refuses another.
ORDER_VERSION = 2

_M = 2**31
_SEED_MULT = 100003  # spreads nearby seeds apart before the stream fold-in
_BAND = 2**28  # per-kind seed band


def _rs(seed: int, kind: int, epoch: int) -> np.random.RandomState:
    """Stream `kind` of the JAX package's `_rs`, at shard 0 and bucket 0."""
    return np.random.RandomState((seed * _SEED_MULT + kind * _BAND + epoch * 2**13) % _M)


def epoch_perm_rng(seed: int, epoch: int) -> np.random.RandomState:
    """The epoch's entry-permutation stream (kind 0)."""
    return _rs(seed, 0, epoch)


def batch_shuffle_rng(seed: int, epoch: int) -> np.random.RandomState:
    """The roi-bucketed epoch's stream (kind 1): the entry order within each
    bucket, then the order of the batches across buckets."""
    return _rs(seed, 1, epoch)
