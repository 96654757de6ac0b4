"""The data-parallel layout of a run (counterpart of
tf_vqa_regat_tpu/parallel/mesh.py's `make_mesh` and `batch_sharding` for
one device per process).

dp ranks split every global batch along its batch axis: rank r holds rows
[r B/dp, (r+1) B/dp) of a [B] index vector or of each batch of a [K, B]
block (`batch_slice`), the batch axis over the data axis. The parameters are
replicated: every rank holds all of them, and the gradients are summed over
the ranks once per optimizer step (train/step.py). Tensor parallelism
(tp > 1, the model axis) is not ported: the config refuses it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tf_vqa_regat_tpu_torch.parallel import distributed

@dataclasses.dataclass(frozen=True)
class Mesh:
    """dp x tp ranks; `rank` is this process's data rank; `group` whether a
    process group carries the collectives (a group of one rank included)."""

    dp: int
    tp: int = 1
    rank: int = 0
    group: bool = False


def make_mesh(dp_size: int = 0, tp_size: int = 1, world: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """The mesh over the process group (or `world` ranks): dp_size 0 means
    every rank over the data axis; dp x tp must equal the world size, with
    the JAX package's messages."""
    n = distributed.world_size() if world is None else world
    if dp_size <= 0:
        if n % tp_size != 0:
            raise ValueError(f"{n} devices not divisible by tp={tp_size}")
        dp_size = n // tp_size
    if dp_size * tp_size != n:
        raise ValueError(f"mesh {dp_size}x{tp_size} != {n} devices")
    r = distributed.rank() if rank is None else rank
    return Mesh(dp=dp_size, tp=tp_size, rank=r, group=distributed.initialized())


def batch_slice(idx: np.ndarray, rank: int, dp: int) -> np.ndarray:
    """Rank `rank`'s rows of the last (batch) axis of `idx`: [r B/dp, (r+1)
    B/dp). B must divide by dp."""
    B = idx.shape[-1]
    if B % dp:
        raise ValueError(f"batch {B} not divisible by dp={dp}")
    per = B // dp
    return idx[..., rank * per : (rank + 1) * per]
