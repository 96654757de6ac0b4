"""The dp x tp layout of a run (counterpart of
tf_vqa_regat_tpu/parallel/mesh.py's `make_mesh`, `batch_sharding` and
`param_shardings` for one device per process).

Rank r sits at (r // tp, r % tp): its data index and its model index, as
JAX's `reshape(dp_size, tp_size)` lays out the devices. The dp data groups
split every global batch along its batch axis: data index d holds rows
[d B/dp, (d+1) B/dp) of a [B] index vector or of each batch of a [K, B]
block (`batch_slice`); the tp ranks of one data group hold the same rows.
The gradients are summed over the data group (the ranks of one model index)
once per optimizer step (train/step.py).

The parameters follow JAX's rules (`shard_axis`, `param_shardings`' own
`spec_for`): at tp > 1 each graph-attention direction's Q and K kernels are
split on their head-major output columns and its grouped output kernel on
the heads, the classifier's hidden layer on its columns (kernel and bias)
and its answer layer on its rows; every other leaf, and every leaf at
tp = 1, is replicated. Adamax's moments take their parameter's layout
(`train_state_shardings`). parallel/tensor.py carries the collectives over
the model group that the split layers need.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from tf_vqa_regat_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """dp x tp ranks; `rank` is this process's global rank; `group` whether
    a process group carries the collectives (a group of one rank
    included)."""

    dp: int
    tp: int = 1
    rank: int = 0
    group: bool = False

    @property
    def data(self) -> int:
        """This rank's data index: its rows of every batch, its shard of the
        sharded store, its dropout seeds."""
        return self.rank // self.tp

    @property
    def model(self) -> int:
        """This rank's model index: its shard of the split parameters."""
        return self.rank % self.tp

    def data_group(self) -> Any:
        """The process group of this rank's data group (the world at tp = 1),
        over which gradients, metrics and answers are summed."""
        return distributed.mesh_groups(self.dp, self.tp)[0] if self.group else None

    def model_group(self) -> Any:
        """The process group of this rank's model group, None at tp = 1."""
        return distributed.mesh_groups(self.dp, self.tp)[1] if self.group else None

    def tensor_parallel(self):
        """The model axis as parallel/tensor.py's TensorParallel, or None at
        tp = 1 (the model is today's one-device model exactly)."""
        if self.tp == 1:
            return None
        from tf_vqa_regat_tpu_torch.parallel.tensor import TensorParallel

        return TensorParallel(self.tp, self.model, self.model_group())

    def data_axis(self):
        """The data axis as a TensorParallel (`size` dp, `index` this rank's
        data index, the data group), or None without a group or at dp = 1:
        what gathers a batch-axis softmax's rows (models/language.py)."""
        if self.dp == 1 or not self.group:
            return None
        from tf_vqa_regat_tpu_torch.parallel.tensor import TensorParallel

        return TensorParallel(self.dp, self.data, self.data_group())


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
    """Data index `rank`'s rows of the last (batch) axis of `idx`: [r B/dp,
    (r+1) B/dp). B must divide by dp."""
    B = idx.shape[-1]
    if B % dp:
        raise ValueError(f"batch {B} not divisible by dp={dp}")
    per = B // dp
    return idx[..., rank * per : (rank + 1) * per]


OPT_MOMENTS = ("opt/mu/", "opt/nu/")


def shard_axis(path: str) -> Optional[int]:
    """The axis of the leaf at pytree path `path` (params.py's keys, '/'
    or '.' separated) that the model axis splits at tp > 1, or None for a
    replicated leaf: JAX `param_shardings`' `spec_for`, with an Adamax
    moment (`opt/mu/<path>`, `opt/nu/<path>`) taking its parameter's axis."""
    path = path.replace(".", "/")
    for pre in OPT_MOMENTS:
        if path.startswith(pre):
            path = path[len(pre):]
    if "v_relation" in path and "neighbor" in path:
        if path.endswith("out/v"):
            return 0  # [H, D, o]: the heads
        if ("query" in path or "/key/" in path) and path.endswith("/v"):
            return 1  # [D, D]: the head-major output columns
    if "classifier" in path:
        if path.endswith("fc1/v"):
            return 1
        if path.endswith("fc1/b"):
            return 0
        if path.endswith("fc2/v"):
            return 0
    return None
