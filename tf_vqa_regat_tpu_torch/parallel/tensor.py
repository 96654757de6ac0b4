"""Tensor parallelism over the model axis (the port's counterpart of what
GSPMD inserts for JAX's `param_shardings` at tp > 1): the collectives of
the split layers as autograd functions over the model group, and the
slicing of full parameters into this rank's shards.

The invariant: a replicated tensor is the same on every rank of a model
group, and so is its gradient, which each rank computes in full; a split
tensor holds this rank's part, with the gradient of that part. Three
functions keep it at the edges of a split computation:

- `copy_to`: identity forward, all-reduce backward, where a replicated
  tensor enters a split product (each rank's backward holds only its part's
  contribution to the gradient);
- `gather`: all-gather forward, slice backward, where split outputs become
  a replicated tensor (every rank then computes the same gradient of it);
  over the data group (`sum_grad`), where each rank's rows join the global
  batch of `--ref_compat_q_att`'s softmax, the gradient is summed over the
  group before the slice;
- `reduce_from`: all-reduce forward, identity backward, after a product
  over a split inner axis (the partial sums add up to the replicated
  output).

Only all-reduce and all-gather are used (parallel/distributed.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from tf_vqa_regat_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One axis of the mesh seen from one rank: `size` ranks, this rank's
    `index` among them, and their process `group`. The model axis (tp > 1),
    or the data axis (`Mesh.data_axis`) where a batch-axis softmax spans the
    global batch."""

    size: int
    index: int
    group: Any = dataclasses.field(default=None, compare=False, repr=False)

    def part(self, n: int) -> slice:
        """This rank's part of an axis of length `n` (which `size` divides)."""
        if n % self.size:
            raise ValueError(f"an axis of {n} does not split over tp={self.size}")
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)

    def shard(self, t, axis: int):
        """This rank's part of the full tensor or array `t` along `axis`, a
        contiguous copy."""
        index = [slice(None)] * t.ndim
        index[axis] = self.part(t.shape[axis])
        part = t[tuple(index)]
        return part.clone().contiguous() if isinstance(part, torch.Tensor) else part.copy()


def _all_reduce(x: torch.Tensor, group: Any) -> torch.Tensor:
    out = x.contiguous().clone()
    distributed.all_reduce_([out], group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, sum_grad):
        ctx.dim, ctx.axis, ctx.sum_grad = dim, axis, sum_grad
        return distributed.all_gather(x, dim, axis.group)

    @staticmethod
    def backward(ctx, grad):
        if ctx.sum_grad:
            grad = _all_reduce(grad, ctx.axis.group)
        index = [slice(None)] * grad.ndim
        index[ctx.dim] = ctx.axis.part(grad.shape[ctx.dim])
        return grad[tuple(index)], None, None, None


def copy_to(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """x itself forward; its gradient summed over the model group."""
    return _CopyTo.apply(x, tp.group)


def reduce_from(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """x summed over the model group forward; the gradient as it is."""
    return _ReduceFrom.apply(x, tp.group)


def gather(x: torch.Tensor, tp: TensorParallel, dim: int, sum_grad: bool = False) -> torch.Tensor:
    """The ranks' parts of x concatenated along `dim` forward, in rank
    order; this rank's part of the gradient backward. Over the model group
    every rank holds the whole gradient of the replicated result; with
    `sum_grad` (the data group, whose ranks' losses differ) the gradient is
    first summed over the group."""
    return _Gather.apply(x, dim, tp, sum_grad)
