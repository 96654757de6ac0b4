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
    """The model axis seen from one rank: `size` ranks, this rank's `index`
    among them, and their process `group`."""

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
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return distributed.all_gather(x, dim, tp.group)

    @staticmethod
    def backward(ctx, grad):
        index = [slice(None)] * grad.ndim
        index[ctx.dim] = ctx.tp.part(grad.shape[ctx.dim])
        return grad[tuple(index)], None, None


def copy_to(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """x itself forward; its gradient summed over the model group."""
    return _CopyTo.apply(x, tp.group)


def reduce_from(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """x summed over the model group forward; the gradient as it is."""
    return _ReduceFrom.apply(x, tp.group)


def gather(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """The ranks' parts of x concatenated along `dim` forward; this rank's
    part of the gradient backward."""
    return _Gather.apply(x, dim, tp)
