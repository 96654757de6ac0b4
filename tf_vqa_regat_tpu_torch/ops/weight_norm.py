"""Weight-normed dense layers and the FCNet MLP (counterpart of
tf_vqa_regat_tpu/ops/weight_norm.py).

The kernel is ``g * v / ||v||_F`` with a SCALAR g and the norm over the whole
tensor (the reference's WeightNorm, not torch's per-column weight_norm), g
initialised to the norm of the fresh kernel. Kernels are kept in the JAX
layout [in, out], so parameters carry across leaf for leaf; a layer built
with `use_bias=False` has no `b`, as the JAX pytree has none. FCNet puts the
(train-only) dropout before each dense and the activation after it.

Under a bf16 `dtype` a layer computes as JAX's `wn_dense_apply`: the kernel
is materialised in f32 and rounded, the input is cast, the product and the
bias are stored in bf16, or with `out_dtype=torch.float32` (the answer
logits) the product of the rounded operands comes out unrounded in f32
(`nn.dot_f32`). The parameters stay f32.

Tensor parallelism (`shard_`, parallel/tensor.py): a layer split on its
output columns holds `v` [in, out/tp] and, when its bias is split too (the
classifier's hidden layer), `b` [out/tp]; a replicated bias (the attention
Q and K layers, as JAX's `spec_for` leaves it) is sliced to the rank's
columns in the forward pass. A layer split on its input rows holds `v`
[in/tp, out]: its partial products are summed over the model group before
the bias is added once. The caller hands a column-split layer its input
through `copy_to`. The norm of a split `v` is its partial sum of squares
summed over the model group; `g` stays replicated.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tf_vqa_regat_tpu_torch.nn import dot_f32, dropout, glorot_uniform
from tf_vqa_regat_tpu_torch.parallel.tensor import TensorParallel, copy_to, reduce_from

_ACTS = {"relu": torch.relu, None: lambda x: x}


def wn_scale(v: torch.Tensor, g: torch.Tensor,
             tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """g / ||v||_F, with the JAX package's +1e-12 under the root; for a
    split `v` (`tp`) the norm of the whole kernel, its sum of squares summed
    over the model group."""
    if tp is None:
        return g * torch.rsqrt(torch.sum(v * v) + 1e-12)
    ss = reduce_from(torch.sum(v * v), tp)
    return copy_to(g * torch.rsqrt(ss + 1e-12), tp)


class WNLinear(nn.Module):
    """Parameters `v` [in, out], scalar `g` and, with `use_bias`, `b` [out];
    matmuls in `dtype`."""

    def __init__(
        self, in_dim: int, out_dim: int, generator: torch.Generator, use_bias: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        v = glorot_uniform((in_dim, out_dim), generator)
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(torch.linalg.vector_norm(v))
        self.b = nn.Parameter(torch.zeros(out_dim)) if use_bias else None
        self.dtype = dtype
        self.tp: Optional[TensorParallel] = None
        self.split: Optional[str] = None
        self.split_bias = False

    @torch.no_grad()
    def shard_(self, tp: TensorParallel, split: str, split_bias: bool = False) -> None:
        """Keep this rank's part: `split` "cols" (v on its output columns,
        and b with `split_bias`) or "rows" (v on its input rows)."""
        self.tp, self.split = tp, split
        self.v = nn.Parameter(tp.shard(self.v.data, 1 if split == "cols" else 0))
        self.split_bias = split_bias
        if split_bias:
            self.b = nn.Parameter(tp.shard(self.b.data, 0))

    def kernel(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.v * wn_scale(self.v, self.g, self.tp)).to(dtype)

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        cd = self.dtype
        if out_dtype is None or out_dtype == cd:
            y = torch.matmul(x.to(cd), self.kernel(cd))
        else:
            y = dot_f32(x, self.kernel(cd), cd).to(out_dtype)
        if self.split == "rows":
            y = reduce_from(y, self.tp)
        if self.b is None:
            return y
        b = self.b
        if self.split == "cols" and not self.split_bias:
            b = copy_to(b, self.tp)[self.tp.part(b.shape[0])]
        return y + b.to(y.dtype)


class FCNet(nn.Module):
    """Weight-normed MLP over a dim list, e.g. [in, hidden, out] (reference
    fc.py:11-50): dropout at `drop_rate` before every layer in training, the
    activation after it."""

    def __init__(
        self, dims: Sequence[int], generator: torch.Generator,
        activation: Optional[str] = "relu", drop_rate: float = 0.0,
        use_bias: bool = True, dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.layers = nn.ModuleList(
            WNLinear(dims[i], dims[i + 1], generator, use_bias, dtype)
            for i in range(len(dims) - 1)
        )
        self.act = _ACTS[activation]
        self.drop_rate = drop_rate

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        for layer in self.layers:
            x = dropout(x, self.drop_rate, self.training, generator)
            x = self.act(layer(x))
        return x
