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
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tf_vqa_regat_tpu_torch.nn import dot_f32, dropout, glorot_uniform

_ACTS = {"relu": torch.relu, None: lambda x: x}


def wn_scale(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g / ||v||_F, with the JAX package's +1e-12 under the root."""
    return g * torch.rsqrt(torch.sum(v * v) + 1e-12)


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

    def kernel(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.v * wn_scale(self.v, self.g)).to(dtype)

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        cd = self.dtype
        if out_dtype is None or out_dtype == cd:
            y = torch.matmul(x.to(cd), self.kernel(cd))
        else:
            y = dot_f32(x, self.kernel(cd), cd).to(out_dtype)
        return y if self.b is None else y + self.b.to(y.dtype)


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
