"""One direction of implicit graph self-attention (counterpart of
tf_vqa_regat_tpu/ops/graph_attention.py, `graph_attention_apply` on its
fused-kernel branch).

Per direction: Q and K weight-normed FCNets; V projected FIRST by the grouped
weight-normed kernel (softmax @ (V @ W) == (softmax @ V) @ W, so the
[b, R, H, D] attended values never exist); then the fused implicit attention
(ops/kernels/implicit_attention.py) builds the geometry bias from the
position matrix and attends; the shared output bias is added last. On a CUDA
tensor that is one kernel launch per direction.

In training, dropout at `drop_rate` precedes the Q and K projections
(FCNet), and the sinusoid embedding's uint8 keep-mask [b, R, n, P] is drawn
here with the step's generator and handed to the kernel, as the JAX fused
branch draws it (graph_attention.py:155-170).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tf_vqa_regat_tpu_torch.nn import glorot_uniform, keep_mask
from tf_vqa_regat_tpu_torch.ops.kernels.implicit_attention import (
    fused_implicit_graph_attention,
)
from tf_vqa_regat_tpu_torch.ops.weight_norm import FCNet, wn_scale


class GroupedProjection(nn.Module):
    """The grouped 1x1 conv (groups=H) under WeightNorm: `v` [H, D, o] with a
    scalar `g` over the whole tensor and one shared bias `b` [H*o]."""

    def __init__(self, hidden_dim: int, num_heads: int, generator: torch.Generator):
        super().__init__()
        o = hidden_dim // num_heads
        flat = glorot_uniform((hidden_dim, num_heads * o), generator)
        v = flat.reshape(hidden_dim, num_heads, o).permute(1, 0, 2).contiguous()
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(torch.linalg.vector_norm(v))
        self.b = nn.Parameter(torch.zeros(num_heads * o))

    def kernel(self) -> torch.Tensor:
        return self.v * wn_scale(self.v, self.g)


class GraphSelfAttention(nn.Module):
    """Parameters as the JAX `graph_attention_init` pytree: `query`, `key`,
    `out`, `pair_pos_fc`."""

    def __init__(
        self, hidden_dim: int, num_heads: int, pos_emb_dim: int,
        generator: torch.Generator, drop_rate: float = 0.0,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.drop_rate = drop_rate
        self.query = FCNet(
            [hidden_dim, hidden_dim], generator, activation=None, drop_rate=drop_rate
        )
        self.key = FCNet(
            [hidden_dim, hidden_dim], generator, activation=None, drop_rate=drop_rate
        )
        self.out = GroupedProjection(hidden_dim, num_heads, generator)
        self.pair_pos_fc = FCNet([pos_emb_dim, num_heads], generator, activation=None)

    def forward(
        self,
        roi: torch.Tensor,  # [b, R, D]
        pos_mat: torch.Tensor,  # [b, R, n, 4]
        key_mask: torch.Tensor,  # [b, n] bool
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:  # [b, R, D]
        b, R, D = roi.shape
        n = pos_mat.shape[2]
        H = self.num_heads
        trunc = roi[:, :n]
        q = self.query(roi, generator).view(b, R, H, D // H)
        k = self.key(trunc, generator).view(b, n, H, D // H)
        vw = torch.einsum("bnd,hdo->bnho", trunc, self.out.kernel()).contiguous()
        layer = self.pair_pos_fc.layers[0]
        drop_rate, dropmask = 0.0, None
        if self.training and self.drop_rate > 0.0:
            drop_rate = self.drop_rate
            shape = (b, R, n, layer.v.shape[0])
            dropmask = keep_mask(shape, drop_rate, generator, roi.device).view(torch.uint8)
        out = fused_implicit_graph_attention(
            q, k, vw, pos_mat, layer.kernel(), layer.b, key_mask, drop_rate, dropmask
        )
        return out.reshape(b, R, D) + self.out.b
