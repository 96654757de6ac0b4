"""Relation encoders, implicit and explicit (counterpart of
tf_vqa_regat_tpu/models/relation.py).

Both directions attend over the same inputs with their own weights, each
through one fused kernel, and their outputs are summed on top of
`self_feat`, then relu.
- Implicit: the graph is fully connected, so there is no label-bias net (a
  bias constant across keys is a softmax no-op); the geometry bias comes
  from the position matrix (B1).
- Explicit (spatial, semantic): the one-hot edge labels [b, R, R, L] give,
  per direction (direction 1 reads them transposed), the adjacency mask and
  an edge-label bias through the `bias` FCNet [L -> 1] (B2).

In training every dropout of the encoder runs at its one `drop_rate` (the
model's graph rate: 0.2, or 0 when the config's `dropout` is 0): on the
input of `self_weights`; per direction on the one-hot labels before the
label FC (explicit), then before Q and K; and on the summed output before
the relu (relation.py:85-108, :159). The implicit `v2out` drops its input
too, at the same rate (the reference pins it at 0.2 apart from `--dropout`;
relation.py:221-229); the explicit `v2out` has no dropout (:290-294).

Under a bf16 `dtype` the FCNets (v2out, self_weights, the label FC, Q and
K) store bf16 and the question vector takes the visual dtype before the
concat (relation.py:173-175); each direction's attention comes back in f32
(ops/graph_attention.py), so the sum on top of `self_feat`, and with it the
encoder's output, is f32, as JAX's is.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tf_vqa_regat_tpu_torch.nn import dropout
from tf_vqa_regat_tpu_torch.ops.graph_attention import GraphSelfAttention
from tf_vqa_regat_tpu_torch.ops.weight_norm import FCNet


def concat_visual_question(
    question: torch.Tensor,  # [b, q_dim]
    visual: torch.Tensor,  # [b, R, v_dim]
    roi_mask: torch.Tensor,  # [b, R] bool
) -> torch.Tensor:
    """The question vector on every valid roi, zeros on padded ones,
    concatenated after the visual features (relation_encoder.py:13-37)."""
    b, R, _ = visual.shape
    q = question.to(visual.dtype)[:, None, :].expand(b, R, question.shape[-1])
    q = torch.where(roi_mask[..., None], q, torch.zeros_like(q))
    return torch.cat([visual, q], dim=-1)


class GAttNet(nn.Module):
    """`self_weights` FCNet, one GraphSelfAttention per direction
    (`neighbor`) and, for explicit relations (`label_num` > 0), the
    edge-label bias FCNet `bias` [label_num -> 1], with a `b` only when
    `label_bias`."""

    def __init__(
        self, dir_num: int, in_feat_dim: int, out_feat_dim: int, num_heads: int,
        pos_emb_dim: int, generator: torch.Generator, drop_rate: float = 0.0,
        label_num: int = 0, label_bias: bool = True, dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if dir_num > 2:
            raise ValueError("Got more than two directions in a graph.")
        self.self_weights = FCNet(
            [in_feat_dim, out_feat_dim], generator, activation=None, drop_rate=drop_rate,
            dtype=dtype,
        )
        self.neighbor = nn.ModuleList(
            GraphSelfAttention(out_feat_dim, num_heads, pos_emb_dim, generator, drop_rate,
                               dtype)
            for _ in range(dir_num)
        )
        # The reference pins the label FC's dropout at 0.2 apart from
        # --dropout; 0 turns it off with the rest (relation.py:98-103).
        self.bias = (
            FCNet([label_num, 1], generator, activation=None,
                  drop_rate=0.2 if drop_rate > 0 else 0.0, use_bias=label_bias, dtype=dtype)
            if label_num > 0 else None
        )
        self.drop_rate = drop_rate

    def forward(
        self,
        v_feat: torch.Tensor,  # [b, R, in_feat_dim]
        key_mask: torch.Tensor,  # [b, n] bool
        generator: Optional[torch.Generator] = None,
        pos_mat: Optional[torch.Tensor] = None,  # [b, R, n, 4] (implicit)
        adj_onehot: Optional[torch.Tensor] = None,  # [b, R, R, L] (explicit)
    ) -> torch.Tensor:
        self_feat = self.self_weights(v_feat, generator)
        n = key_mask.shape[1]
        output = self_feat
        for d, direction in enumerate(self.neighbor):
            adj_mask = label_bias = None
            if adj_onehot is not None:
                adj = adj_onehot if d == 0 else adj_onehot.transpose(1, 2)
                input_adj = adj[:, :, :n]  # [b, R, n, L]
                adj_mask = input_adj.sum(dim=-1)
                label_bias = self.bias(input_adj, generator)[..., 0]
            output = output + direction(
                self_feat, pos_mat, key_mask, generator, adj_mask, label_bias
            )
        output = dropout(output, self.drop_rate, self.training, generator)
        return torch.relu(output)


class ImplicitRelationEncoder(nn.Module):
    """`gatt` and, when v_dim != out_dim, the relu `v2out` FCNet."""

    def __init__(
        self, v_dim: int, q_dim: int, out_dim: int, dir_num: int,
        pos_emb_dim: int, num_heads: int, num_steps: int,
        residual_connection: bool, generator: torch.Generator,
        drop_rate: float = 0.0, dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.gatt = GAttNet(
            dir_num, out_dim + q_dim, out_dim, num_heads, pos_emb_dim, generator,
            drop_rate, dtype=dtype,
        )
        self.v2out = (
            FCNet([v_dim, out_dim], generator, drop_rate=drop_rate, dtype=dtype)
            if v_dim != out_dim else None
        )
        self.num_steps = num_steps
        self.residual_connection = residual_connection

    def forward(
        self,
        visual: torch.Tensor,  # [b, R, v_dim]
        pos_mat: torch.Tensor,  # [b, R, n, 4]
        question: torch.Tensor,  # [b, q_dim]
        roi_mask: torch.Tensor,  # [b, R] bool
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if self.v2out is not None:
            visual = self.v2out(visual, generator)
        key_mask = roi_mask[:, : pos_mat.shape[2]]
        for _ in range(self.num_steps):
            rel = self.gatt(
                concat_visual_question(question, visual, roi_mask), key_mask, generator,
                pos_mat=pos_mat,
            )
            visual = visual + rel if self.residual_connection else rel
        return visual


class ExplicitRelationEncoder(nn.Module):
    """`gatt` with the edge-label bias net and, when v_dim != out_dim, the
    relu `v2out` FCNet (no dropout)."""

    def __init__(
        self, v_dim: int, q_dim: int, out_dim: int, dir_num: int, label_num: int,
        num_heads: int, num_steps: int, nongt_dim: int, residual_connection: bool,
        label_bias: bool, generator: torch.Generator, drop_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.gatt = GAttNet(
            dir_num, out_dim + q_dim, out_dim, num_heads, -1, generator, drop_rate,
            label_num, label_bias, dtype,
        )
        self.v2out = (
            FCNet([v_dim, out_dim], generator, dtype=dtype) if v_dim != out_dim else None
        )
        self.num_steps = num_steps
        self.nongt_dim = nongt_dim
        self.residual_connection = residual_connection

    def forward(
        self,
        visual: torch.Tensor,  # [b, R, v_dim]
        adj_onehot: torch.Tensor,  # [b, R, R, label_num]
        question: torch.Tensor,  # [b, q_dim]
        roi_mask: torch.Tensor,  # [b, R] bool
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if self.v2out is not None:
            visual = self.v2out(visual, generator)
        key_mask = roi_mask[:, : min(self.nongt_dim, roi_mask.shape[1])]
        for _ in range(self.num_steps):
            rel = self.gatt(
                concat_visual_question(question, visual, roi_mask), key_mask, generator,
                adj_onehot=adj_onehot,
            )
            visual = visual + rel if self.residual_connection else rel
        return visual
