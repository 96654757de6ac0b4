"""Implicit relation encoder (counterpart of the implicit half of
tf_vqa_regat_tpu/models/relation.py).

The implicit graph is fully connected, so there is no label-bias net (a
bias constant across keys is a softmax no-op). Both directions attend over
the same inputs with their own weights, each through the fused kernel, and
their outputs are summed on top of `self_feat`, then relu.

In training every dropout of the encoder runs at its one `drop_rate` (the
model's graph rate: 0.2, or 0 when the config's `dropout` is 0): before
`v2out` and `self_weights`, inside each direction, and on the summed output
before the relu (relation.py:85-86, :159, :221-229). The reference pins
`v2out`'s rate at 0.2 apart from `--dropout`; the graph rate is that same
0.2 whenever dropout is on.
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
    q = question[:, None, :].expand(b, R, question.shape[-1])
    q = torch.where(roi_mask[..., None], q, torch.zeros_like(q))
    return torch.cat([visual, q], dim=-1)


class GAttNet(nn.Module):
    """`self_weights` FCNet and one GraphSelfAttention per direction
    (`neighbor`)."""

    def __init__(
        self, dir_num: int, in_feat_dim: int, out_feat_dim: int, num_heads: int,
        pos_emb_dim: int, generator: torch.Generator, drop_rate: float = 0.0,
    ):
        super().__init__()
        if dir_num > 2:
            raise ValueError("Got more than two directions in a graph.")
        self.self_weights = FCNet(
            [in_feat_dim, out_feat_dim], generator, activation=None, drop_rate=drop_rate
        )
        self.neighbor = nn.ModuleList(
            GraphSelfAttention(out_feat_dim, num_heads, pos_emb_dim, generator, drop_rate)
            for _ in range(dir_num)
        )
        self.drop_rate = drop_rate

    def forward(self, v_feat, pos_mat, key_mask, generator=None) -> torch.Tensor:
        self_feat = self.self_weights(v_feat, generator)
        output = self_feat
        for direction in self.neighbor:
            output = output + direction(self_feat, pos_mat, key_mask, generator)
        output = dropout(output, self.drop_rate, self.training, generator)
        return torch.relu(output)


class ImplicitRelationEncoder(nn.Module):
    """`gatt` and, when v_dim != out_dim, the relu `v2out` FCNet."""

    def __init__(
        self, v_dim: int, q_dim: int, out_dim: int, dir_num: int,
        pos_emb_dim: int, num_heads: int, num_steps: int,
        residual_connection: bool, generator: torch.Generator,
        drop_rate: float = 0.0,
    ):
        super().__init__()
        self.gatt = GAttNet(
            dir_num, out_dim + q_dim, out_dim, num_heads, pos_emb_dim, generator,
            drop_rate,
        )
        self.v2out = (
            FCNet([v_dim, out_dim], generator, drop_rate=drop_rate)
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
                concat_visual_question(question, visual, roi_mask), pos_mat, key_mask,
                generator,
            )
            visual = visual + rel if self.residual_connection else rel
        return visual
