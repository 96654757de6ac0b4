"""BUTD fusion (counterpart of the BUTD half of
tf_vqa_regat_tpu/models/fusion.py).

Every FullyConnected inside BUTD is a plain weight-normed linear with no
activation and no dropout (a reference quirk the JAX package keeps on
purpose); the one dropout, in training, is on the attention product. The
softmax over rois masks padded rois at -1e9 and runs in f32. Under a bf16
`dtype` the FCNets store bf16, the attention logits are widened to f32, the
weighted sum of the visual rows takes their dtype (f32 from the relation
encoder) and the joint embedding is bf16 (fusion.py:50-69).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tf_vqa_regat_tpu_torch.nn import dropout
from tf_vqa_regat_tpu_torch.ops.weight_norm import FCNet


class BUTD(nn.Module):
    def __init__(
        self, v_dim: int, q_dim: int, hidden_dim: int, generator: torch.Generator,
        drop_rate: float = 0.0, dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.drop_rate = drop_rate

        def lin(i, o):
            return FCNet([i, o], generator, activation=None, dtype=dtype)

        self.v2attention = lin(v_dim, hidden_dim)
        self.q2attention = lin(q_dim, hidden_dim)
        self.linear = lin(hidden_dim, 1)
        self.visual_embed = lin(v_dim, hidden_dim)
        self.question_embed = lin(q_dim, hidden_dim)

    def forward(
        self,
        visual: torch.Tensor,  # [b, R, v_dim]
        question: torch.Tensor,  # [b, q_dim]
        roi_mask: torch.Tensor,  # [b, R] bool
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:  # joint embedding [b, hidden]
        joint = self.v2attention(visual) * self.q2attention(question)[:, None, :]
        joint = dropout(joint, self.drop_rate, self.training, generator)
        logits = self.linear(joint).float()  # [b, R, 1]
        logits = torch.where(
            roi_mask[..., None], logits, torch.full_like(logits, -1e9)
        )
        weights = torch.softmax(logits, dim=1)
        weighted_visual = torch.sum(weights * visual, dim=1)
        return self.visual_embed(weighted_visual) * self.question_embed(question)
