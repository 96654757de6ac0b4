"""Answer classifier (counterpart of tf_vqa_regat_tpu/models/classifier.py):
WN-Dense(in -> hid) -> relu -> (train-only dropout) -> WN-Dense(-> answers),
f32 logits: under a bf16 `dtype` the hidden layer is bf16 and the answer
layer's product comes out unrounded in f32 (classifier.py:37)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tf_vqa_regat_tpu_torch.nn import dropout
from tf_vqa_regat_tpu_torch.ops.weight_norm import WNLinear


class Classifier(nn.Module):
    def __init__(
        self, in_dim: int, hid_dim: int, out_dim: int, generator: torch.Generator,
        drop_rate: float = 0.0, dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.fc1 = WNLinear(in_dim, hid_dim, generator, dtype=dtype)
        self.fc2 = WNLinear(hid_dim, out_dim, generator, dtype=dtype)
        self.drop_rate = drop_rate

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        x = dropout(torch.relu(self.fc1(x)), self.drop_rate, self.training, generator)
        return self.fc2(x, out_dtype=torch.float32)
