"""Answer classifier (counterpart of tf_vqa_regat_tpu/models/classifier.py):
WN-Dense(in -> hid) -> relu -> (train-only dropout) -> WN-Dense(-> answers),
f32 logits: under a bf16 `dtype` the hidden layer is bf16 and the answer
layer's product comes out unrounded in f32 (classifier.py:37).

Tensor parallelism (`shard_`, JAX `param_shardings` at tp > 1): the hidden
layer is split on its columns (kernel and bias), then relu; the hidden
dropout mask is drawn at the full width and sliced to the rank's columns,
so tp ranks draw what one rank draws; the answer layer is split on its
rows, its partial logits summed over the model group before `fc2/b` is
added once."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tf_vqa_regat_tpu_torch.nn import dropout
from tf_vqa_regat_tpu_torch.ops.weight_norm import WNLinear
from tf_vqa_regat_tpu_torch.parallel.tensor import TensorParallel, copy_to


class Classifier(nn.Module):
    def __init__(
        self, in_dim: int, hid_dim: int, out_dim: int, generator: torch.Generator,
        drop_rate: float = 0.0, dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.fc1 = WNLinear(in_dim, hid_dim, generator, dtype=dtype)
        self.fc2 = WNLinear(hid_dim, out_dim, generator, dtype=dtype)
        self.drop_rate = drop_rate
        self.tp: Optional[TensorParallel] = None

    def shard_(self, tp: TensorParallel) -> None:
        self.tp = tp
        self.fc1.shard_(tp, "cols", split_bias=True)
        self.fc2.shard_(tp, "rows")

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        tp = self.tp
        if tp is not None:
            x = copy_to(x, tp)
        x = dropout(torch.relu(self.fc1(x)), self.drop_rate, self.training, generator,
                    None if tp is None else (tp.index, tp.size))
        return self.fc2(x, out_dtype=torch.float32)
