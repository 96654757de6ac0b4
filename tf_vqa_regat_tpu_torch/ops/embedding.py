"""Masked token embedding (counterpart of tf_vqa_regat_tpu/ops/embedding.py).

Rows where the token equals `padding_idx` are zeroed at run time, whatever
the table's pad row holds."""

from __future__ import annotations

import torch
from torch import nn

from tf_vqa_regat_tpu_torch.nn import normal


class Embedding(nn.Module):
    """Parameter `table` [num_embeddings, dim]."""

    def __init__(self, num_embeddings: int, dim: int, generator: torch.Generator):
        super().__init__()
        self.table = nn.Parameter(normal((num_embeddings, dim), generator))

    def forward(self, ids: torch.Tensor, padding_idx: int) -> torch.Tensor:
        emb = self.table[ids.long()]
        return torch.where((ids != padding_idx)[..., None], emb, torch.zeros_like(emb))
