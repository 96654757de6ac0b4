"""Masked token embedding (counterpart of tf_vqa_regat_tpu/ops/embedding.py).

Rows where the token equals `padding_idx` are zeroed at run time, whatever
the table's pad row holds.

The lookup is the one whose backward sums each row's gradient in a fixed
order on the tensor's device, so that a resumed run equals an uninterrupted
one: `F.embedding` on the CPU, where the backward of advanced indexing
(`index_put_` with accumulate) varies from call to call, and advanced
indexing on the GPU, where `F.embedding`'s backward varies (both measured
on an H100 with torch 2.11: tests/test_torch_checkpoint.py holds the CPU,
chip_smoke.py phase 11 the card).

Under a bf16 `dtype` the table is cast before the lookup, as JAX casts it."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tf_vqa_regat_tpu_torch.nn import normal


class Embedding(nn.Module):
    """Parameter `table` [num_embeddings, dim]."""

    def __init__(
        self, num_embeddings: int, dim: int, generator: torch.Generator,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.table = nn.Parameter(normal((num_embeddings, dim), generator))
        self.dtype = dtype

    def forward(self, ids: torch.Tensor, padding_idx: int) -> torch.Tensor:
        ids = ids.long()
        table = self.table.to(self.dtype)
        emb = F.embedding(ids, table) if ids.device.type == "cpu" else table[ids]
        return torch.where((ids != padding_idx)[..., None], emb, torch.zeros_like(emb))
