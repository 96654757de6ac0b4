"""Language stack: word embedding, GRU question encoder, question
self-attention (counterpart of tf_vqa_regat_tpu/models/language.py).

The GRU runs once; the sequence feeds the self-attention and the last state
the fusion. In training, dropout at the `drop_rate` given (the config's
`dropout`) follows the word embedding, precedes q_att's first FCNet and
follows the pooled vector (language.py:89, :125, :146). The self-attention softmaxes over the SEQUENCE axis per example
(the PyTorch original's semantics; the TF reference's batch-axis softmax is
the JAX package's `ref_compat_q_att`, not ported).

`word_embedding_load_glove` puts the GloVe rows (and, under --tfidf, the
TF-IDF-mixed rows of the second table, which then trains) into the tables
before training (language.py:43-72).

Under a bf16 `dtype` (language.py:83-143): the word embedding is bf16; the
GRU states are f32; the self-attention's FCNets store bf16, its logits are
widened to f32 for the softmax, and the pooled vector is the f32 product of
the bf16-rounded weights and states.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tf_vqa_regat_tpu_torch.nn import dropout
from tf_vqa_regat_tpu_torch.ops.embedding import Embedding
from tf_vqa_regat_tpu_torch.ops.gru import GRU
from tf_vqa_regat_tpu_torch.ops.weight_norm import FCNet


class WordEmbedding(nn.Module):
    """`emb` [ntoken+1, 300]; with `op` containing 'c' a second table `emb_`
    whose output is concatenated (600-d)."""

    def __init__(
        self, ntoken: int, emb_dim: int, op: str, generator: torch.Generator,
        drop_rate: float = 0.0, dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.emb = Embedding(ntoken + 1, emb_dim, generator, dtype)
        self.emb_ = Embedding(ntoken + 1, emb_dim, generator, dtype) if "c" in op else None
        self.drop_rate = drop_rate

    def forward(
        self, question: torch.Tensor, padding_idx: int,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        emb = self.emb(question, padding_idx)
        if self.emb_ is not None:
            emb = torch.cat([emb, self.emb_(question, padding_idx)], dim=-1)
        return dropout(emb, self.drop_rate, self.training, generator)


@torch.no_grad()
def word_embedding_load_glove(
    w_emb: WordEmbedding,
    glove: np.ndarray,  # [ntoken, 300]
    op: str,
    tfidf: Optional[Any] = None,  # scipy sparse [ntoken, ext_ntoken] or None
    tfidf_weights: Optional[np.ndarray] = None,  # [ext_ntoken - ntoken, 300]
) -> bool:
    """The GloVe init of JAX `word_embedding_load_glove` (reference
    language_model.py:63-90), in place: `emb` gets [glove; zero pad row];
    `emb_`, where `op` has one, gets the same, or with `tfidf` the
    TF-IDF-mixed rows [tfidf @ [glove; tfidf_weights]; pad] and becomes
    trainable. Returns whether `emb_` is trainable."""
    pad = np.zeros((1, glove.shape[1]), np.float32)
    primary = np.concatenate([glove.astype(np.float32), pad], axis=0)
    w_emb.emb.table.copy_(torch.from_numpy(primary))
    if w_emb.emb_ is None:
        return False
    second = primary
    if tfidf is not None:
        ext = np.concatenate([glove.astype(np.float32), tfidf_weights.astype(np.float32)], axis=0)
        second = np.concatenate([np.asarray(tfidf @ ext, dtype=np.float32), pad], axis=0)
    w_emb.emb_.table.copy_(torch.from_numpy(second))
    return tfidf is not None


class QuestionEmbedding(nn.Module):
    def __init__(
        self, in_dim: int, num_hid: int, generator: torch.Generator,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.gru = GRU(in_dim, num_hid, generator, dtype)

    def forward(self, w_emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(all hidden states [b, T, h], last state [b, h])."""
        seq = self.gru(w_emb)
        return seq, seq[:, -1]


class QuestionSelfAttention(nn.Module):
    def __init__(
        self, num_hid: int, generator: torch.Generator, drop_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.linear1 = FCNet(
            [num_hid, num_hid], generator, activation=None, drop_rate=drop_rate, dtype=dtype
        )
        self.linear2 = FCNet([num_hid, 1], generator, activation=None, dtype=dtype)
        self.drop_rate = drop_rate
        self.dtype = dtype

    def forward(
        self, q_seq: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """[b, T, h] -> pooled [b, h]."""
        logits = self.linear2(torch.tanh(self.linear1(q_seq, generator)))[..., 0].float()
        weights = torch.softmax(logits, dim=-1)  # [b, T], f32 statistics
        cd = self.dtype
        pooled = torch.einsum(
            "bt,bth->bh", weights.to(cd).float(), q_seq.to(cd).float()
        )  # f32, as dot_f32
        return dropout(pooled, self.drop_rate, self.training, generator)
