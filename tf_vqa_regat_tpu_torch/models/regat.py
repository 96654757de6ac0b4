"""The ReGAT network for implicit relations with BUTD fusion (counterpart of
tf_vqa_regat_tpu/models/regat.py: `init_regat` + `apply_regat`).

Submodules carry the names of the JAX parameter pytree, so state-dict keys
are the pytree paths with '/' written as '.' (params.py). The forward pass is
the eval path: this slice serves; training is ROADMAP Queue A item 2.

The batch is a dict of tensors on the model's device:
  features  [b, R, v_dim] float32   region features
  bb        [b, R, 4]     float32   raw boxes
  question  [b, 14]       int       token ids (pad = ntoken)
  num_boxes [b]           int       valid roi count per example
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.models.classifier import Classifier
from tf_vqa_regat_tpu_torch.models.fusion import BUTD
from tf_vqa_regat_tpu_torch.models.language import (
    QuestionEmbedding,
    QuestionSelfAttention,
    WordEmbedding,
)
from tf_vqa_regat_tpu_torch.models.relation import ImplicitRelationEncoder
from tf_vqa_regat_tpu_torch.ops.position import position_matrix


def check_supported(cfg: Config) -> None:
    """Raise for a family outside this slice, naming the ROADMAP item that
    ports it. (Flags of features not ported at all, such as bf16, are not in
    the port's Config: the parser rejects them.)"""
    unsupported = {
        "relation_type": (cfg.relation_type != "implicit",
                          "ROADMAP Queue A item 4, explicit relations"),
        "fusion": (cfg.fusion != "butd", "ROADMAP Queue A item 5, BAN and MuTAN"),
    }
    for flag, (bad, item) in unsupported.items():
        if bad:
            raise NotImplementedError(
                f"--{flag} {getattr(cfg, flag)!r} is not ported yet ({item})"
            )


class ReGAT(nn.Module):
    def __init__(
        self, cfg: Config, ntoken: int, v_dim: int, num_ans: int,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        check_supported(cfg)
        g = generator if generator is not None else torch.Generator().manual_seed(cfg.seed)
        self.padding_idx = ntoken
        self.nongt_dim = cfg.nongt_dim
        self.w_emb = WordEmbedding(ntoken, 300, cfg.op, g)
        self.q_emb = QuestionEmbedding(cfg.word_dim, cfg.num_hid, g)
        self.q_att = QuestionSelfAttention(cfg.num_hid, g)
        self.v_relation = ImplicitRelationEncoder(
            v_dim, cfg.num_hid, cfg.relation_dim, cfg.dir_num,
            cfg.imp_pos_emb_dim, cfg.num_heads, cfg.num_steps,
            cfg.residual_connection, g,
        )
        self.joint_emb = BUTD(cfg.relation_dim, cfg.num_hid, cfg.num_hid, g)
        self.classifier = Classifier(cfg.num_hid, cfg.num_hid * 2, num_ans, g)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """-> answer logits [b, num_answers], f32."""
        if self.training:
            raise NotImplementedError(
                "training is not ported yet (ROADMAP Queue A item 2); call .eval()"
            )
        features = batch["features"]
        R = features.shape[1]
        roi_mask = (
            torch.arange(R, device=features.device)[None, :]
            < batch["num_boxes"][:, None]
        )
        w_emb = self.w_emb(batch["question"], self.padding_idx)
        q_seq, q_last = self.q_emb(w_emb)
        q_vec = self.q_att(q_seq)
        pos_mat = position_matrix(batch["bb"], self.nongt_dim)
        v_emb = self.v_relation(features, pos_mat, q_vec, roi_mask)
        joint = self.joint_emb(v_emb, q_last, roi_mask)
        return self.classifier(joint)
