"""The ReGAT network for implicit relations with BUTD fusion (counterpart of
tf_vqa_regat_tpu/models/regat.py: `init_regat` + `apply_regat`).

Submodules carry the names of the JAX parameter pytree, so state-dict keys
are the pytree paths with '/' written as '.' (params.py). The same forward
pass serves, evaluates and trains: in `.train()` mode it draws every dropout
mask from the generator it is given (the step's, nn.step_generator).

Dropout rates follow the reference topology (regat.py:132-145): the config's
`dropout` reaches the language stack and the classifier; the relation
encoder and BUTD take the graph rate, 0.2 whenever `dropout` > 0 and 0
otherwise, so `--dropout 0` turns every dropout off.

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
        drop = cfg.dropout
        graph_drop = 0.2 if drop > 0 else 0.0
        self.w_emb = WordEmbedding(ntoken, 300, cfg.op, g, drop)
        self.q_emb = QuestionEmbedding(cfg.word_dim, cfg.num_hid, g)
        self.q_att = QuestionSelfAttention(cfg.num_hid, g, drop)
        self.v_relation = ImplicitRelationEncoder(
            v_dim, cfg.num_hid, cfg.relation_dim, cfg.dir_num,
            cfg.imp_pos_emb_dim, cfg.num_heads, cfg.num_steps,
            cfg.residual_connection, g, graph_drop,
        )
        self.joint_emb = BUTD(cfg.relation_dim, cfg.num_hid, cfg.num_hid, g, graph_drop)
        self.classifier = Classifier(cfg.num_hid, cfg.num_hid * 2, num_ans, g, drop)

    def forward(
        self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """-> answer logits [b, num_answers], f32. In `.train()` mode with a
        dropout rate > 0, `generator` (on the batch's device) draws the masks."""
        features = batch["features"]
        R = features.shape[1]
        roi_mask = (
            torch.arange(R, device=features.device)[None, :]
            < batch["num_boxes"][:, None]
        )
        w_emb = self.w_emb(batch["question"], self.padding_idx, generator)
        q_seq, q_last = self.q_emb(w_emb)
        q_vec = self.q_att(q_seq, generator)
        pos_mat = position_matrix(batch["bb"], self.nongt_dim)
        v_emb = self.v_relation(features, pos_mat, q_vec, roi_mask, generator)
        joint = self.joint_emb(v_emb, q_last, roi_mask, generator)
        return self.classifier(joint, generator)


def trainable_mask(model: ReGAT, emb2_trainable: bool) -> Dict[str, bool]:
    """Parameter name -> whether it takes optimizer updates: the JAX
    `trainable_mask` (regat.py:246-283). Frozen are the second word-embedding
    table (until a TF-IDF init, not ported, unfreezes it) and the biases that
    feed a softmax directly, whose true gradient is zero: q_att's scoring
    bias, each direction's key bias and BUTD's attention bias."""
    frozen = {
        "q_att.linear2.layers.%d.b" % (len(model.q_att.linear2.layers) - 1),
        "joint_emb.linear.layers.%d.b" % (len(model.joint_emb.linear.layers) - 1),
    }
    for i, direction in enumerate(model.v_relation.gatt.neighbor):
        frozen.add(
            "v_relation.gatt.neighbor.%d.key.layers.%d.b" % (i, len(direction.key.layers) - 1)
        )
    mask = {}
    for name, _ in model.named_parameters():
        emb2 = name.startswith("w_emb.emb_.") and not emb2_trainable
        mask[name] = not (emb2 or name in frozen)
    return mask
