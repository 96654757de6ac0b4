"""The ReGAT network: implicit, spatial or semantic relations, then BUTD,
BAN or MuTAN fusion (counterpart of tf_vqa_regat_tpu/models/regat.py:
`init_regat` + `apply_regat` with impl="pallas").

Submodules carry the names of the JAX parameter pytree, so state-dict keys
are the pytree paths with '/' written as '.' (params.py). The same forward
pass serves, evaluates and trains: in `.train()` mode it draws every dropout
mask from the generator it is given (the step's, nn.step_generator).

Dropout rates follow the reference topology (regat.py:132-145): the config's
`dropout` reaches the language stack and the classifier; the relation
encoder and BUTD take the graph rate, 0.2 whenever `dropout` > 0 and 0
otherwise, so `--dropout 0` turns every dropout off. BAN takes `dropout`
itself and MuTAN its input rate (models/ban.py, models/mutan.py).

BUTD and MuTAN take the GRU's last state, BAN its whole sequence. MuTAN
scores the answers itself, so a MuTAN model has no `classifier`.

`--compute_dtype bfloat16` (every fusion) casts where the JAX package casts
(regat.py:132-242, models/ban.py, models/mutan.py), with explicit `.to()`
in each module, not torch.autocast, whose per-op list is not JAX's: bf16
matmuls and stored activations; f32 parameters, softmax statistics, GRU
state, kernel inputs and outputs, and answer logits.

The batch is a dict of tensors on the model's device:
  features  [b, R, v_dim] float32   region features
  bb        [b, R, 4]     float32   raw boxes
  question  [b, 14]       int       token ids (pad = ntoken)
  num_boxes [b]           int       valid roi count per example
  norm_bb   [b, R, 6]     float32   normalised boxes (spatial, without adj_label)
  adj_label [b, R, R]     int       edge labels (semantic; spatial builds its
                                    own from the boxes when it is absent)

Tensor parallelism: a model built with `tp` (parallel/mesh.py's
`Mesh.tensor_parallel`, tp > 1) is the one-device model of the same seed
with each split leaf cut to this rank's part (parallel/mesh.py::shard_axis;
ops/graph_attention.py, models/classifier.py); without it, it is the
one-device model exactly. params.py carries full arrays in and out.

The reference-quirk switches (JAX regat.py:172-197): `--ref_compat_q_att`
gives q_att the batch-axis softmax (models/language.py), over the global
batch when the model is built with `data`, the data axis of a dp > 1 mesh
(`Mesh.data_axis`; a model whose every rank runs the whole batch, as
serve's, is built without it); `--ref_compat_pos` feeds the implicit
relation ops/position.py::position_matrix_ref_compat, for every fusion.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.models.ban import BAN
from tf_vqa_regat_tpu_torch.models.classifier import Classifier
from tf_vqa_regat_tpu_torch.models.fusion import BUTD
from tf_vqa_regat_tpu_torch.models.language import (
    QuestionEmbedding,
    QuestionSelfAttention,
    WordEmbedding,
)
from tf_vqa_regat_tpu_torch.models.mutan import MuTAN
from tf_vqa_regat_tpu_torch.models.relation import (
    ExplicitRelationEncoder,
    ImplicitRelationEncoder,
)
from tf_vqa_regat_tpu_torch.nn import DTYPES
from tf_vqa_regat_tpu_torch.ops.position import position_matrix, position_matrix_ref_compat
from tf_vqa_regat_tpu_torch.ops.spatial_graph import (
    broadcast_adj_labels,
    build_spatial_graph,
)
from tf_vqa_regat_tpu_torch.parallel.tensor import TensorParallel

RELATION_TYPES = ("implicit", "spatial", "semantic")
FUSIONS = ("butd", "ban", "mutan")


def check_supported(cfg: Config) -> None:
    """Raise for an unknown relation type or fusion. (The port's Config
    lacks only the JAX flags `--prng_impl`, `--sp_rois` and `--use_pallas`,
    which name TPU or JAX machinery: the parser rejects them.)"""
    if cfg.relation_type not in RELATION_TYPES:
        raise ValueError(f"unknown relation_type {cfg.relation_type!r}")
    if cfg.fusion not in FUSIONS:
        raise ValueError(f"unknown fusion {cfg.fusion!r}")


class ReGAT(nn.Module):
    def __init__(
        self, cfg: Config, ntoken: int, v_dim: int, num_ans: int,
        generator: Optional[torch.Generator] = None,
        tp: Optional[TensorParallel] = None,
        data: Optional[TensorParallel] = None,
    ):
        super().__init__()
        check_supported(cfg)
        g = generator if generator is not None else torch.Generator().manual_seed(cfg.seed)
        self.padding_idx = ntoken
        self.nongt_dim = cfg.nongt_dim
        self.ref_compat_pos = cfg.ref_compat_pos
        self.relation_type = cfg.relation_type
        drop = cfg.dropout
        graph_drop = 0.2 if drop > 0 else 0.0
        cd = DTYPES[cfg.compute_dtype]
        self.w_emb = WordEmbedding(ntoken, 300, cfg.op, g, drop, cd)
        self.q_emb = QuestionEmbedding(cfg.word_dim, cfg.num_hid, g, cd)
        self.q_att = QuestionSelfAttention(cfg.num_hid, g, drop, cd, cfg.ref_compat_q_att)
        self.q_att.data = data if cfg.ref_compat_q_att else None
        if cfg.relation_type == "implicit":
            self.v_relation = ImplicitRelationEncoder(
                v_dim, cfg.num_hid, cfg.relation_dim, cfg.dir_num,
                cfg.imp_pos_emb_dim, cfg.num_heads, cfg.num_steps,
                cfg.residual_connection, g, graph_drop, cd,
            )
        else:
            self.label_num = (
                cfg.spa_label_num if cfg.relation_type == "spatial" else cfg.sem_label_num
            )
            self.v_relation = ExplicitRelationEncoder(
                v_dim, cfg.num_hid, cfg.relation_dim, cfg.dir_num, self.label_num,
                cfg.num_heads, cfg.num_steps, cfg.nongt_dim, cfg.residual_connection,
                cfg.label_bias, g, graph_drop, cd,
            )
        self.fusion = cfg.fusion
        if cfg.fusion == "butd":
            self.joint_emb = BUTD(cfg.relation_dim, cfg.num_hid, cfg.num_hid, g, graph_drop, cd)
        elif cfg.fusion == "ban":
            self.joint_emb = BAN(cfg.relation_dim, cfg.num_hid, cfg.ban_glimpse, g, drop, cd)
        else:
            self.joint_emb = MuTAN(
                cfg.relation_dim, cfg.num_hid, num_ans, cfg.mutan_rank, cfg.mutan_gamma,
                g, drop, cfg.mutan_shared_qdrop, cd,
            )
        self.classifier = (
            None if cfg.fusion == "mutan"
            else Classifier(cfg.num_hid, cfg.num_hid * 2, num_ans, g, drop, cd)
        )
        self.tp = tp
        if tp is not None:
            for direction in self.v_relation.gatt.neighbor:
                direction.shard_(tp)
            if self.classifier is not None:
                self.classifier.shard_(tp)

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
        if self.relation_type == "implicit":
            position = position_matrix_ref_compat if self.ref_compat_pos else position_matrix
            pos_mat = position(batch["bb"], self.nongt_dim)
            v_emb = self.v_relation(features, pos_mat, q_vec, roi_mask, generator)
        else:
            adj_label = batch.get("adj_label")
            if adj_label is None:
                if self.relation_type != "spatial":
                    raise ValueError("semantic relation requires adj_label in the batch")
                # spatial edges are a function of the boxes: built in the step
                adj_label = build_spatial_graph(batch["bb"], batch["norm_bb"])
            adj = broadcast_adj_labels(adj_label, self.label_num)
            v_emb = self.v_relation(features, adj, q_vec, roi_mask, generator)
        if self.fusion == "mutan":
            logits, _ = self.joint_emb(v_emb, q_last, roi_mask, generator)
            return logits
        if self.fusion == "ban":
            joint, _ = self.joint_emb(v_emb, q_seq, roi_mask, generator)
        else:
            joint = self.joint_emb(v_emb, q_last, roi_mask, generator)
        return self.classifier(joint, generator)


def trainable_mask(model: ReGAT, emb2_trainable: bool) -> Dict[str, bool]:
    """Parameter name -> whether it takes optimizer updates: the JAX
    `trainable_mask` (regat.py:246-283). Frozen are the second word-embedding
    table (until a TF-IDF init unfreezes it, models/language.py::
    word_embedding_load_glove) and the biases that
    feed a softmax directly, whose true gradient is zero: q_att's scoring
    bias, each direction's key bias, and the fusion's attention bias (BUTD's
    scoring bias, BAN's `h_bias`, MuTAN's glimpse-scoring bias). The explicit
    edge-label FC's bias (`v_relation.gatt.bias.layers.0.b`) also has a true
    gradient of zero (it shifts every edge key alike) but stays trainable,
    as JAX leaves it."""
    def last_bias(prefix: str, fc) -> str:
        return "%s.layers.%d.b" % (prefix, len(fc.layers) - 1)

    joint = model.joint_emb
    if model.fusion == "butd":
        attention_bias = last_bias("joint_emb.linear", joint.linear)
    elif model.fusion == "ban":
        attention_bias = "joint_emb.h_bias"
    else:
        attention_bias = last_bias("joint_emb.att_linear1", joint.att_linear1)
    frozen = {last_bias("q_att.linear2", model.q_att.linear2), attention_bias}
    for i, direction in enumerate(model.v_relation.gatt.neighbor):
        frozen.add(last_bias("v_relation.gatt.neighbor.%d.key" % i, direction.key))
    mask = {}
    for name, _ in model.named_parameters():
        emb2 = name.startswith("w_emb.emb_.") and not emb2_trainable
        mask[name] = not (emb2 or name in frozen)
    return mask
