"""BUTD fusion (Anderson et al., arXiv:1707.07998, as ReGAT's `joint_emb`)
and the two-layer classifier after it: an attention over the rois scored
from the relation encoder's output and the question's last GRU state, the
pooled roi and that state each embedded to num_hid and multiplied, then
fc1 (2 num_hid, ReLU, dropout) and fc2 (the answers)."""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..params import Leaf, dense
from ..regat import drop

# the scoring bias feeds the roi softmax directly: its gradient is nought
FROZEN = ("joint_emb.linear.layers.0.b",)


def params(cfg: dict) -> List[Leaf]:
    h, rel = int(cfg["num_hid"]), int(cfg["relation_dim"])
    return (dense("joint_emb.v2attention.layers.0", rel, h)
            + dense("joint_emb.q2attention.layers.0", h, h)
            + dense("joint_emb.linear.layers.0", h, 1)
            + dense("joint_emb.visual_embed.layers.0", rel, h)
            + dense("joint_emb.question_embed.layers.0", h, h)
            + dense("classifier.fc1", h, 2 * h)
            + dense("classifier.fc2", 2 * h, int(cfg["num_ans"])))


def question(seq: torch.Tensor) -> torch.Tensor:
    """The last GRU state [b, num_hid]."""
    return seq[:, -1]


def logits(model, visual: torch.Tensor, q: torch.Tensor, roi_mask: torch.Tensor,
           gen) -> torch.Tensor:
    """Dropout masks: the joint (graph rate), then the classifier's hidden
    layer."""
    j = model.dense("joint_emb.v2attention.layers.0", visual) * \
        model.dense("joint_emb.q2attention.layers.0", q)[:, None, :]
    j = drop(j, model.graph_drop, gen)
    scores = model.dense("joint_emb.linear.layers.0", j)
    scores = torch.where(roi_mask[..., None], scores, -1e9)
    w = torch.softmax(scores, dim=1)
    pooled = torch.sum(w * visual, dim=1)
    x = model.dense("joint_emb.visual_embed.layers.0", pooled) * \
        model.dense("joint_emb.question_embed.layers.0", q)
    hidden = drop(torch.relu(model.dense("classifier.fc1", x)), model.drop, gen)
    return model.dense("classifier.fc2", hidden)


def matmuls(cfg: dict) -> List[Tuple[str, float, bool]]:
    h, rel = int(cfg["num_hid"]), int(cfg["relation_dim"])
    R, A = int(cfg["max_boxes"]), int(cfg["num_ans"])
    return [
        ("butd v2attention", 2.0 * R * rel * h, True),
        ("butd q2attention", 2.0 * h * h, True),
        ("butd linear", 2.0 * R * h, True),
        ("butd pooling", 2.0 * R * rel, True),
        ("butd visual_embed", 2.0 * rel * h, True),
        ("butd question_embed", 2.0 * h * h, True),
        ("classifier fc1", 2.0 * h * 2 * h, True),
        ("classifier fc2", 2.0 * 2 * h * A, True),
    ]
