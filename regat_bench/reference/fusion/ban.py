"""BAN fusion (Kim et al., "Bilinear Attention Networks", arXiv:1805.07932, as
ReGAT builds it with `ban_gamma` glimpses) and the two-layer classifier
after it.

With v = the relation encoder's output [b, R, relation_dim], q = the GRU's
whole sequence [b, T, h], h = num_hid, K = 3h and g glimpses:

  v_ = drop(relu(v W_av + b_av))               att_v_net, then a second dropout
  q_ = relu(q W_aq + b_aq)                      att_q_net
  logit[b, g, r, t] = sum_k H[g, k] v_[b, r, k] q_[b, t, k] + h_bias[g]
  att[b, g] = softmax over the R*T pairs (r, t) of logit[b, g], padded rois
              at -1e9
  for each glimpse i, in order:
    v1 = relu(v W_bv,i + b)   q1 = relu(q W_bq,i + b)
    pooled[b, k] = sum_{r,t} v1[b, r, k] att[b, i, r, t] q1[b, t, k]
    q = q + (pooled W_prj,i + b)[:, None, :]      q_prj, no activation
  joint = sum over the tokens of q; then fc1 (2h, ReLU, dropout) and fc2.

Every FCNet layer drops its input at the configuration's `dropout` in
training (BAN has no graph rate). Dropout masks are drawn in this order:
att_v_net's input, its output, att_q_net's input; then per glimpse b_v_net's
input, b_q_net's input, q_prj's input; then the classifier's hidden layer.

Departures from the published BAN, each the system's (the JAX package's
`ban_apply`): H is one weight-normed tensor [g, K] with a single scalar g
over the whole tensor (BAN's `weight_norm(..., dim=None)`); question pad
tokens are not masked; padded rois get -1e9, not -inf, so an example with
no roi attends uniformly; BAN's counting module is left out, as ReGAT
builds BAN without it (`use_counter=False`); the attention's bilinear rank
is BAN's k = 3. The logits are computed as q_ scaled by each glimpse's
row of H, then one product with v_, and the pooling as att @ q1, then
times v1 summed over the rois (any order is the same sum; this one has no
[b, g, R, K] intermediate). Initial ranges: H uniform in +-sqrt(3), the
spread of the published N(0, 1); h_bias the same, which the softmax over
each glimpse's pairs cancels: its gradient is nought (FROZEN).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from ..params import Leaf, dense
from ..regat import drop

K = 3  # the bilinear rank multiplier of the attention
FROZEN = ("joint_emb.h_bias",)


def params(cfg: dict) -> List[Leaf]:
    """In the program's parameter order: the module's own `h_bias`, then its
    submodules as it registers them."""
    h, rel, g = int(cfg["num_hid"]), int(cfg["relation_dim"]), int(cfg["ban_glimpse"])
    out: List[Leaf] = [("joint_emb.h_bias", (g,), "uniform", math.sqrt(3.0))]
    out += dense("joint_emb.att_v_net.layers.0", rel, K * h)
    out += dense("joint_emb.att_q_net.layers.0", h, K * h)
    out += [("joint_emb.h_mat.v", (g, K * h), "uniform", math.sqrt(3.0)),
            ("joint_emb.h_mat.g", (), "norm", 0.0)]
    for net, i_dim in (("b_v_net", rel), ("b_q_net", h), ("q_prj", h)):
        for i in range(g):
            out += dense(f"joint_emb.{net}.{i}.layers.0", i_dim, h)
    return (out + dense("classifier.fc1", h, 2 * h)
            + dense("classifier.fc2", 2 * h, int(cfg["num_ans"])))


def question(seq: torch.Tensor) -> torch.Tensor:
    """The whole GRU sequence [b, T, num_hid]."""
    return seq


def logits(model, visual: torch.Tensor, q: torch.Tensor, roi_mask: torch.Tensor,
           gen) -> torch.Tensor:
    b, R, _ = visual.shape
    T = q.shape[1]
    rate = model.drop
    v_ = torch.relu(model.dense("joint_emb.att_v_net.layers.0", drop(visual, rate, gen)))
    v_ = drop(v_, rate, gen)
    q_ = torch.relu(model.dense("joint_emb.att_q_net.layers.0", drop(q, rate, gen)))
    H = model.wn("joint_emb.h_mat")
    g = H.shape[0]
    qh = H[None, :, None, :] * q_[:, None]  # [b, g, T, K]
    logit = model.nx.ein("brk,bgtk->bgrt", v_, qh) + model.p["joint_emb.h_bias"][:, None, None]
    logit = torch.where(roi_mask[:, None, :, None], logit, -1e9)
    att = torch.softmax(logit.reshape(b, g, R * T), dim=-1).reshape(b, g, R, T)
    for i in range(g):
        v1 = torch.relu(model.dense(f"joint_emb.b_v_net.{i}.layers.0", drop(visual, rate, gen)))
        q1 = torch.relu(model.dense(f"joint_emb.b_q_net.{i}.layers.0", drop(q, rate, gen)))
        pooled = model.nx.ein("brk,brk->bk", v1, model.nx.ein("brt,btk->brk", att[:, i], q1))
        q = q + model.dense(f"joint_emb.q_prj.{i}.layers.0", drop(pooled, rate, gen))[:, None]
    joint = q.sum(dim=1)
    hidden = drop(torch.relu(model.dense("classifier.fc1", joint)), rate, gen)
    return model.dense("classifier.fc2", hidden)


def matmuls(cfg: dict) -> List[Tuple[str, float, bool]]:
    """At the least work the equations need, whatever order a program takes:
    the logits as H scaling q_ (2 g T K) and the product with v_ (2 g R T
    K), no [b, g, R, K] intermediate; each glimpse's pooling as att @ q1 (2
    R T h) and the sum over the rois (2 R h)."""
    h, rel, g = int(cfg["num_hid"]), int(cfg["relation_dim"]), int(cfg["ban_glimpse"])
    R, T, A = int(cfg["max_boxes"]), int(cfg["max_q_len"]), int(cfg["num_ans"])
    out = [
        ("ban att_v_net", 2.0 * R * rel * K * h, True),
        ("ban att_q_net", 2.0 * T * h * K * h, True),
        ("ban h_mat x q_", 2.0 * g * T * K * h, True),
        ("ban logits", 2.0 * g * R * T * K * h, True),
    ]
    for i in range(g):
        out += [
            (f"ban glimpse{i} b_v_net", 2.0 * R * rel * h, True),
            (f"ban glimpse{i} b_q_net", 2.0 * T * h * h, True),
            (f"ban glimpse{i} att x q1", 2.0 * R * T * h, True),
            (f"ban glimpse{i} v1 pooling", 2.0 * R * h, True),
            (f"ban glimpse{i} q_prj", 2.0 * h * h, True),
        ]
    return out + [
        ("classifier fc1", 2.0 * h * 2 * h, True),
        ("classifier fc2", 2.0 * 2 * h * A, True),
    ]
