"""The parameter layout of ReGAT (implicit or explicit relations): every
leaf's name, shape and initial range, from a configuration dict; the
fusion's and classifier's leaves come last, from the fusion's own file
(reference/fusion/). Names follow the published TF/JAX parameter tree;
dense kernels are [in, out] and weight-normed (v, scalar g, bias b)."""

from __future__ import annotations

import math
from typing import List, Tuple

from . import fusion

# (name, shape, kind, bound): kind "uniform" draws U(-bound, bound); "norm"
# is a weight norm's scalar g, set to the Frobenius norm of its v.
Leaf = Tuple[str, Tuple[int, ...], str, float]


def dense(name: str, i: int, o: int, bias: bool = True) -> List[Leaf]:
    out = [(name + ".v", (i, o), "uniform", math.sqrt(6.0 / (i + o))),
           (name + ".g", (), "norm", 0.0)]
    if bias:
        out.append((name + ".b", (o,), "uniform", 0.1 / math.sqrt(i)))
    return out


def param_spec(cfg: dict) -> List[Leaf]:
    h, rel, H = int(cfg["num_hid"]), int(cfg["relation_dim"]), int(cfg["num_heads"])
    words = int(cfg["ntoken"]) + 1
    word_dim = 600 if "c" in cfg["op"] else 300
    spec: List[Leaf] = [("w_emb.emb.table", (words, 300), "uniform", 0.1)]
    if "c" in cfg["op"]:
        spec.append(("w_emb.emb_.table", (words, 300), "uniform", 0.1))
    spec += [
        ("q_emb.gru.kernel", (word_dim, 3 * h), "uniform", math.sqrt(6.0 / (word_dim + 3 * h))),
        ("q_emb.gru.recurrent_kernel", (h, 3 * h), "uniform", math.sqrt(6.0 / (4 * h))),
        ("q_emb.gru.bias", (2, 3 * h), "uniform", 0.05),
    ]
    spec += dense("q_att.linear1.layers.0", h, h)
    spec += dense("q_att.linear2.layers.0", h, 1)
    spec += dense("v_relation.gatt.self_weights.layers.0", rel + h, rel)
    for d in range(int(cfg["dir_num"])):
        pre = f"v_relation.gatt.neighbor.{d}."
        spec += dense(pre + "query.layers.0", rel, rel)
        spec += dense(pre + "key.layers.0", rel, rel)
        spec += [(pre + "out.v", (H, rel, rel // H), "uniform", math.sqrt(3.0 / rel)),
                 (pre + "out.g", (), "norm", 0.0),
                 (pre + "out.b", (rel,), "uniform", 0.1 / math.sqrt(rel))]
        if cfg["relation_type"] == "implicit":
            spec += dense(pre + "pair_pos_fc.layers.0", int(cfg["imp_pos_emb_dim"]), H)
    if cfg["relation_type"] != "implicit":
        L = int(cfg["spa_label_num"] if cfg["relation_type"] == "spatial"
                else cfg["sem_label_num"])
        spec += dense("v_relation.gatt.bias.layers.0", L, 1, bool(cfg["label_bias"]))
    spec += dense("v_relation.v2out.layers.0", int(cfg["v_dim"]), rel)
    return spec + fusion.load(cfg["fusion"]).params(cfg)
