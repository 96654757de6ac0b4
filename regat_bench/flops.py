"""The yardstick's arithmetic: the H100's peaks, the operations a ReGAT step
needs per question, and the bytes and operations of the two hand-written
kernels, all from the configuration's shapes (not from the tensors one
implementation happens to pass), so any later kernel is held to the same
work.

A kernel's least time is the larger of its bytes over the HBM rate and its
f32 operations over the f32 peak outside the tensor cores (the
configuration computes in f32 with TF32 off); its roofline share is that
least time over its measured device time.
"""

from __future__ import annotations

from typing import List, Tuple

from regat_bench.reference import fusion

# NVIDIA H100 SXM data sheet: HBM3 rate, and f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F32, U8 = 4, 1


def least_seconds(moved_bytes: float, flops: float) -> float:
    return max(moved_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def roofline_percent(moved_bytes: float, flops: float, seconds_per_call: float) -> float:
    """The least time over the measured time, in percent."""
    return 100.0 * least_seconds(moved_bytes, flops) / seconds_per_call


def _dims(cfg: dict):
    h, rel, H = int(cfg["num_hid"]), int(cfg["relation_dim"]), int(cfg["num_heads"])
    R = int(cfg["max_boxes"])
    n = min(int(cfg["nongt_dim"]), R)
    return h, rel, H, R, n, rel // H


def matmuls(cfg: dict) -> List[Tuple[str, float, bool]]:
    """Every matrix product of one question's forward pass: (what, f32
    operations at 2 per multiply-add, whether its backward also needs the
    gradient of its input); the fusion's and classifier's last, from the
    fusion's file (reference/fusion/). Elementwise work, softmaxes and the
    weight norms are not counted."""
    h, rel, H, R, n, dh = _dims(cfg)
    T = int(cfg["max_q_len"])
    wd = 600 if "c" in cfg["op"] else 300
    v = int(cfg["v_dim"])
    out = [
        ("gru input", 2.0 * T * wd * 3 * h, True),
        ("gru recurrence", 2.0 * T * h * 3 * h, True),
        ("q_att linear1", 2.0 * T * h * h, True),
        ("q_att linear2", 2.0 * T * h, True),
        ("q_att pooling", 2.0 * T * h, True),
        ("v2out", 2.0 * R * v * rel, False),
        ("self_weights", 2.0 * R * (rel + h) * rel, True),
    ]
    for d in range(int(cfg["dir_num"])):
        out += [
            (f"dir{d} query", 2.0 * R * rel * rel, True),
            (f"dir{d} key", 2.0 * n * rel * rel, True),
            (f"dir{d} value x out", 2.0 * n * rel * rel, True),
            (f"dir{d} q.k", 2.0 * R * H * n * dh, True),
            (f"dir{d} weights x vw", 2.0 * R * H * n * dh, True),
        ]
        if cfg["relation_type"] == "implicit":
            out.append((f"dir{d} pos-FC", 2.0 * R * n * int(cfg["imp_pos_emb_dim"]) * H, False))
        else:
            L = int(cfg["spa_label_num"] if cfg["relation_type"] == "spatial"
                    else cfg["sem_label_num"])
            out.append((f"dir{d} label FC", 2.0 * R * n * L, False))
    return out + fusion.load(cfg["fusion"]).matmuls(cfg)


def forward_flops(cfg: dict) -> float:
    """f32 operations of one question's forward pass."""
    return sum(f for _, f, _ in matmuls(cfg))


def train_flops(cfg: dict) -> float:
    """f32 operations of one question's training step: the forward pass,
    and a backward pass of two products per forward product (weight and
    input gradients) where the input needs a gradient, one where it does
    not. No recomputed work is counted."""
    return sum(f * (3.0 if needs_input else 2.0) for _, f, needs_input in matmuls(cfg))


def mfu_percent(flops_per_question: float, questions: float, seconds: float,
                chips: int = 1) -> float:
    return 100.0 * flops_per_question * questions / (seconds * F32_FLOPS_PER_S * chips)


def b1_cost(cfg: dict, b: int, train: bool) -> Tuple[float, float]:
    """(bytes, f32 operations) one call of the fused implicit attention
    needs for one direction at batch b: it reads q [b, R, H, dh], k and vw
    [b, n, H, dh], the position matrix [b, R, n, 4], the pos-FC kernel
    [P, H] and bias [H], the key mask [b, n] and, in training, the
    embedding's uint8 keep-mask [b, R, n, P], and writes out [b, R, H, dh];
    per (row, head, key) it takes the q.k dot, the pos-FC dot and the
    weighted sum of vw."""
    _, _, H, R, n, dh = _dims(cfg)
    P = int(cfg["imp_pos_emb_dim"])
    moved = F32 * (b * R * H * dh + 2 * b * n * H * dh + b * R * n * 4 + P * H + H
                   + b * R * H * dh) + U8 * b * n
    if train:
        moved += U8 * b * R * n * P
    return float(moved), 2.0 * b * R * H * n * (dh + P + dh)


def b2_cost(cfg: dict, b: int) -> Tuple[float, float]:
    """(bytes, f32 operations) of one call of the fused masked graph
    attention for one direction at batch b: it reads q [b, R, H, dh], k
    and vw [b, n, H, dh] and the edge bias shared across heads [b, R, n],
    and writes out [b, R, H, dh]; per (row, head, key) the q.k dot and the
    weighted sum of vw."""
    _, _, H, R, n, dh = _dims(cfg)
    moved = F32 * (2 * b * R * H * dh + 2 * b * n * H * dh + b * R * n)
    return float(moved), 2.0 * b * R * H * n * (2 * dh)
