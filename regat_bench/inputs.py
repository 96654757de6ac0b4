"""The inputs of a run, made from its seed: one split of region features,
boxes, questions and soft answer targets, as plain numpy arrays that the
program (through regat_bench/port.py) and the reference both read.

Every seed gives the same sizes: the box counts of the images (spread
evenly over 10..100, adaptive rois), the question lengths (4..14 words),
the questions per image and the answer counts (1..3 per question) are
fixed multisets that the seed only permutes; the values themselves (features, boxes, image sizes,
words, answers, scores) are drawn. Drawing runs on `device` with one
torch.Generator, in a few large calls.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

MIN_BOXES = 10
MIN_WORDS = 4
MAX_LABELS = 3


def _spread(n: int, lo: int, hi: int) -> np.ndarray:
    """n integers spread evenly over lo..hi (inclusive)."""
    return lo + (np.arange(n) * (hi - lo + 1)) // max(n, 1)


def make_split(cfg: dict, seed: int, questions: int, images: int,
               device="cpu") -> Dict[str, np.ndarray]:
    """One split: features [T, v] f32, bb [T, 4], norm_bb [T, 6],
    img_start / img_len [images], q_tokens [N, 14] (padded at the back
    with ntoken), img_of [N], labels [N, 3] (-1 empty), scores [N, 3]."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def perm(n):
        return torch.randperm(n, generator=g, device=device).cpu().numpy()

    v_dim, ntoken, num_ans = int(cfg["v_dim"]), int(cfg["ntoken"]), int(cfg["num_ans"])
    T_len = int(cfg["max_q_len"])
    counts = _spread(images, MIN_BOXES, int(cfg["max_boxes"]))[perm(images)]
    total = int(counts.sum())
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)

    feats = torch.randn(total, v_dim, generator=g, device=device)
    u = torch.rand(total, 4, generator=g, device=device)
    size = torch.rand(images, 2, generator=g, device=device)
    W = (480.0 + 160.0 * size[:, 0]).repeat_interleave(
        torch.from_numpy(counts).to(device))
    H = (360.0 + 120.0 * size[:, 1]).repeat_interleave(
        torch.from_numpy(counts).to(device))
    x1, y1 = u[:, 0] * W * 0.7, u[:, 1] * H * 0.7
    x2, y2 = x1 + u[:, 2] * W * 0.3 + 4.0, y1 + u[:, 3] * H * 0.3 + 4.0
    bb = torch.stack([x1, y1, x2, y2], dim=1)
    norm = torch.stack([x1 / W, y1 / H, x2 / W, y2 / H, (x2 - x1 + 1.0) / W,
                        (y2 - y1 + 1.0) / H], dim=1)

    words = torch.randint(0, ntoken, (questions, T_len), generator=g, device=device)
    lengths = _spread(questions, MIN_WORDS, T_len)[perm(questions)]
    r = torch.randint(0, 1000, (questions, MAX_LABELS), generator=g, device=device)
    first = torch.randint(0, num_ans, (questions,), generator=g, device=device)
    # distinct labels: offsets 0, 1..1000 and 1001..2000 from the first
    offsets = torch.stack([torch.zeros_like(first), 1 + r[:, 1], 1001 + r[:, 2]], dim=1)
    labels = (first[:, None] + offsets) % num_ans
    scores = torch.rand(questions, MAX_LABELS, generator=g, device=device) * 0.7 + 0.3
    n_lab = 1 + (np.arange(questions) % MAX_LABELS)[perm(questions)]

    tokens = words.cpu().numpy().astype(np.int32)
    tokens[np.arange(T_len)[None, :] >= lengths[:, None]] = ntoken
    used = np.arange(MAX_LABELS)[None, :] < n_lab[:, None]
    return {
        "features": feats.cpu().numpy(),
        "bb": bb.cpu().numpy(),
        "norm_bb": norm.cpu().numpy(),
        "img_start": start,
        "img_len": counts.astype(np.int64),
        "q_tokens": tokens,
        "img_of": (np.arange(questions) % images)[perm(questions)].astype(np.int64),
        "labels": np.where(used, labels.cpu().numpy(), -1).astype(np.int64),
        "scores": np.where(used, scores.cpu().numpy(), 0.0).astype(np.float32),
        "num_ans": np.int64(num_ans),
        "ntoken": np.int64(ntoken),
    }
