"""A batch for the reference, gathered from the raw inputs (the arrays of
regat_bench/inputs.py): each entry's image rows zero-padded to R, its
question, its dense soft target."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def make_batch(raw: Dict[str, np.ndarray], entries: Sequence[int], R: int,
               device) -> Dict[str, torch.Tensor]:
    """features [b, R, v], bb [b, R, 4], norm_bb [b, R, 6], question [b, T],
    num_boxes [b] and target [b, num_answers] for entry indices `entries`
    (every one real)."""
    entries = np.asarray(entries, np.int64)
    batch = image_batch(raw, raw["img_of"][entries], raw["q_tokens"][entries], R, device)
    b = len(entries)
    target = np.zeros((b, int(raw["num_ans"])), np.float32)
    lab, sc = raw["labels"][entries], raw["scores"][entries]
    for j in range(lab.shape[1]):
        hit = lab[:, j] >= 0
        target[np.nonzero(hit)[0], lab[hit, j]] += sc[hit, j]
    batch["target"] = torch.from_numpy(target).to(device)
    return batch


def image_batch(raw: Dict[str, np.ndarray], img: np.ndarray, questions: np.ndarray, R: int,
                device) -> Dict[str, torch.Tensor]:
    """The batch of images `img` [b] with token ids `questions` [b, T]."""
    img = np.asarray(img, np.int64)
    start, count = raw["img_start"][img], np.minimum(raw["img_len"][img], R)
    rows = start[:, None] + np.arange(R)[None, :]
    ok = np.arange(R)[None, :] < count[:, None]
    rows = np.where(ok, rows, 0)

    def take(table):
        t = torch.from_numpy(table[rows]).to(device)
        return torch.where(torch.from_numpy(ok).to(device)[..., None], t, 0.0)

    return {
        "features": take(raw["features"]), "bb": take(raw["bb"]),
        "norm_bb": take(raw["norm_bb"]),
        "question": torch.from_numpy(np.asarray(questions, np.int64)).to(device),
        "num_boxes": torch.from_numpy(count.astype(np.int64)).to(device),
    }
