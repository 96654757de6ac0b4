"""Device-resident tables and the on-device gather (counterpart of
tf_vqa_regat_tpu/data/device_store.py: `build_image_arrays` for the adaptive
layout, `build_entry_arrays`, `DeviceStore.epoch_indices`, `gather_batch`
and `gather_image_features`, `gather_adj`).

The split's feature and box tables are uploaded once, at f32; a request or a
train step then ships only indices, and its rows are gathered on the device,
clipped to the table and zeroed past the example's box count. The entry
tables (image index, question tokens, soft targets packed to MAX_LABELS)
live there too, so a batch is assembled from a [B] index vector. A semantic
split also carries its per-image edge labels as an int8 table, gathered into
the batch's `adj_label`. bf16 and int8 feature tables are in ROADMAP Queue
A, main-path runtime.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.data.ordering import epoch_perm_rng
from tf_vqa_regat_tpu_torch.data.synthetic import EntryTable, SyntheticDataset

MAX_LABELS = 16  # VQA soft targets have <= 10 answers


def _put(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


class ImageStore:
    """`features` [T, v], `norm_bb` [T, 6] and `bb` [T, 4] f32, per-image
    `img_start` and `img_len` [num_images] int64, and for a semantic split
    `adj` [num_images, 100, 100] int8 (else None), all on `device`."""

    def __init__(self, ds: SyntheticDataset, device: torch.device):
        self.features = _put(ds.features, torch.float32, device)
        self.norm_bb = _put(ds.normalized_bb, torch.float32, device)
        self.bb = _put(ds.bb, torch.float32, device)
        self.img_start = _put(ds.pos_boxes[:, 0], torch.int64, device)
        self.img_len = _put(ds.pos_boxes[:, 1] - ds.pos_boxes[:, 0], torch.int64, device)
        self.adj = (
            None if ds.semantic_adj is None else _put(ds.semantic_adj, torch.int8, device)
        )


def pack_soft_targets(ent: EntryTable, num_ans: int) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged soft targets -> [N, MAX_LABELS] labels (int32, -1 = empty) and
    scores (f32). Raises, as the JAX packer does, on an entry with more than
    MAX_LABELS answers (truncating would drop score mass) or with a repeated
    answer label (the add-scatter would count it twice)."""
    N = len(ent.question_ids)
    labels = np.full((N, MAX_LABELS), -1, np.int32)
    scores = np.zeros((N, MAX_LABELS), np.float32)
    if N == 0 or len(ent.labels) == 0:
        return labels, scores
    counts = np.diff(ent.label_offsets).astype(np.int64)
    if int(counts.max()) > MAX_LABELS:
        raise ValueError(
            f"an entry has {int(counts.max())} answer labels > MAX_LABELS="
            f"{MAX_LABELS}; truncating would drop soft-target score mass"
        )
    rows = np.repeat(np.arange(N, dtype=np.int64), counts)
    key = rows * np.int64(num_ans) + ent.labels
    if len(np.unique(key)) != len(key):
        raise ValueError(
            "duplicate answer labels within an entry: the add-scatter would "
            "count their scores twice"
        )
    cols = np.arange(len(ent.labels), dtype=np.int64) - np.repeat(
        ent.label_offsets[:-1].astype(np.int64), counts
    )
    labels[rows, cols] = ent.labels
    scores[rows, cols] = ent.scores
    return labels, scores


class DeviceStore:
    """One split on `device`: its image tables (`images`) and its entry
    tables `entry_img` [N], `questions` [N, 14], `labels` and `scores`
    [N, MAX_LABELS]. With `targets` False (prediction, which may run on an
    answerless split) the soft targets are neither read nor stored."""

    def __init__(self, ds: SyntheticDataset, device: torch.device, targets: bool = True):
        ent = ds.entries
        self.images = ImageStore(ds, device)
        self.entry_img = _put(ent.image_index, torch.int64, device)
        self.questions = _put(ent.q_tokens, torch.int64, device)
        self.labels = self.scores = None
        if targets:
            labels, scores = pack_soft_targets(ent, ds.num_ans)
            self.labels = _put(labels, torch.int64, device)
            self.scores = _put(scores, torch.float32, device)
        self.num_entries = len(ent.question_ids)
        self.num_ans = ds.num_ans
        self.padding_idx = ds.padding_idx

    def steps_per_epoch(self, batch_size: int) -> int:
        return -(-self.num_entries // batch_size)

    def epoch_indices(
        self, epoch: int, batch_size: int, shuffle: bool, seed: int
    ) -> Iterator[np.ndarray]:
        """Index batches [batch_size] int32 on the host, the last padded with
        -1 (invalid): the epoch's seeded permutation, or entry order."""
        n = self.num_entries
        order = epoch_perm_rng(seed, epoch).permutation(n) if shuffle else np.arange(n)
        for start in range(0, n, batch_size):
            idx = order[start : start + batch_size].astype(np.int32)
            if len(idx) < batch_size:
                idx = np.concatenate([idx, np.full(batch_size - len(idx), -1, np.int32)])
            yield idx


def gather_batch(
    store: DeviceStore, idx: torch.Tensor, num_rois: int, adj: bool = True
) -> Dict[str, torch.Tensor]:
    """The batch for index vector `idx` [B] (on the store's device, -1 =
    padded slot): features, norm_bb, bb, question, num_boxes, valid, the
    dense soft targets [B, num_ans] when the store has them, and adj_label
    when it has edge labels and `adj` is set. A padded slot has no boxes, a
    question of padding tokens, a zero target and no edges."""
    B = idx.shape[0]
    valid = idx >= 0
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    img = store.entry_img[safe]
    n_box = torch.where(
        valid,
        torch.clamp(store.images.img_len[img], max=num_rois),
        torch.zeros_like(img),
    )
    features, norm_bb, bb = gather_image_features(store.images, img, n_box, num_rois)
    q = store.questions[safe]
    question = torch.where(valid[:, None], q, torch.full_like(q, store.padding_idx))
    batch = {
        "features": features, "norm_bb": norm_bb, "bb": bb, "question": question,
        "num_boxes": n_box, "valid": valid,
    }
    if store.labels is not None:
        labels, scores = store.labels[safe], store.scores[safe]
        lab_ok = (labels >= 0) & valid[:, None]
        target = torch.zeros((B, store.num_ans), dtype=torch.float32, device=idx.device)
        target.scatter_add_(
            1,
            torch.where(lab_ok, labels, torch.zeros_like(labels)),
            torch.where(lab_ok, scores, torch.zeros_like(scores)),
        )
        batch["target"] = target
    if adj and store.images.adj is not None:
        batch["adj_label"] = gather_adj(store.images, img, num_rois, valid)
    return batch


def gather_adj(
    store: ImageStore, img: torch.Tensor, num_rois: int, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[B, num_rois, num_rois] int32 edge labels of images `img`, cut or
    zero-padded to num_rois; rows of padded slots (`valid` False) are zero.
    Rows past an example's box count keep their labels, as JAX's do: the key
    mask handles them downstream."""
    A = store.adj.shape[1]
    k = min(A, num_rois)
    adj = torch.zeros((img.shape[0], num_rois, num_rois), dtype=torch.int32, device=img.device)
    adj[:, :k, :k] = store.adj[img][:, :k, :k].to(torch.int32)
    if valid is not None:
        adj = torch.where(valid[:, None, None], adj, torch.zeros_like(adj))
    return adj


def gather_image_features(
    store: ImageStore,
    img: torch.Tensor,  # [B] image indices
    n_box: torch.Tensor,  # [B] valid box count per example (0 = fully padded)
    num_rois: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(features, norm_bb, bb), each [B, num_rois, ...]."""
    r = torch.arange(num_rois, device=img.device)
    rows = store.img_start[img][:, None] + r[None, :]  # [B, R]
    roi_ok = (r[None, :] < n_box[:, None])[..., None]
    rows = torch.clamp(rows, 0, store.features.shape[0] - 1)

    def take(tab):
        out = tab[rows]
        return torch.where(roi_ok, out, torch.zeros_like(out))

    return take(store.features), take(store.norm_bb), take(store.bb)
