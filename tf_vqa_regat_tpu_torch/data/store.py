"""Device-resident tables and the on-device gather (counterpart of
tf_vqa_regat_tpu/data/device_store.py: `quantize_rows`,
`build_image_arrays` for the adaptive and fixed-36 layouts,
`build_entry_arrays`, `DeviceStore.epoch_indices` and its roi-bucketed
stream, `gather_batch`, `gather_image_features` and `gather_adj`).

The split's feature and box tables are uploaded once; a request or a train
step then ships only indices, and its rows are gathered on the device,
clipped to the table, widened to f32 and zeroed past the example's box
count. The feature table is held at `feature_dtype`: f32, bf16 (rounded to
nearest even) or int8 with a per-row f32 scale (rowmax/127), which the
gather multiplies back in. The box tables stay f32. A fixed-36 split is
flattened to 36 rows per image. The entry tables (image index, question
tokens, soft targets packed to MAX_LABELS) live there too, so a batch is
assembled from a [B] index vector. A semantic split also carries its
per-image edge labels as an int8 table, gathered into the batch's
`adj_label`.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.data.ordering import batch_shuffle_rng, epoch_perm_rng
from tf_vqa_regat_tpu_torch.data.synthetic import EntryTable, SyntheticDataset

MAX_LABELS = 16  # VQA soft targets have <= 10 answers


def _put(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def quantize_rows(chunk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization: (q int8, scale f32 [rows]) with
    scale = rowmax/127 (the JAX package's formula, device_store.py:53-59)."""
    s = np.maximum(np.abs(chunk).max(axis=-1), 1e-12) / 127.0
    q = np.clip(np.round(chunk / s[..., None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def feature_table(
    features: np.ndarray, feature_dtype: str
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The flat [T, v] feature table at `feature_dtype`, on the host, and
    for int8 its per-row scale [T] f32 (else None)."""
    flat = features.reshape(-1, features.shape[-1])
    if feature_dtype == "float32":
        return torch.from_numpy(np.ascontiguousarray(flat)), None
    if feature_dtype == "bfloat16":  # round to nearest even
        return torch.from_numpy(np.ascontiguousarray(flat)).to(torch.bfloat16), None
    if feature_dtype == "int8":
        q, scale = quantize_rows(np.asarray(flat, np.float32))
        return torch.from_numpy(q), torch.from_numpy(scale)
    raise ValueError(f"unknown feature_dtype {feature_dtype!r}")


def image_rows(ds: SyntheticDataset) -> Tuple[np.ndarray, np.ndarray]:
    """(first row, row count) of each image in the flat tables: `pos_boxes`
    for an adaptive split, 36 rows per image for a fixed-36 one."""
    if ds.adaptive:
        return ds.pos_boxes[:, 0], ds.pos_boxes[:, 1] - ds.pos_boxes[:, 0]
    n_img, n_box = ds.features.shape[:2]
    return np.arange(n_img) * n_box, np.full(n_img, n_box)


class ImageStore:
    """`features` [T, v] at `feature_dtype` (with `feat_scale` [T] f32 for
    int8, else None), `norm_bb` [T, 6] and `bb` [T, 4] f32, per-image
    `img_start` and `img_len` [num_images] int64, and for a semantic split
    `adj` [num_images, 100, 100] int8 (else None), all on `device`. A
    fixed-36 split's image i holds rows 36 i to 36 i + 35."""

    def __init__(self, ds: SyntheticDataset, device: torch.device,
                 feature_dtype: str = "float32"):
        features, scale = feature_table(ds.features, feature_dtype)
        self.features = features.to(device)
        self.feat_scale = None if scale is None else scale.to(device)
        self.norm_bb = _put(ds.normalized_bb.reshape(-1, 6), torch.float32, device)
        self.bb = _put(ds.bb.reshape(-1, 4), torch.float32, device)
        start, length = image_rows(ds)
        self.img_start = _put(start, torch.int64, device)
        self.img_len = _put(length, torch.int64, device)
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

    def __init__(
        self, ds: SyntheticDataset, device: torch.device, targets: bool = True,
        feature_dtype: str = "float32",
    ):
        ent = ds.entries
        self.images = ImageStore(ds, device, feature_dtype)
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
        # per-entry box counts, for the roi buckets (on the host)
        self.entry_nbox = image_rows(ds)[1][ent.image_index].astype(np.int32)

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

    def epoch_indices_bucketed(
        self, epoch: int, batch_size: int, buckets: List[int], shuffle: bool, seed: int
    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Roi-bucketed (R, idx) batches: each batch holds entries of one
        bucket only (images with <= R boxes, the oversized clamped to the
        last bucket), padded with -1. With `shuffle` the entries within each
        bucket, then the batches across buckets, are permuted by the epoch's
        `batch_shuffle_rng`; every entry appears once per epoch."""
        buckets = sorted(buckets)
        bucket_of = self._bucket_of(buckets)
        rng = batch_shuffle_rng(seed, epoch)
        jobs = []
        for bi, R in enumerate(buckets):
            ids = np.where(bucket_of == bi)[0].astype(np.int32)
            if len(ids) == 0:
                continue
            if shuffle:
                ids = ids[rng.permutation(len(ids))]
            for start in range(0, len(ids), batch_size):
                idx = ids[start : start + batch_size]
                if len(idx) < batch_size:
                    idx = np.concatenate([idx, np.full(batch_size - len(idx), -1, np.int32)])
                jobs.append((R, idx))
        if shuffle:
            jobs = [jobs[i] for i in rng.permutation(len(jobs))]
        yield from jobs

    def _bucket_of(self, buckets: List[int]) -> np.ndarray:
        """Bucket index per entry; oversized images clamp to the last bucket."""
        return np.minimum(
            np.searchsorted(np.asarray(buckets), self.entry_nbox), len(buckets) - 1
        )

    def bucketed_batch_counts(self, batch_size: int, buckets: List[int]) -> List[int]:
        """Per bucket (sorted): the number of batches an epoch yields."""
        bucket_of = self._bucket_of(sorted(buckets))
        return [-(-int((bucket_of == bi).sum()) // batch_size) for bi in range(len(buckets))]

    def bucketed_steps_per_epoch(self, batch_size: int, buckets: List[int]) -> int:
        return int(sum(self.bucketed_batch_counts(batch_size, buckets)))


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
    """(features, norm_bb, bb), each [B, num_rois, ...] f32: the rows
    widened to f32 and zeroed past `n_box`, int8 features then multiplied by
    their rows' scales (the JAX order)."""
    r = torch.arange(num_rois, device=img.device)
    rows = store.img_start[img][:, None] + r[None, :]  # [B, R]
    roi_ok = (r[None, :] < n_box[:, None])[..., None]
    rows = torch.clamp(rows, 0, store.features.shape[0] - 1)

    def take(tab):
        out = tab[rows].to(torch.float32)
        return torch.where(roi_ok, out, torch.zeros_like(out))

    features = take(store.features)
    if store.feat_scale is not None:
        features = features * store.feat_scale[rows][..., None]
    return features, take(store.norm_bb), take(store.bb)
