"""Device-resident tables and the on-device gather (counterpart of
tf_vqa_regat_tpu/data/device_store.py: `quantize_rows`,
`_materialize_features`, `_cached_features`, `build_image_arrays` for the
adaptive and fixed-36 layouts, `build_entry_arrays`, `DeviceStore` with its
roi-bucketed stream and per-store image-table memo, `gather_batch`,
`gather_image_features` and `gather_adj`).

The split's feature and box tables are uploaded once; a request or a train
step then ships only indices, and its rows are gathered on the device,
clipped to the table, widened to f32 and zeroed past the example's box
count. The feature table is held at `feature_dtype`: f32, bf16 (rounded to
nearest even) or int8 with a per-row f32 scale (rowmax/127), which the
gather multiplies back in. It is converted and uploaded chunk by chunk, so
a memory-mapped source (--mmap_features) never sits whole in host RAM;
with a packed cache (--packed_cache) the converted table is read from the
cache, or written there on a miss. A table larger than the card's free
memory is refused before the upload. The box tables stay f32. A fixed-36
split is flattened to 36 rows per image. The entry tables (image index,
question tokens, soft targets packed to MAX_LABELS) live there too, so a
batch is assembled from a [B] index vector.

Edge labels: with `include_adj`, a semantic split carries its semantic
table and any other its file's spatial table (`image_adj_matrix`), where
it has one, as an int8 table gathered into the batch's `adj_label` (JAX's
choice, device_store.py:225-231); without a spatial table the step builds
spatial labels from the boxes.
"""

from __future__ import annotations

import weakref
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.data.cache import (
    cache_paths,
    load_packed_cache,
    save_packed_cache,
    signature,
)
from tf_vqa_regat_tpu_torch.data.entries import EntryTable, assert_unique_labels
from tf_vqa_regat_tpu_torch.data.features import VQADataset, source_fingerprint
from tf_vqa_regat_tpu_torch.data.ordering import batch_shuffle_rng, epoch_perm_rng
from tf_vqa_regat_tpu_torch.train.profiling import timed

MAX_LABELS = 16  # VQA soft targets have <= 10 answers
CHUNK_ROWS = 262144  # rows per conversion chunk (~2 GB f32 at 2048-d), as JAX's
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
# the stored (numpy) dtype of each table dtype: bf16 as its bits
STORED_DTYPES = {"float32": np.float32, "bfloat16": np.uint16, "int8": np.int8}

Chunk = Tuple[int, int, np.ndarray, Optional[np.ndarray]]


def _put(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def quantize_rows(chunk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization: (q int8, scale f32 [rows]) with
    scale = rowmax/127 (the JAX package's formula, device_store.py:53-59)."""
    s = np.maximum(np.abs(chunk).max(axis=-1), 1e-12) / 127.0
    q = np.clip(np.round(chunk / s[..., None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def bf16_bits(chunk: np.ndarray) -> np.ndarray:
    """f32 rows -> their bf16 (round to nearest even) as uint16 bits."""
    chunk = np.ascontiguousarray(chunk, np.float32)
    t = torch.from_numpy(chunk if chunk.flags.writeable else chunk.copy()).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def table_rows(src) -> Tuple[int, int]:
    """(T, v) of the flat table of a [T, v] or fixed-36 [n_img, 36, v] source."""
    shape = src.shape
    return (shape[0] * shape[1], shape[2]) if len(shape) == 3 else (shape[0], shape[1])


def converted_chunks(src, feature_dtype: str) -> Iterator[Chunk]:
    """The flat table of `src` at `feature_dtype`, chunk by chunk (JAX
    `_materialize_features`): (first row, end row, rows at the stored dtype,
    int8's scales or None). A memory-mapped source is read one chunk at a
    time."""
    if feature_dtype not in TORCH_DTYPES:
        raise ValueError(f"unknown feature_dtype {feature_dtype!r}")
    per = src.shape[1] if len(src.shape) == 3 else 1
    v = src.shape[-1]
    step = max(CHUNK_ROWS // per, 1)
    for lo in range(0, src.shape[0], step):
        chunk = np.asarray(src[lo : lo + step], np.float32).reshape(-1, v)
        a = lo * per
        if feature_dtype == "int8":
            q, scale = quantize_rows(chunk)
            yield a, a + len(chunk), q, scale
        elif feature_dtype == "bfloat16":
            yield a, a + len(chunk), bf16_bits(chunk), None
        else:
            yield a, a + len(chunk), chunk, None


def stored_chunks(feat: np.ndarray, scale: Optional[np.ndarray]) -> Iterator[Chunk]:
    """Chunks of a table already at its stored dtype (a packed cache)."""
    for a in range(0, feat.shape[0], CHUNK_ROWS):
        b = min(a + CHUNK_ROWS, feat.shape[0])
        yield a, b, feat[a:b], None if scale is None else scale[a:b]


def cached_chunks(src, adaptive: bool, feature_dtype: str, cache_dir: str) -> Iterator[Chunk]:
    """The converted table from the packed cache in `cache_dir`, written
    there first on a miss (JAX `_cached_features`; its key, signature and
    files)."""
    sha = source_fingerprint(src)
    meta_p, feat_p, scale_p = cache_paths(cache_dir, sha, adaptive, feature_dtype)
    sig = signature(src.shape, sha, feature_dtype)
    feat, scale = load_packed_cache(meta_p, feat_p, scale_p, sig, feature_dtype)
    if feat is None:
        save_packed_cache(meta_p, feat_p, scale_p, sig, converted_chunks(src, feature_dtype),
                          table_rows(src), np.dtype(STORED_DTYPES[feature_dtype]),
                          feature_dtype == "int8")
        feat, scale = load_packed_cache(meta_p, feat_p, scale_p, sig, feature_dtype)
        if feat is None:
            raise OSError(f"the packed cache {feat_p} did not read back after writing it")
    return stored_chunks(feat, scale)


def upload_table(
    chunks: Iterator[Chunk], rows: Tuple[int, int], feature_dtype: str, device: torch.device,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The [T, v] table at `feature_dtype` on `device` (and int8's [T] f32
    scales, else None), copied chunk by chunk: the host holds one chunk."""
    out = torch.empty(rows, dtype=TORCH_DTYPES[feature_dtype], device=device)
    scale = (torch.empty(rows[:1], dtype=torch.float32, device=device)
             if feature_dtype == "int8" else None)
    for a, b, f, s in chunks:
        # a chunk of a memory map is read into RAM here (torch takes no
        # read-only arrays)
        f = np.ascontiguousarray(f) if f.flags.writeable else np.array(f)
        t = (torch.from_numpy(f.view(np.int16)).view(torch.bfloat16)
             if feature_dtype == "bfloat16" else torch.from_numpy(f))
        out[a:b].copy_(t)
        if scale is not None:
            scale[a:b].copy_(torch.from_numpy(np.array(s)))
    return out, scale


def table_nbytes(ds: VQADataset, feature_dtype: str, adj: Optional[np.ndarray]) -> int:
    """The image tables' device bytes at `feature_dtype` (JAX
    `estimate_nbytes`, the image part)."""
    store = ds.store
    T, v = table_rows(store.features)
    total = T * v * np.dtype(STORED_DTYPES[feature_dtype]).itemsize
    total += 4 * T if feature_dtype == "int8" else 0
    total += 4 * (store.normalized_bb.size + store.bb.size) + 16 * store.num_images
    return total + (0 if adj is None else int(adj.size))


def estimate_nbytes(ds: VQADataset, include_adj: bool = False,
                    feature_dtype: str = "float32") -> int:
    """The split's device tables in bytes as the JAX package counts them
    (device_store.py::estimate_nbytes), without building them: the feature
    table at the dtype's share of f32, the f32 boxes, int8's f32 row
    scales, the per-image start and length, the entries' image index,
    questions, labels and scores at 4 bytes each, and with `include_adj`
    the edge-label table at 1 byte. The port's entry tables are int64, so
    its store is larger; this count is only for the data-mode decision
    (train/loop.py::resolve_data_mode), so that the port decides what JAX
    decides. `check_fits` guards the upload against the free memory."""
    store, ent = ds.store, ds.entries
    n_entries = len(ent)
    float_scale = {"bfloat16": 0.5, "int8": 0.25}.get(feature_dtype, 1.0)
    total = int(store.features.nbytes * float_scale) + int(
        store.normalized_bb.nbytes + store.bb.nbytes)
    if feature_dtype == "int8":
        total += 4 * int(np.prod(store.features.shape[:-1]))
    total += 2 * 4 * store.num_images
    total += 4 * n_entries
    total += 4 * n_entries * ent.q_tokens.shape[1]
    total += (4 + 4) * n_entries * MAX_LABELS
    if include_adj:
        adj = adjacency_table(ds)
        if adj is not None:
            total += int(adj.size)
    return total


def check_fits(ds: VQADataset, feature_dtype: str, adj: Optional[np.ndarray],
               device: torch.device) -> None:
    """Refuse, before any upload, image tables larger than the card's free
    memory."""
    if device.type != "cuda":
        return
    need = table_nbytes(ds, feature_dtype, adj)
    free = torch.cuda.mem_get_info(device)[0]
    if need > free:
        raise MemoryError(
            f"the {ds.name} split's image tables take {need / 1e9:.2f} GB at "
            f"--feature_dtype {feature_dtype}, more than the {free / 1e9:.2f} GB free on "
            f"{device}: hold the features at --feature_dtype bfloat16 (half) or int8 (a "
            f"quarter), or stream them from the host (--data_mode host, or auto with a "
            f"smaller --device_store_budget_gb), or with more than one data-parallel rank "
            f"partition it over the ranks (--data_mode sharded, data/sharded_store.py)."
        )


def image_rows(ds: VQADataset) -> Tuple[np.ndarray, np.ndarray]:
    """(first row, row count) of each image in the flat tables: `pos_boxes`
    for an adaptive split, 36 rows per image for a fixed-36 one."""
    store = ds.store
    if store.adaptive:
        return store.pos_boxes[:, 0], store.pos_boxes[:, 1] - store.pos_boxes[:, 0]
    n_img, n_box = store.features.shape[:2]
    return np.arange(n_img) * n_box, np.full(n_img, n_box)


def adjacency_table(ds: VQADataset) -> Optional[np.ndarray]:
    """The edge-label table a split's batches carry: the semantic table for
    a semantic split, else the file's spatial labels (None when absent)."""
    store = ds.store
    return store.semantic_adj if ds.relation_type == "semantic" else store.spatial_adj


class ImageStore:
    """`features` [T, v] at `feature_dtype` (with `feat_scale` [T] f32 for
    int8, else None), `norm_bb` [T, 6] and `bb` [T, 4] f32, per-image
    `img_start` and `img_len` [num_images] int64, and with `include_adj` the
    split's `adjacency_table` as `adj` [num_images, 100, 100] int8 (else
    None), all on `device`. A fixed-36 split's image i holds rows 36 i to
    36 i + 35. `cache_dir` names a packed cache ("" = none)."""

    def __init__(self, ds: VQADataset, device: torch.device, feature_dtype: str = "float32",
                 include_adj: bool = True, cache_dir: str = ""):
        store = ds.store
        adj = adjacency_table(ds) if include_adj else None
        check_fits(ds, feature_dtype, adj, torch.device(device))
        chunks = (cached_chunks(store.features, store.adaptive, feature_dtype, cache_dir)
                  if cache_dir else converted_chunks(store.features, feature_dtype))
        self.features, self.feat_scale = upload_table(
            chunks, table_rows(store.features), feature_dtype, device)
        self.norm_bb = _put(store.normalized_bb.reshape(-1, 6), torch.float32, device)
        self.bb = _put(store.bb.reshape(-1, 4), torch.float32, device)
        start, length = image_rows(ds)
        self.img_start = _put(start, torch.int64, device)
        self.img_len = _put(length, torch.int64, device)
        self.adj = None if adj is None else _put(adj, torch.int8, device)


def image_store(ds: VQADataset, device: torch.device, feature_dtype: str = "float32",
                include_adj: bool = True, cache_dir: str = "") -> ImageStore:
    """The split's ImageStore, shared with every live store built on the same
    FeatureStore at the same settings: VQA-CP's train and test splits, over
    one merged table, upload it once (JAX DeviceStore's memo, held weakly
    so that a dropped store frees its memory)."""
    adj = adjacency_table(ds) if include_adj else None
    key = (str(torch.device(device)), feature_dtype, None if adj is None else id(adj))
    memo = ds.store.__dict__.setdefault("_device_img_memo", {})
    ref = memo.get(key)
    images = ref() if ref is not None else None
    if images is None:
        images = ImageStore(ds, device, feature_dtype, include_adj, cache_dir)
        memo[key] = weakref.ref(images)
    return images


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
    assert_unique_labels(ent, num_ans)
    rows = np.repeat(np.arange(N, dtype=np.int64), counts)
    cols = np.arange(len(ent.labels), dtype=np.int64) - np.repeat(
        ent.label_offsets[:-1].astype(np.int64), counts
    )
    labels[rows, cols] = ent.labels
    scores[rows, cols] = ent.scores
    return labels, scores


class DeviceStore:
    """One split on `device`: its image tables (`images`, see ImageStore)
    and its entry tables `entry_img` [N], `questions` [N, 14], `labels` and
    `scores` [N, MAX_LABELS]. With `targets` False (prediction, which may
    run on an answerless split) the soft targets are neither read nor
    stored."""

    @timed("upload")  # the set-up counter of the tables' upload (train/profiling.py)
    def __init__(
        self, ds: VQADataset, device: torch.device, targets: bool = True,
        feature_dtype: str = "float32", include_adj: bool = True, cache_dir: str = "",
    ):
        ent = ds.entries
        self.images = image_store(ds, device, feature_dtype, include_adj, cache_dir)
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
        batch["adj_label"] = gather_adj(store.images.adj, img, num_rois, valid)
    return batch


def gather_adj(
    table: torch.Tensor, img: torch.Tensor, num_rois: int, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[B, num_rois, num_rois] int32 edge labels of images `img` from the
    [num_images, A, A] `table`, cut or zero-padded to num_rois; rows of
    padded slots (`valid` False) are zero. Rows past an example's box count
    keep their labels, as JAX's do: the key mask handles them downstream."""
    k = min(table.shape[1], num_rois)
    adj = torch.zeros((img.shape[0], num_rois, num_rois), dtype=torch.int32, device=img.device)
    adj[:, :k, :k] = table[img][:, :k, :k].to(torch.int32)
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
