"""The data-axis-sharded store (counterpart of
tf_vqa_regat_tpu/data/sharded_store.py: `_padded_step_batches`,
`_assign_images`, `sharded_layout`, `estimate_sharded_nbytes` and
`ShardedDeviceStore`), for a split too large to replicate on every card.

Each of the dp data-parallel shards owns a disjoint set of images, assigned
greedily by box count so that the shards' row counts balance. A rank holds
only its own shard on its device: the feature and box rows of its images,
re-packed contiguously and padded to the largest shard's row count, the
per-image start and length by local image slot, and the entries whose image
it owns (question, soft targets, local image slot), padded to the largest
shard's entry count. A step gathers the rank's part of the batch from those
local rows with data/store.py's `gather_batch`; no data crosses ranks.

Sampling, as JAX's: each shard draws a seeded permutation of its own local
entries per epoch (`shard_perm_rng`; per bucket `shard_bucket_perm_rng`),
and the global [dp * per] index batch holds shard s's local entry ids in
segment s, the ragged tails padded with -1 (`_padded_step_batches`), so
every entry is visited once per epoch and rank s takes segment s
(parallel/mesh.py::batch_slice). `local_to_global` maps a shard's local
entry id back to the split's entry index (predict's question ids).

Edge labels: with `include_adj` (JAX's build_store passes it for semantic
only; spatial labels are built in the step from the boxes) the shard's
[max_local_imgs, 100, 100] int8 table by local image slot.

Lookup by global image id (serving, JAX `image_meta_arrays` and
`build_sharded_image_gather`): every rank holds the [n_img] owner, local
slot and box count of every image; `gather_images` takes the requested
images this rank owns from its own rows, zeros elsewhere, and one SUM
all-reduce over the data group gives every rank the full [B, R, ...] batch.
Each image has exactly one owner, so the sum is the owner's rows bit for
bit; int8 rows are dequantised before it, as in JAX.

The feature table is held at --feature_dtype through data/store.py's
conversion (bf16 bits, int8 with `quantize_rows`). With --packed_cache the
whole [dp, max_rows, v] sharded table is read from, or on a miss written to,
the cache under JAX's key (`feat-{sha}-sharded{dp}-...`), signature and
layout, so one cache directory serves both packages; a rank memory-maps the
cache and uploads its own shard.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.data.cache import load_packed_cache, save_packed_cache
from tf_vqa_regat_tpu_torch.data.features import VQADataset, source_fingerprint
from tf_vqa_regat_tpu_torch.data.ordering import (
    batch_shuffle_rng,
    shard_bucket_perm_rng,
    shard_perm_rng,
)
from tf_vqa_regat_tpu_torch.data.store import (
    MAX_LABELS,
    STORED_DTYPES,
    _put,
    adjacency_table,
    bf16_bits,
    gather_adj,
    gather_image_features,
    image_rows,
    pack_soft_targets,
    quantize_rows,
    stored_chunks,
    upload_table,
)
from tf_vqa_regat_tpu_torch.parallel import distributed


def _padded_step_batches(per_shard: List[np.ndarray], per: int) -> Iterator[np.ndarray]:
    """[dp * per] index batches from per-shard local-id lists: max over
    shards of ceil(len / per) steps, short segments padded with -1."""
    dp = len(per_shard)
    steps = max((len(ids) + per - 1) // per for ids in per_shard)
    for i in range(steps):
        out = np.full((dp, per), -1, np.int32)
        for s in range(dp):
            chunk = per_shard[s][i * per : (i + 1) * per]
            out[s, : len(chunk)] = chunk
        yield out.reshape(dp * per)


def _assign_images(box_counts: np.ndarray, n_shards: int) -> List[np.ndarray]:
    """Greedy balanced partition of image indices by box count: images in
    descending box count, each to the least loaded shard."""
    order = np.argsort(-box_counts, kind="stable")
    loads = np.zeros(n_shards, np.int64)
    buckets: List[List[int]] = [[] for _ in range(n_shards)]
    for img in order:
        s = int(np.argmin(loads))
        buckets[s].append(int(img))
        loads[s] += int(box_counts[img])
    return [np.asarray(sorted(b), np.int64) for b in buckets]


def _image_lengths(ds: VQADataset) -> Tuple[np.ndarray, np.ndarray]:
    start, length = image_rows(ds)
    return np.asarray(start, np.int64), np.asarray(length, np.int64)


def sharded_layout(ds: VQADataset, dp: int) -> Tuple[int, int, int, int]:
    """(n_img, max_rows, max_entries, max_local_imgs) of the padded sharded
    layout at dp shards, from the box and entry counts only, by the same
    assignment the store builds. The assignment balances boxes, so a shard
    may own many more than n_img / dp images."""
    img_len = _image_lengths(ds)[1]
    n_img = len(img_len)
    buckets = _assign_images(img_len, dp)
    max_rows = max((int(img_len[b].sum()) for b in buckets), default=1) or 1
    max_local_imgs = max((len(b) for b in buckets), default=1) or 1
    img_shard = np.zeros(n_img, np.int32)
    for s, b in enumerate(buckets):
        img_shard[b] = s
    entry_shard = img_shard[ds.entries.image_index]
    max_entries = (max(int((entry_shard == s).sum()) for s in range(dp))
                   if len(ds.entries.question_ids) else 1) or 1
    return n_img, max_rows, max_entries, max_local_imgs


def estimate_sharded_nbytes(ds: VQADataset, include_adj: bool, feature_dtype: str,
                            dp: int) -> int:
    """One shard's device bytes at dp shards, as the JAX package counts them
    (for the data-mode decision; the port's entry tables are int64 and take
    more, as data/store.py::estimate_nbytes says): the padded feature rows at the dtype's width, the f32 boxes, int8's f32
    scales, the per-image start and length, the entries' question, labels,
    scores and image slot at 4 bytes, and with `include_adj` the split's
    edge-label table by local image slot at 1 byte."""
    store, ent = ds.store, ds.entries
    n_img, max_rows, max_entries, max_local_imgs = sharded_layout(ds, dp)
    v_dim = store.features.shape[-1]
    s_dim = store.normalized_bb.shape[-1]
    feat_itemsize = {"bfloat16": 2, "int8": 1}.get(feature_dtype, 4)
    per_row = v_dim * feat_itemsize + s_dim * 4 + 4 * 4
    if feature_dtype == "int8":
        per_row += 4
    total = max_rows * per_row
    total += 2 * 4 * n_img
    q_len = ent.q_tokens.shape[1]
    total += max_entries * (q_len * 4 + MAX_LABELS * (4 + 4) + 4)
    if include_adj:
        adj = adjacency_table(ds)
        if adj is not None:
            total += max_local_imgs * adj.shape[1] * adj.shape[2]
    return int(total)


class ShardImages:
    """One shard's image tables on its device, with the attributes of
    data/store.py::ImageStore that `gather_batch` reads: `features`
    [max_rows, v] at the table dtype (`feat_scale` [max_rows] for int8),
    `norm_bb`, `bb`, and `img_start`, `img_len` [n_img] by local image slot,
    `adj` [max_local_imgs, A, A] int8 or None."""

    def __init__(self, features, feat_scale, norm_bb, bb, img_start, img_len, adj):
        self.features, self.feat_scale = features, feat_scale
        self.norm_bb, self.bb = norm_bb, bb
        self.img_start, self.img_len, self.adj = img_start, img_len, adj


class ShardedDeviceStore:
    """Rank `rank`'s shard of `ds` at `dp` shards on `device` (module
    docstring). The layout of every shard is computed (from box and entry
    counts), so every rank draws the same global index batches; only the own
    shard's tables are built and uploaded. It has data/store.py's
    DeviceStore surface: `images`, `entry_img`, `questions`, `labels`,
    `scores`, `num_ans`, `padding_idx`, `entry_nbox`, `steps_per_epoch`,
    `epoch_indices`, `epoch_indices_bucketed`, `bucketed_batch_counts`; its
    index batches are global [dp * per] vectors of shard-local ids."""

    def __init__(self, ds: VQADataset, device: torch.device, rank: int, dp: int,
                 targets: bool = True, feature_dtype: str = "float32",
                 include_adj: bool = False, cache_dir: str = ""):
        if not 0 <= rank < dp:
            raise ValueError(f"rank {rank} outside the {dp} shards")
        self.rank, self.dp = rank, dp
        self.device = torch.device(device)
        ent, store = ds.entries, ds.store
        self.num_ans, self.padding_idx = ds.num_ans, ds.padding_idx
        self.num_entries = len(ent.question_ids)

        img_start, img_len = _image_lengths(ds)
        n_img = len(img_len)
        buckets = _assign_images(img_len, dp)
        self._img_buckets = buckets
        max_rows = max((int(img_len[b].sum()) for b in buckets), default=1) or 1
        local_start = np.zeros((dp, n_img), np.int32)
        local_len = np.zeros((dp, n_img), np.int32)
        img_shard = np.zeros(n_img, np.int32)
        img_local = np.zeros(n_img, np.int32)
        for s, bucket in enumerate(buckets):
            lens = img_len[bucket]
            local_len[s, : len(bucket)] = lens
            local_start[s, : len(bucket)] = np.cumsum(lens) - lens
            img_shard[bucket] = s
            img_local[bucket] = np.arange(len(bucket))
        self.max_rows = max_rows
        self._max_local_imgs = max((len(b) for b in buckets), default=1) or 1
        self.img_shard, self.img_local, self.img_len_global = img_shard, img_local, img_len

        entry_shard = img_shard[ent.image_index]
        shard_entry_ids = [np.where(entry_shard == s)[0] for s in range(dp)]
        self.local_entry_counts = np.asarray([len(e) for e in shard_entry_ids])
        self.max_entries = int(self.local_entry_counts.max()) if self.num_entries else 1
        self.local_to_global = np.full((dp, self.max_entries), -1, np.int64)
        for s, ids in enumerate(shard_entry_ids):
            self.local_to_global[s, : len(ids)] = ids
        self._local_entry_nbox = [
            local_len[s][img_local[ent.image_index[ids]]].copy()
            for s, ids in enumerate(shard_entry_ids)
        ]

        # this rank's image tables
        mine = buckets[rank]
        feats, scale = self._features(ds, buckets, img_start, img_len, local_start,
                                      feature_dtype, cache_dir)
        s_dim = store.normalized_bb.shape[-1]
        norms = np.zeros((max_rows, s_dim), np.float32)
        bbs = np.zeros((max_rows, 4), np.float32)
        for li, img in enumerate(mine):
            ln, off = int(img_len[img]), int(local_start[rank, li])
            if store.adaptive:
                st = int(img_start[img])
                norms[off : off + ln] = store.normalized_bb[st : st + ln]
                bbs[off : off + ln] = store.bb[st : st + ln]
            else:
                norms[off : off + ln] = store.normalized_bb[img]
                bbs[off : off + ln] = store.bb[img]
        adj = None
        if include_adj:
            src = adjacency_table(ds)
            if src is not None:
                adj = _put(self._adj_local(src), torch.int8, self.device)
        features, feat_scale = upload_table(
            stored_chunks(feats, scale), (max_rows, store.features.shape[-1]), feature_dtype,
            self.device)
        self.images = ShardImages(
            features, feat_scale, _put(norms, torch.float32, self.device),
            _put(bbs, torch.float32, self.device),
            _put(local_start[rank], torch.int64, self.device),
            _put(local_len[rank], torch.int64, self.device), adj)

        # this rank's entry tables, padded to the largest shard's count
        ids = shard_entry_ids[rank]
        k = len(ids)
        q_len = ent.q_tokens.shape[1]
        questions = np.full((self.max_entries, q_len), self.padding_idx, np.int64)
        questions[:k] = ent.q_tokens[ids]
        entry_img = np.zeros(self.max_entries, np.int64)
        entry_img[:k] = img_local[ent.image_index[ids]]
        self.entry_img = _put(entry_img, torch.int64, self.device)
        self.questions = _put(questions, torch.int64, self.device)
        self.labels = self.scores = None
        if targets:
            packed_labels, packed_scores = pack_soft_targets(ent, ds.num_ans)
            labels = np.full((self.max_entries, MAX_LABELS), -1, np.int64)
            scores = np.zeros((self.max_entries, MAX_LABELS), np.float32)
            labels[:k] = packed_labels[ids]
            scores[:k] = packed_scores[ids]
            self.labels = _put(labels, torch.int64, self.device)
            self.scores = _put(scores, torch.float32, self.device)

    # ---- the feature table ------------------------------------------------

    def _features(self, ds, buckets, img_start, img_len, local_start, feature_dtype,
                  cache_dir) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """This rank's [max_rows, v] rows at the stored dtype (and int8's
        scales): from the packed cache, or converted here (every shard on a
        cache miss, which writes the cache, else the own shard only)."""
        if not cache_dir:
            feats, scale = self._fill(ds.store, buckets[self.rank: self.rank + 1], img_start,
                                      img_len, local_start[self.rank: self.rank + 1],
                                      feature_dtype)
            return feats[0], None if scale is None else scale[0]
        meta_p, feat_p, scale_p = self.cache_paths(ds, cache_dir, feature_dtype, self.dp)
        sig = self.cache_signature(ds, feature_dtype, img_len, self.dp)
        shape = (self.dp, self.max_rows, ds.store.features.shape[-1])
        feats, scale = load_packed_cache(meta_p, feat_p, scale_p, sig, feature_dtype)
        if feats is None or feats.shape != shape:
            feats, scale = self._fill(ds.store, buckets, img_start, img_len, local_start,
                                      feature_dtype)
            chunks = ((s, s + 1, feats[s : s + 1], None if scale is None else scale[s : s + 1])
                      for s in range(self.dp))
            save_packed_cache(meta_p, feat_p, scale_p, sig, chunks, shape,
                              np.dtype(STORED_DTYPES[feature_dtype]), scale is not None)
        return feats[self.rank], None if scale is None else scale[self.rank]

    def _fill(self, store, buckets, img_start, img_len, local_start, feature_dtype
              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """[len(buckets), max_rows, v] at the stored dtype, allocated at that
        dtype and filled image by image (a memory-mapped source is read one
        image at a time), with int8's [len(buckets), max_rows] scales."""
        n, v = len(buckets), store.features.shape[-1]
        feats = np.zeros((n, self.max_rows, v), STORED_DTYPES[feature_dtype])
        scale = np.zeros((n, self.max_rows), np.float32) if feature_dtype == "int8" else None
        for s, bucket in enumerate(buckets):
            for li, img in enumerate(bucket):
                ln, off = int(img_len[img]), int(local_start[s, li])
                if store.adaptive:
                    st = int(img_start[img])
                    f_img = np.asarray(store.features[st : st + ln], np.float32)
                else:
                    f_img = np.asarray(store.features[img], np.float32)
                if feature_dtype == "int8":
                    feats[s, off : off + ln], scale[s, off : off + ln] = quantize_rows(f_img)
                elif feature_dtype == "bfloat16":
                    feats[s, off : off + ln] = bf16_bits(f_img)
                else:
                    feats[s, off : off + ln] = f_img
        return feats, scale

    @staticmethod
    def cache_paths(ds: VQADataset, cache_dir: str, feature_dtype: str, dp: int):
        """JAX's sharded cache files, keyed by content and dp."""
        sha = source_fingerprint(ds.store.features)
        key = (f"feat-{sha[:16]}-sharded{dp}-{'adaptive' if ds.store.adaptive else 'fixed'}-"
               f"{feature_dtype}")
        return tuple(os.path.join(cache_dir, key + s)
                     for s in (".meta.json", ".features.npy", ".scale.npy"))

    @staticmethod
    def cache_signature(ds: VQADataset, feature_dtype: str, img_len: np.ndarray,
                        dp: int) -> dict:
        """JAX's sharded signature: the box counts pin the assignment."""
        return {
            "src_shape": [int(x) for x in ds.store.features.shape],
            "src_sha1": source_fingerprint(ds.store.features),
            "img_len_sha1": hashlib.sha1(
                np.ascontiguousarray(img_len, np.int64).tobytes()).hexdigest(),
            "feature_dtype": feature_dtype,
            "dp": int(dp),
            "version": 1,
        }

    # ---- edge labels ------------------------------------------------------

    def _adj_local(self, adj_src: np.ndarray) -> np.ndarray:
        """This rank's [max_local_imgs, A, A] int8 edge labels by local slot."""
        A = adj_src.shape[1]
        out = np.zeros((self._max_local_imgs, A, A), np.int8)
        mine = self._img_buckets[self.rank]
        out[: len(mine)] = adj_src[mine]
        return out

    def sharded_adj_table(self, adj_src: np.ndarray) -> torch.Tensor:
        """Another edge-label table partitioned with this store's image
        assignment, this rank's part on its device."""
        return _put(self._adj_local(adj_src), torch.int8, self.device)

    # ---- lookup by global image id ----------------------------------------

    def image_meta_arrays(self) -> Dict[str, torch.Tensor]:
        """[n_img] int64 tables on this rank's device, the same on every
        rank: each image's owning shard, its local slot there and its box
        count."""
        return {"img_shard": _put(self.img_shard, torch.int64, self.device),
                "img_local": _put(self.img_local, torch.int64, self.device),
                "img_len": _put(self.img_len_global, torch.int64, self.device)}

    def gather_images(self, meta: Dict[str, torch.Tensor], img: torch.Tensor,
                      n_box: torch.Tensor, num_rois: int, group: Any = None
                      ) -> Tuple[torch.Tensor, ...]:
        """(features, norm_bb, bb, adj_label or None) of the global image ids
        `img` [B], each [B, num_rois, ...] f32 (int32 labels), on every rank
        of the data `group` (None: the world), which every rank of it calls
        alike; `n_box` is 0 on invalid slots (module docstring)."""
        owned = meta["img_shard"][img] == self.rank
        li = meta["img_local"][img]
        n_eff = torch.where(owned, n_box, torch.zeros_like(n_box))
        out = list(gather_image_features(self.images, li, n_eff, num_rois))
        if self.images.adj is not None:
            # padded or foreign slots read some local image's labels: zeroed
            li = torch.clamp(li, 0, self.images.adj.shape[0] - 1)
            out.append(gather_adj(self.images.adj, li, num_rois, owned & (n_eff > 0)))
        distributed.all_reduce_(out, group=group)
        return (*out[:3], out[3] if len(out) > 3 else None)

    # ---- the epoch streams ------------------------------------------------

    @property
    def entry_nbox(self) -> np.ndarray:
        """Box counts of every entry, shard after shard (the roi buckets'
        clamp warning)."""
        return np.concatenate(self._local_entry_nbox)

    def steps_per_epoch(self, batch_size: int) -> int:
        """Steps of an epoch: the max over shards of their local counts."""
        per = batch_size // self.dp
        return int(max((n + per - 1) // per for n in self.local_entry_counts))

    def epoch_indices(self, epoch: int, batch_size: int, shuffle: bool,
                      seed: int) -> Iterator[np.ndarray]:
        """Global [batch_size] index vectors; segment s holds shard s's local
        entry ids (its permutation under `shuffle`), or -1."""
        if batch_size % self.dp:
            raise ValueError(f"batch {batch_size} not divisible by dp={self.dp}")
        orders = [shard_perm_rng(seed, epoch, s).permutation(int(n)) if shuffle
                  else np.arange(int(n)) for s, n in enumerate(self.local_entry_counts)]
        yield from _padded_step_batches(orders, batch_size // self.dp)

    def _local_bucket_of(self, buckets: List[int]) -> List[np.ndarray]:
        b = np.asarray(sorted(buckets))
        return [np.minimum(np.searchsorted(b, nb), len(b) - 1) for nb in self._local_entry_nbox]

    def bucketed_batch_counts(self, batch_size: int, buckets: List[int]) -> List[int]:
        """Per bucket: the max over shards of the shard's batch count."""
        per = batch_size // self.dp
        bos = self._local_bucket_of(buckets)
        return [max(-(-int((bo == bi).sum()) // per) for bo in bos)
                for bi in range(len(buckets))]

    def bucketed_steps_per_epoch(self, batch_size: int, buckets: List[int]) -> int:
        return int(sum(self.bucketed_batch_counts(batch_size, buckets)))

    def epoch_indices_bucketed(self, epoch: int, batch_size: int, buckets: List[int],
                               shuffle: bool, seed: int) -> Iterator[Tuple[int, np.ndarray]]:
        """(R, [batch_size]) batches: per bucket, segment s holds shard s's
        local entries of that bucket (-1 padded); under `shuffle` each
        shard's entries per bucket, then the batches across buckets, are
        permuted (JAX's schedule, the same on every rank)."""
        buckets = sorted(buckets)
        if batch_size % self.dp:
            raise ValueError(f"batch {batch_size} not divisible by dp={self.dp}")
        per = batch_size // self.dp
        bos = self._local_bucket_of(buckets)
        rng = batch_shuffle_rng(seed, epoch)
        jobs = []
        for bi, R in enumerate(buckets):
            per_shard = []
            for s in range(self.dp):
                ids = np.where(bos[s] == bi)[0].astype(np.int32)
                if shuffle:
                    ids = ids[shard_bucket_perm_rng(seed, epoch, s, bi).permutation(len(ids))]
                per_shard.append(ids)
            for blk in _padded_step_batches(per_shard, per):
                jobs.append((R, blk))
        if shuffle:
            jobs = [jobs[i] for i in rng.permutation(len(jobs))]
        yield from jobs

    def to_global(self, idx: np.ndarray) -> np.ndarray:
        """Global entry indices (-1 kept) of a global index batch or block
        [..., dp * per] of shard-local ids."""
        per = idx.shape[-1] // self.dp
        seg = np.arange(idx.shape[-1]) // per
        g = self.local_to_global[seg, np.clip(idx, 0, None)]
        return np.where(idx >= 0, g, -1)
