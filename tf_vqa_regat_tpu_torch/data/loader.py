"""Host batch packing and the host-to-device prefetch of the host data path
(counterpart of tf_vqa_regat_tpu/data/loader.py: `BatchLoader`,
`prefetch_to_device`), which `--data_mode host` (or `auto` over the budget)
takes in place of the device stores of data/store.py.

`BatchLoader` has the JAX loader's semantics: static [B, R] batches, a
`valid` mask with the last batch padded, the epoch permutation
`epoch_perm_rng(seed, epoch)`, `skip` for a mid-epoch resume, a
[num_images, R] row table with -1 at pad slots gathered by the threaded C++
gather of data/native.py (per-image slices instead when the features are
memory-mapped, --mmap_features), the soft targets scattered from the ragged
entry table, and with `include_adj` the file's semantic or spatial
(`image_adj_matrix`) edge labels as `adj_label`. Its batches have the keys,
dtypes and shapes of data/store.py::gather_batch's, on the host: the
features at the wire dtype (below), norm_bb and bb f32, question and
num_boxes int64, valid bool, target f32, adj_label int32.

The wire dtype of the features is f32, or bf16 under --feature_dtype
bfloat16 (half the bytes to copy), rounded to nearest even from the f32
rows as JAX's `astype(bfloat16)` rounds them. int8 goes over the wire as
bf16, as in JAX: int8 is a device-store format (per-row quantized tables),
so a host-mode int8 batch equals the bf16 one, not the device store's
dequantized int8 batch. The bf16 features are widened to f32 on the batch's
device, where the device store widens its bf16 table.

`prefetch_to_device` packs and copies `depth` batches ahead in a background
thread. On a CUDA device it packs straight into a ring of pinned host
buffers (through numpy views of pinned tensors, so a batch is copied once on
the host), issues `non_blocking` copies on its own CUDA stream and records an
event after them; the consumer's stream waits on that event, the device
tensors are marked with `record_stream` for it, and a ring slot is not
packed again before the event of the copy that read it has completed. On the
CPU the thread packs into fresh tensors, with no pinned memory and no
stream. `depth` 0 packs and copies in the caller's thread. When the consumer
drops the iterator (a preemption, an error in the step) a stop event ends
the producer, which the consumer joins; an error in the producer is raised
in the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.data import native
from tf_vqa_regat_tpu_torch.data.entries import assert_unique_labels
from tf_vqa_regat_tpu_torch.data.features import VQADataset
from tf_vqa_regat_tpu_torch.data.ordering import epoch_perm_rng
from tf_vqa_regat_tpu_torch.data.store import image_rows

Batch = Dict[str, torch.Tensor]
# --feature_dtype -> the features' dtype on the wire
WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.bfloat16}


class BatchLoader:
    """Static-shape batches of one split, packed on the host. `native`
    False packs the rows with numpy's gather, the plain version of the C++
    one (for the tests and chip_smoke.py). `pack` runs in one thread at a
    time: a bf16 batch passes through one f32 scratch buffer."""

    def __init__(
        self,
        dataset: VQADataset,
        batch_size: int,
        num_rois: int,
        shuffle: bool,
        seed: int = 42,
        include_adj: bool = False,
        feature_dtype: str = "float32",
        native: bool = True,
    ):
        if feature_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"unknown feature_dtype {feature_dtype!r} (float32 | bfloat16 | int8)")
        # the device store's guard: a repeated label would make this
        # assign-scatter differ from the device gather's add-scatter
        assert_unique_labels(dataset.entries, dataset.num_ans)
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_rois = num_rois
        self.shuffle = shuffle
        self.seed = seed
        self.wire_dtype = WIRE_DTYPES[feature_dtype]
        self.native = native
        store = dataset.store
        self.adj = None
        if include_adj:
            self.adj = {"semantic": store.semantic_adj,
                        "spatial": store.spatial_adj}.get(dataset.relation_type)
        self.steps_per_epoch = -(-len(dataset) // batch_size)
        start, count = image_rows(dataset)
        self._nbox = np.minimum(count, num_rois).astype(np.int32)  # [num_img]
        self._start = start.astype(np.int64)
        self._rows: Optional[np.ndarray] = None  # [num_img, R] flat rows, -1 = pad
        self._scratch: Optional[np.ndarray] = None  # f32 features of a bf16 batch

    def __len__(self) -> int:
        return self.steps_per_epoch

    @property
    def num_examples(self) -> int:
        return len(self.dataset)

    def epoch_indices(self, epoch_idx: int = 0, skip: int = 0) -> Iterator[np.ndarray]:
        """The entry indices of each batch of the epoch past the first `skip`
        (the seeded permutation with `shuffle`, else entry order); the last
        batch may be short."""
        n = len(self.dataset)
        order = epoch_perm_rng(self.seed, epoch_idx).permutation(n) if self.shuffle \
            else np.arange(n)
        for start in range(skip * self.batch_size, n, self.batch_size):
            yield order[start : start + self.batch_size]

    def epoch(self, epoch_idx: int = 0, skip: int = 0) -> Iterator[Batch]:
        """The epoch's batches on the host, each in fresh tensors; `skip`
        drops the first batches without packing them."""
        for idx in self.epoch_indices(epoch_idx, skip):
            yield self.pack(idx)

    def empty_batch(self, pin_memory: bool = False) -> Batch:
        """Uninitialized host tensors of one batch (pinned with
        `pin_memory`), which `pack` fills."""
        ds, B, R = self.dataset, self.batch_size, self.num_rois
        store = ds.store
        shapes = {
            "features": ((B, R, store.v_dim), self.wire_dtype),
            "norm_bb": ((B, R, store.normalized_bb.shape[-1]), torch.float32),
            "bb": ((B, R, 4), torch.float32),
            "question": ((B, ds.entries.q_tokens.shape[1]), torch.int64),
            "num_boxes": ((B,), torch.int64),
            "valid": ((B,), torch.bool),
            "target": ((B, ds.num_ans), torch.float32),
        }
        if self.adj is not None:
            shapes["adj_label"] = ((B, R, R), torch.int32)
        return {k: torch.empty(shape, dtype=dtype, pin_memory=pin_memory)
                for k, (shape, dtype) in shapes.items()}

    def _gather_table(self) -> np.ndarray:
        """The [num_img, R] flat-row table, built once (JAX's; the fixed-36
        layout's rows are 36 i + r)."""
        if self._rows is None:
            r = np.arange(self.num_rois, dtype=np.int64)[None, :]
            self._rows = np.where(r < self._nbox[:, None], self._start[:, None] + r, -1)
        return self._rows

    def _gather(self, tab: np.ndarray, rows: np.ndarray, out: np.ndarray) -> None:
        flat = tab.reshape(-1, tab.shape[-1])
        if self.native:
            native.gather_rows(flat, rows, out)
        else:
            native.gather_rows_plain(flat, rows, out)

    def pack(self, idx: np.ndarray, out: Optional[Batch] = None) -> Batch:
        """The batch of entries `idx` (at most batch_size), written over every
        element of `out` (fresh tensors when None), which it returns."""
        ds, B, R = self.dataset, self.batch_size, self.num_rois
        ent, store = ds.entries, ds.store
        if out is None:
            out = self.empty_batch()
        n = len(idx)
        imgs = ent.image_index[idx]
        nbox = self._nbox[imgs]

        if self.wire_dtype == torch.float32:
            features = out["features"].numpy()
        else:
            if self._scratch is None:
                self._scratch = np.empty(tuple(out["features"].shape), np.float32)
            features = self._scratch
        norm_bb, bb = out["norm_bb"].numpy(), out["bb"].numpy()
        tables = ((store.features, features), (store.normalized_bb, norm_bb), (store.bb, bb))
        if store.features_lazy:
            # a memory-mapped table is read image by image: contiguous
            # slices, bounded RAM
            for row, img in enumerate(imgs):
                k = int(nbox[row])
                for tab, dst in tables:
                    src = (tab[self._start[img] : self._start[img] + k] if store.adaptive
                           else tab[img, :k])
                    dst[row, :k] = src
                    dst[row, k:] = 0
        else:
            rows = self._gather_table()[imgs].reshape(-1)
            for tab, dst in tables:
                self._gather(tab, rows, dst[:n].reshape(n * R, dst.shape[-1]))
        for _, dst in tables:
            dst[n:] = 0
        if self.wire_dtype != torch.float32:
            # round to nearest even (JAX: astype(bfloat16)), on torch's
            # threads, without the interpreter lock
            out["features"].copy_(torch.from_numpy(features))

        out["num_boxes"].numpy()[:n] = nbox
        out["num_boxes"].numpy()[n:] = 0
        valid = out["valid"].numpy()
        valid[:n] = True
        valid[n:] = False

        # soft targets: the ragged (entry -> labels, scores) scatter,
        # vectorized with the repeat/cumsum trick over the offset table
        target = out["target"].numpy()
        target.fill(0.0)
        starts = ent.label_offsets[idx]
        lens = (ent.label_offsets[idx + 1] - starts).astype(np.int64)
        total = int(lens.sum())
        if total:
            row_ids = np.repeat(np.arange(n), lens)
            flat = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
            flat = flat + np.repeat(starts, lens)
            target[row_ids, ent.labels[flat]] = ent.scores[flat]

        question = out["question"].numpy()
        question[:n] = ent.q_tokens[idx]
        question[n:] = ds.padding_idx

        if self.adj is not None:
            adj = out["adj_label"].numpy()
            adj.fill(0)
            k = min(self.adj.shape[1], R)
            adj[:n, :k, :k] = self.adj[imgs, :k, :k]
        return out


def widen_features(batch: Batch) -> Batch:
    """Widen bf16 wire features to f32 on the batch's device (the consumer's
    stream)."""
    if batch["features"].dtype != torch.float32:
        batch["features"] = batch["features"].to(torch.float32)
    return batch


class _PinnedRing:
    """`slots` pinned host batches that the producer thread packs in turn,
    each copied to the card on `stream`. A slot is packed again only after
    the event recorded behind its last copy has completed."""

    def __init__(self, loader: BatchLoader, device: torch.device, slots: int):
        self.loader = loader
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = [None] * slots
        self.copied = [None] * slots  # the event behind each slot's last copy
        self.turn = 0

    def put(self, idx: np.ndarray) -> Tuple[Batch, torch.cuda.Event]:
        i = self.turn % len(self.slots)
        self.turn += 1
        if self.slots[i] is None:
            self.slots[i] = self.loader.empty_batch(pin_memory=True)
        elif self.copied[i] is not None:
            self.copied[i].synchronize()
        host = self.loader.pack(idx, self.slots[i])
        with torch.cuda.stream(self.stream):
            batch = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(self.stream)
        self.copied[i] = ready
        return batch, ready


def prefetch_to_device(
    loader: BatchLoader, device: torch.device, epoch_idx: int = 0, skip: int = 0,
    depth: int = 2,
) -> Iterator[Batch]:
    """The loader's epoch (past `skip` batches) as batches on `device`,
    packed and copied `depth` batches ahead by a background thread (0: in
    the caller's thread). Close the iterator (contextlib.closing) to stop
    the thread before the epoch ends."""
    device = torch.device(device)
    indices = loader.epoch_indices(epoch_idx, skip)
    if depth <= 0:
        for idx in indices:
            yield widen_features({k: v.to(device) for k, v in loader.pack(idx).items()})
        return

    if device.type == "cuda":
        produce = _PinnedRing(loader, device, depth + 1).put
    else:
        def produce(idx):
            return loader.pack(idx), None

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        """q.put that gives up once the consumer has gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for idx in indices:
                if stop.is_set() or not put(produce(idx)):
                    return
        except Exception as e:  # raised again in the consumer
            err.append(e)
        finally:
            put(done)

    thread = threading.Thread(target=producer, name="regat-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            batch, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(ready)
                for t in batch.values():
                    t.record_stream(stream)
            yield widen_features(batch)
    finally:
        # on exhaustion and on close(): end the producer before returning
        stop.set()
        thread.join()
