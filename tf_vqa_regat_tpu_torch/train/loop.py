"""Train, eval and predict orchestration (counterpart of
tf_vqa_regat_tpu/train/loop.py: `run_training`, `run_evaluation`,
`run_prediction`, `_run_eval`, `_log_progress`, `_run_signature`,
`Preempted`, `_PreemptWatcher`, `resolve_data_mode`,
`check_roi_buckets_mode`, `build_store` and `_DataPath`), over the
device-resident stores of data/store.py, the sharded store of
data/sharded_store.py or the host loaders of data/loader.py.

The data path is JAX's one policy (`resolve_data_mode`): `--data_mode
device` holds each split's tables on the card and gathers a batch there;
`sharded` holds on each data-parallel rank only its own images' rows;
`host` packs batches on the host and streams them to the card (`--prefetch`
batches ahead); `auto` takes `device` when every split's tables, as JAX
counts them (data/store.py::estimate_nbytes), fit
`--device_store_budget_gb`, each split half of it when a train split is
present, else `sharded` at dp > 1 when every split's per-shard tables
(estimate_sharded_nbytes) fit, else `host`. Every entry point logs the mode
it took with each split's estimate and the budget (`[data] data=...`).

Data parallelism (parallel/): dp ranks, one process each (`make_mesh` over
the process group, --dp_size), split every global batch along its batch
axis. In device and host modes every rank holds the replicated tables and
takes its rows of the same global index batch; in sharded mode the global
batch's segment r holds rank r's shard-local entries. The train step sums
the ranks' gradient sums before the global valid-count division
(train/step.py); eval and predict sum the ranks' metrics and answers. After
the init and after a resume the parameters are broadcast from rank 0.
Rank 0 alone writes log.txt, metrics.jsonl, checkpoints and predictions
(train/logging.py, train/checkpoint.py); a SIGTERM to any rank makes every
rank save at the same boundary (`_PreemptWatcher`).

The log lines follow the JAX package's (and so the reference's) format: the
optimizer banner, the LR line at every warmup epoch and every decay epoch,
a step line every `print_freq` steps, an eval pass after every epoch and
`[DEBUG] train_score: .. eval_score: ..`. One record per epoch goes to
`{output}/metrics.jsonl` with the JAX keys. The metrics accumulate on the
device and are read at a print and at the end of an epoch.

Checkpoints (train/checkpoint.py): every epoch and the best under
--save_every_epoch, a step checkpoint every --checkpoint_every_steps, and
one at the next step after SIGTERM (or the REGAT_FAULT_PREEMPT_STEP fault
hook), after which training raises `Preempted`. --resume restores the
newest and, from a step checkpoint, skips the epoch's steps already taken
and restores its accumulators: dropout masks follow (seed, count) and the
epoch order (seed, epoch), so the resumed run equals the uninterrupted one.

Under --roi_buckets the train epoch is the store's bucketed stream (each
batch at its bucket's roi count) and its steps are the bucket counts; eval,
predict and the ensemble read one batch composition, `eval_batch_stream`.
The feature tables are held at --feature_dtype.

Blocks (JAX's --train_block and --eval_block): on the device path the train
epoch is consumed in blocks of K same-bucket batches (`resolve_train_block`:
8 by default, 1 on the host path), each block run as K steps with no host
read between them; the step line, step checkpoints and the preemption poll
fall on block boundaries, and a mid-epoch resume skips whole blocks. Eval,
predict and the ensemble read `blocked_eval_stream`, K = --eval_block. On
CUDA each step is a replay of its shape's CUDA graph (train/graphs.py,
train/step.py::TrainSteps and EvalSteps); on the CPU, which runs only when
the caller asks for it, the same steps run eagerly.

--grad_accum k runs each optimizer step as k strided microbatches with one
update (train/step.py); under --roi_buckets they run at their batch's
bucket R.

Tensor parallelism (--tp_size > 1, parallel/mesh.py): the tp ranks of a
data group take the same rows; the model's split leaves are each rank's
part (models/regat.py), the steps run eagerly (train/step.py::eager_reason,
logged once), the sums over the data group. After the init and after a
resume the parameters are broadcast over each data group from its first
rank, and every checkpoint gathers the split leaves first, so `state.npz`
holds full leaves at any tp.

Observability (JAX loop.py:228-232, :437): --profile_dir traces each
epoch's train steps with `data` spans around the fetch of each block
(`_DataPath.train_stream`) and `step` and `upload` spans around its steps
(train/step.py::TrainSteps) and the steps' phase marks on the device's
clock; after the run's first eval pass the log carries the `[setup]` line
of the process's set-up totals (train/profiling.py); --profile_port serves
`/capture` and starts and stops its profiler at the loop's step boundaries
(train/profiling.py), and --debug_nans runs the steps eagerly under
train/debug_nans.py's checks, inside `pending_joined`, so an async write
issued before its FloatingPointError is complete on disk.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.features import VQADataset
from tf_vqa_regat_tpu_torch.data.loader import BatchLoader, prefetch_to_device
from tf_vqa_regat_tpu_torch.data.ordering import ORDER_VERSION
from tf_vqa_regat_tpu_torch.data.sharded_store import (
    ShardedDeviceStore,
    estimate_sharded_nbytes,
)
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, estimate_nbytes, gather_batch
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.parallel import distributed
from tf_vqa_regat_tpu_torch.parallel.mesh import Mesh, batch_slice, make_mesh
from tf_vqa_regat_tpu_torch.params import full_state, load_state_arrays
from tf_vqa_regat_tpu_torch.train import checkpoint as ckpt
from tf_vqa_regat_tpu_torch.train import debug_nans, profiling
from tf_vqa_regat_tpu_torch.train.logging import Logger, MetricsWriter, time_since
from tf_vqa_regat_tpu_torch.train.optim import (
    DECAY_START_EPOCH,
    WARMUP_FACTORS,
    Adamax,
    make_lr_schedule,
)
from tf_vqa_regat_tpu_torch.train.graphs import StepGraphs, to_device
from tf_vqa_regat_tpu_torch.train.step import (
    EvalSteps,
    TrainSteps,
    eager_line,
    gathers_rows,
    real_batches,
    resolve_graphed,
)

Metrics = Dict[str, torch.Tensor]


class Preempted(RuntimeError):
    """Training was interrupted (SIGTERM, or the REGAT_FAULT_PREEMPT_STEP
    fault hook) and a step checkpoint was saved. main.py catches this, skips
    the final artifact and exits cleanly: rerun the same command with
    --resume to continue from that step."""


class _PreemptWatcher:
    """SIGTERM -> save at the next dispatch boundary, then exit cleanly. A
    handler on the main thread sets a flag polled at each dispatch boundary
    (after every train block: every optimizer step under --train_block 1);
    `REGAT_FAULT_PREEMPT_STEP=<global step>` fires at the first boundary at
    or after that step (>=: a step inside a block fires at the block's
    end, as a real SIGTERM would). The previous handler is restored on
    exit. With more than one rank the poll is a MAX all-reduce of the local
    flag, so a SIGTERM to any one rank makes every rank save at the same
    boundary (JAX's preemption sync point): every rank polls at the same
    boundaries."""

    def __init__(self) -> None:
        self._flag = False
        self._prev: Any = None
        self._registered = False
        env = os.environ.get("REGAT_FAULT_PREEMPT_STEP", "")
        self._fault_step = int(env) if env else -1

    def __enter__(self) -> "_PreemptWatcher":
        if threading.current_thread() is threading.main_thread():
            self._prev = signal.signal(signal.SIGTERM, self._on_signal)
            self._registered = True
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._registered:
            # None (a handler installed from C) restores the default action
            signal.signal(signal.SIGTERM, signal.SIG_DFL if self._prev is None else self._prev)

    def _on_signal(self, signum: Any, frame: Any) -> None:
        self._flag = True

    def poll(self, global_step: int) -> bool:
        return distributed.any_rank(self._flag or 0 <= self._fault_step <= global_step)


# --train_block 0 (auto) resolves to this on the device store (JAX's
# default, loop.py:131-138)
AUTO_TRAIN_BLOCK = 8


def resolve_train_block(cfg: Config, data_mode: str) -> int:
    """The effective train block K: --train_block 0 means AUTO_TRAIN_BLOCK
    on the device and sharded stores and 1 on the host path, which streams
    one batch at a time; an explicit K is K (and refused on the host path by
    _DataPath)."""
    if cfg.train_block == 0:
        return AUTO_TRAIN_BLOCK if data_mode in ("device", "sharded") else 1
    return cfg.train_block


def _run_signature(cfg: Config, steps_per_epoch: int, data_mode: str,
                   dp: int = 1) -> Dict[str, Any]:
    """Everything the seeded epoch order depends on, with the JAX keys: a
    step checkpoint records it and a mid-epoch resume refuses another.
    `data_mode` is the resolved one and `dp` the data-parallel size, so a
    mid-epoch resume across modes or topologies (the sharded store draws
    per-shard permutations) is refused, as JAX refuses it; so is one across
    another effective train block, whose blocks group the bucketed stream
    otherwise. The bucket list is the parsed one, so '100,64' and '64, 100'
    sign alike."""
    return {
        "batch_size": int(cfg.batch_size),
        "seed": int(cfg.seed),
        "steps_per_epoch": int(steps_per_epoch),
        "order": int(ORDER_VERSION),
        "roi_buckets": list(cfg.parsed_roi_buckets() or []),
        "data_mode": str(data_mode),
        "dp": int(dp),
        "train_block": int(resolve_train_block(cfg, data_mode)),
    }


def _resume_point(
    cfg: Config, N: int, data_mode: str, model: ReGAT, opt: Adamax, dp: int = 1,
) -> Tuple[int, int, Optional[Dict[str, float]], float]:
    """--resume: restore the newest checkpoint into `model` and `opt` ->
    (first epoch, steps of it already taken, its accumulators or None, best
    score); (0, 0, None, -1.0) when there is none. Raises when the run's
    signature differs from the one a step checkpoint was written under, or
    when an epoch checkpoint was written at another steps_per_epoch (the LR
    is keyed to the step count)."""
    latest = ckpt.latest_checkpoint(cfg.output)
    if latest is None:
        return 0, 0, None, -1.0
    load_state_arrays(model, opt, ckpt.restore_checkpoint(latest))
    meta = ckpt.restore_meta_full(cfg.output) or {}
    best_score = float(meta.get("best_score", -1.0))
    restored = os.path.basename(latest)
    sig_saved = meta.get("run")
    if "step_in_epoch" in meta and meta.get("dir") == restored:
        # a mid-epoch resume replays the same epoch order past the saved step
        sig_now = _run_signature(cfg, N, data_mode, dp)
        diffs = {
            k: (sig_saved.get(k), sig_now.get(k))
            for k in (sig_saved or {}) if sig_saved.get(k) != sig_now.get(k)
        }
        # checked even when the writer did not record them (defaults 1)
        for k in ("order", "train_block"):
            if sig_saved is not None and sig_saved.get(k, 1) != sig_now[k]:
                diffs[k] = (sig_saved.get(k, 1), sig_now[k])
        if sig_saved is not None and diffs:
            raise ValueError(
                "mid-epoch resume requires the run configuration that wrote the "
                f"step checkpoint (saved vs current: {diffs}); rerun with the "
                "original settings, or resume from an epoch-boundary checkpoint"
            )
        return int(meta["epoch"]), int(meta["step_in_epoch"]), meta.get("acc") or None, best_score
    if meta.get("dir") == restored:
        if sig_saved and "steps_per_epoch" in sig_saved and int(
            sig_saved["steps_per_epoch"]
        ) != N:
            raise ValueError(
                f"resume with a different steps_per_epoch ({sig_saved['steps_per_epoch']} "
                f"saved vs {N} now — batch_size/data change): the optimizer's step "
                "count would misalign the epoch-keyed LR schedule; rerun with the "
                "original settings"
            )
        return int(meta.get("epoch", -1)) + 1, 0, None, best_score
    # meta's dir is gone and latest_checkpoint fell back to the newest
    # complete epoch: the epoch comes from that directory, and meta's skip
    # (steps the restored state never took) is ignored
    return int(restored.split("_")[1]) + 1, 0, None, best_score


def check_grad_accum(cfg: Config, dp: int = 1) -> None:
    """Refuse a batch size that the data-parallel size dp, or --grad_accum
    times dp, does not divide, with the JAX package's messages."""
    if cfg.batch_size % dp != 0:
        raise ValueError(
            f"batch_size {cfg.batch_size} must be divisible by the data-mesh "
            f"size {dp} (the batch dim is sharded over it)"
        )
    if cfg.grad_accum > 1 and cfg.batch_size % (cfg.grad_accum * dp) != 0:
        raise ValueError(
            f"batch_size {cfg.batch_size} must be divisible by "
            f"grad_accum*dp = {cfg.grad_accum}*{dp} (each microbatch's batch "
            f"dim is sharded over the data mesh)"
        )


def _zeros(device: torch.device) -> Metrics:
    return {k: torch.zeros((), device=device) for k in ("score", "loss_sum", "n")}


def _accumulate(acc: Metrics, m: Metrics) -> None:
    acc["score"] += m["score"]
    acc["loss_sum"] += m["loss"] * m["n"]
    acc["n"] += m["n"]


def _log_progress(logger, acc: Metrics, last: torch.Tensor, epoch, i, N, start) -> None:
    """The print_freq step line: last loss (running mean)."""
    mean = float(acc["loss_sum"]) / max(float(acc["n"]), 1.0)
    elapsed = time_since(start, float(i + 1) / N)
    logger.write(
        f"Epoch [{epoch+1}][{i}/{N}] Elapsed {elapsed} "
        f"Loss: {float(last):.5f}({mean:.5f})"
    )


def build_store(
    cfg: Config, ds: VQADataset, device: torch.device, targets: bool = True,
    mode: str = "device", mesh: Optional[Mesh] = None, warn: bool = True,
):
    """The split's store for a resolved device-resident mode, at
    --feature_dtype, through --packed_cache (JAX loop.py::build_store):
    'device' replicates the tables with the split's edge labels for an
    explicit relation type; 'sharded' holds this rank's shard, with the
    semantic table only (spatial labels are built in the step from the
    boxes). With `warn`, under --roi_buckets, prints the JAX package's clamp
    warning when an image has more boxes than the largest bucket."""
    if mode == "sharded":
        mesh = mesh if mesh is not None else Mesh(dp=1)
        store = ShardedDeviceStore(ds, device, mesh.data, mesh.dp, targets, cfg.feature_dtype,
                                   include_adj=cfg.relation_type == "semantic",
                                   cache_dir=cfg.packed_cache)
    else:
        store = DeviceStore(ds, device, targets, cfg.feature_dtype,
                            include_adj=cfg.relation_type != "implicit",
                            cache_dir=cfg.packed_cache)
    if not warn:
        return store
    buckets = cfg.parsed_roi_buckets()
    if buckets and store.num_entries:
        max_boxes = int(store.entry_nbox.max())
        if max_boxes > max(buckets):
            print(
                f"[roi_buckets] images with up to {max_boxes} boxes "
                f"truncate to the largest bucket ({max(buckets)}) "
                f"— same clamp as --num_rois {max(buckets)}"
            )
    return store


def steps_per_epoch(cfg: Config, store: DeviceStore, batch_size: int) -> int:
    """Batches of one pass over the store at `batch_size`: the bucket counts
    under --roi_buckets."""
    buckets = cfg.parsed_roi_buckets()
    if buckets:
        return store.bucketed_steps_per_epoch(batch_size, buckets)
    return store.steps_per_epoch(batch_size)


def train_batch_stream(
    cfg: Config, store: DeviceStore, epoch: int
) -> Iterator[Tuple[int, np.ndarray]]:
    """The epoch's shuffled (R, idx) train batches: the bucketed stream
    under --roi_buckets, else the epoch permutation at the one static roi
    count."""
    buckets = cfg.parsed_roi_buckets()
    if buckets:
        return store.epoch_indices_bucketed(epoch, cfg.batch_size, buckets, True, cfg.seed)
    R0 = cfg.resolved_num_rois()
    return ((R0, idx) for idx in store.epoch_indices(epoch, cfg.batch_size, True, cfg.seed))


def eval_batch_stream(
    cfg: Config, store: DeviceStore, eval_batch: int
) -> Iterator[Tuple[int, np.ndarray]]:
    """The one eval batch composition, which eval, predict and the ensemble
    all read, so they cannot disagree on which entries a batch holds: the
    in-order (R, idx) stream, per bucket under --roi_buckets (JAX
    loop.py::eval_batch_stream)."""
    buckets = cfg.parsed_roi_buckets()
    if buckets:
        return store.epoch_indices_bucketed(0, eval_batch, buckets, False, cfg.seed)
    R0 = cfg.resolved_num_rois()
    return ((R0, idx) for idx in store.epoch_indices(0, eval_batch, False, cfg.seed))


def _block_batches_counted(
    batches: Iterable[Tuple[int, np.ndarray]], K: int, batch_size: int
) -> Iterator[Tuple[int, np.ndarray, int]]:
    """Group a stream of (R, idx[B]) batches into (R, idx_block[K, B],
    nreal) blocks, keeping the stream's order within each R; `nreal` is the
    number of real batches in the block. A block is yielded when its R has K
    batches; at the end each R's partial block is padded with all -1
    batches (JAX loop.py::_block_batches_counted)."""
    pending: Dict[int, list] = {}
    for R, idx in batches:
        pending.setdefault(R, []).append(idx)
        if len(pending[R]) == K:
            yield R, np.stack(pending.pop(R)), K
    for R, lst in pending.items():
        pad = [np.full(batch_size, -1, np.int32)] * (K - len(lst))
        yield R, np.stack(lst + pad), len(lst)


def _block_batches(
    batches: Iterable[Tuple[int, np.ndarray]], K: int, batch_size: int
) -> Iterator[Tuple[int, np.ndarray]]:
    """The eval-facing view of _block_batches_counted: (R, idx_block[K, B])."""
    for R, blk, _ in _block_batches_counted(batches, K, batch_size):
        yield R, blk


def blocked_eval_stream(
    cfg: Config, store: DeviceStore, eval_batch: int
) -> Tuple[int, list, Iterator[Tuple[int, np.ndarray]]]:
    """eval_batch_stream grouped into [K, B] blocks, K = --eval_block (0
    counts as 1), for eval, predict and the ensemble -> (K, the roi sizes,
    the stream of (R, idx_block[K, B])) (JAX loop.py::blocked_eval_stream
    at one device)."""
    K = max(cfg.eval_block, 1)
    sizes = cfg.parsed_roi_buckets() or [cfg.resolved_num_rois()]
    return K, sizes, _block_batches(eval_batch_stream(cfg, store, eval_batch), K, eval_batch)


def resolve_data_mode(
    cfg: Config, val_ds: VQADataset, train_ds: Optional[VQADataset], include_adj: bool,
    extra_bytes: int = 0, dp: int = 1, extra_sharded: Optional[int] = None,
) -> str:
    """The one data-path policy (JAX loop.py::resolve_data_mode): a forced
    --data_mode as given; under 'auto', 'device' when every split's tables
    (estimate_nbytes at --feature_dtype) plus `extra_bytes` (arrays the
    caller keeps on the card beside the store: the ensemble's member
    edge-label tables) fit the budget, the whole of it for eval-only use
    (`train_ds` None) and half of it per split with a train split; else
    'sharded' when dp > 1 and every split's per-shard tables
    (estimate_sharded_nbytes, with the semantic table only, as build_store
    builds it) plus `extra_sharded` (those arrays' share on one shard,
    default extra_bytes // dp) fit; else 'host'. One mode for every
    split."""
    if cfg.data_mode != "auto":
        return cfg.data_mode
    per_store = _per_store_budget(cfg, train_ds)
    splits = [val_ds] + ([train_ds] if train_ds is not None else [])
    if all(estimate_nbytes(ds, include_adj, cfg.feature_dtype) + extra_bytes <= per_store
           for ds in splits):
        return "device"
    adj_sharded = include_adj and cfg.relation_type == "semantic"
    if dp > 1 and all(
            estimate_sharded_nbytes(ds, adj_sharded, cfg.feature_dtype, dp)
            + (extra_bytes // dp if extra_sharded is None else extra_sharded) <= per_store
            for ds in splits):
        return "sharded"
    return "host"


def _per_store_budget(cfg: Config, train_ds: Optional[VQADataset]) -> int:
    budget = int(cfg.device_store_budget_gb * 1e9)
    return budget // 2 if train_ds is not None else budget


def data_mode_line(
    cfg: Config, mode: str, val_ds: VQADataset, train_ds: Optional[VQADataset],
    include_adj: bool, extra_bytes: int = 0, dp: int = 1,
) -> str:
    """The log line of a resolved data path: the mode, each split's
    estimate (per shard in sharded mode) and the budget it was held to
    (JAX's `data=` tag)."""
    splits = ([train_ds] if train_ds is not None else []) + [val_ds]

    def est(ds):
        if mode == "sharded":
            return estimate_sharded_nbytes(
                ds, include_adj and cfg.relation_type == "semantic", cfg.feature_dtype, dp)
        return estimate_nbytes(ds, include_adj, cfg.feature_dtype) + extra_bytes

    per = f" per shard of {dp}" if mode == "sharded" else ""
    sizes = ", ".join(f"{ds.name} {est(ds) / 1e9:.4f} GB{per}" for ds in splits)
    return (f"[data] data={mode} (--data_mode {cfg.data_mode}): {sizes} at --feature_dtype "
            f"{cfg.feature_dtype} against {_per_store_budget(cfg, train_ds) / 1e9:.4f} GB per "
            f"split (--device_store_budget_gb {cfg.device_store_budget_gb:g}"
            f"{', halved for a train split' if train_ds is not None else ''})")


def check_roi_buckets_mode(cfg: Config, mode: str) -> None:
    """--roi_buckets needs device-resident tables (each bucket's batch is
    gathered on the card): refuse the host path, with JAX's message."""
    if cfg.parsed_roi_buckets() and mode == "host":
        raise ValueError(
            f"--roi_buckets requires the device or sharded data mode "
            f"(resolved mode: {mode!r}); per-size compiled programs need "
            f"device-resident tables. Force --data_mode device/sharded "
            f"or drop --roi_buckets."
        )


def host_loader(cfg: Config, ds: VQADataset, batch_size: int, shuffle: bool,
                include_adj: bool = True, mesh: Optional[Mesh] = None) -> BatchLoader:
    """The split's host loader at the config's roi count and feature dtype,
    with the split's edge labels for an explicit relation type, packing this
    rank's rows of each global batch."""
    mesh = mesh if mesh is not None else Mesh(dp=1)
    return BatchLoader(ds, batch_size, cfg.resolved_num_rois(), shuffle, seed=cfg.seed,
                       include_adj=include_adj and cfg.relation_type != "implicit",
                       feature_dtype=cfg.feature_dtype, shard=(mesh.data, mesh.dp))


_END = object()


def _spanned(name: str, items: Iterable[Any]) -> Iterator[Any]:
    """`items`, each fetched inside the host span `name`
    (train/profiling.py::annotate)."""
    it = iter(items)
    while True:
        with profiling.annotate(name):
            item = next(it, _END)
        if item is _END:
            return
        yield item


class _DataPath:
    """The resolved data path of a train or eval run (JAX `_DataPath`): the
    device or sharded stores with the on-card gather, or the host loaders
    with the prefetch, each rank taking its rows of `mesh`'s global batches.
    `train_ds` None: eval only. The device and host paths yield the same
    batches (data/loader.py)."""

    def __init__(self, cfg: Config, train_ds: Optional[VQADataset], val_ds: VQADataset,
                 device: torch.device, logger: Logger, mesh: Optional[Mesh] = None):
        self.cfg, self.device = cfg, device
        self.mesh = mesh = mesh if mesh is not None else Mesh(dp=1)
        include_adj = cfg.relation_type != "implicit"
        self.mode = resolve_data_mode(cfg, val_ds, train_ds, include_adj, dp=mesh.dp)
        check_roi_buckets_mode(cfg, self.mode)
        # an explicit K > 1 on the host path is refused; auto resolves to 1 there
        if cfg.train_block > 1 and train_ds is not None and self.mode == "host":
            raise ValueError(
                f"--train_block requires the device or sharded data mode "
                f"(resolved mode: {self.mode!r}); the scanned block gathers its "
                f"K batches from device-resident tables. Force --data_mode "
                f"device/sharded or drop --train_block."
            )
        self.train_block = resolve_train_block(cfg, self.mode)
        logger.write(data_mode_line(cfg, self.mode, val_ds, train_ds, include_adj, dp=mesh.dp))
        self.eval_batch = cfg.resolved_eval_batch(mesh.dp)
        self.eval_entries = len(val_ds)
        if self.mode in ("device", "sharded"):
            self.train_store = (None if train_ds is None
                                else build_store(cfg, train_ds, device, mode=self.mode, mesh=mesh))
            self.eval_store = build_store(cfg, val_ds, device, mode=self.mode, mesh=mesh,
                                          warn=train_ds is None)
            self.steps_per_epoch = (0 if train_ds is None
                                    else steps_per_epoch(cfg, self.train_store, cfg.batch_size))
            self.eval_steps = self._eval_block_count()
        else:
            self.train_store = self.eval_store = None
            self.train_loader = (None if train_ds is None
                                 else host_loader(cfg, train_ds, cfg.batch_size, True, mesh=mesh))
            self.eval_loader = host_loader(cfg, val_ds, self.eval_batch, False, mesh=mesh)
            self.steps_per_epoch = 0 if train_ds is None else len(self.train_loader)
            self.eval_steps = len(self.eval_loader)

    def _eval_block_count(self) -> int:
        """The number of eval blocks the device or sharded path yields (the
        `eval data loader len` line; JAX loop.py::_eval_block_count)."""
        K = max(self.cfg.eval_block, 1)
        buckets = self.cfg.parsed_roi_buckets()
        if buckets:
            counts = self.eval_store.bucketed_batch_counts(self.eval_batch, buckets)
            return sum(-(-b // K) for b in counts if b > 0)
        return -(-self.eval_store.steps_per_epoch(self.eval_batch) // K)

    def train_stream(self, epoch: int, skip: int = 0) -> Iterator[Tuple[int, Any]]:
        """The epoch's train dispatches past the first `skip` steps as
        (nsteps, item), the loop's step count advancing by nsteps per item
        (JAX `_DataPath.train_stream`): on the device path (R, idx_block[K,
        B]) blocks of the train stream, K = the effective --train_block,
        nsteps its real batches (within a bucket the order is the per-step
        one; across buckets the optimizer meets K same-R batches in a row);
        on the host path (1, batch on the device). `skip` is consumed in
        whole blocks: a skip that falls inside a block raises."""
        cfg = self.cfg
        if self.mode == "host":
            with contextlib.closing(prefetch_to_device(
                    self.train_loader, self.device, epoch, skip, cfg.prefetch)) as batches:
                for batch in _spanned("data", batches):
                    yield 1, batch
            return
        K = self.train_block
        raw = train_batch_stream(cfg, self.train_store, epoch)
        consumed = 0
        for R, blk, nreal in _spanned("data", _block_batches_counted(raw, K, cfg.batch_size)):
            if consumed < skip:
                if consumed + nreal > skip:
                    raise ValueError(
                        f"mid-epoch resume at step {skip} does not align "
                        f"with the --train_block {K} dispatch boundaries "
                        f"(block covers steps {consumed}..{consumed + nreal})"
                    )
                consumed += nreal
                continue
            yield nreal, (R, blk)

    def eval_stream(self) -> Iterator[Any]:
        """The split's eval items in entry order (per bucket under
        --roi_buckets): (R, idx_block[K, B]) global blocks of
        blocked_eval_stream on the device and sharded paths, this rank's
        batches on the device on the host path."""
        if self.mode in ("device", "sharded"):
            yield from blocked_eval_stream(self.cfg, self.eval_store, self.eval_batch)[2]
            return
        with contextlib.closing(prefetch_to_device(
                self.eval_loader, self.device, depth=self.cfg.prefetch)) as batches:
            yield from batches

    def eval_steps_of(self, model: ReGAT, graphed: Optional[bool] = None,
                      pool: Any = None, debug_nans: bool = False) -> EvalSteps:
        """`model`'s eval steps on this path (graphed on CUDA unless
        train/step.py::eager_reason gives a reason)."""
        return EvalSteps(model, self.device, self.eval_store, graphed, pool, self.mesh,
                         debug_nans)


def _run_eval(
    steps: EvalSteps, data: _DataPath, cfg: Config, epoch: int, logger: Logger,
    device: torch.device,
) -> Tuple[float, float, float]:
    """One pass over the split in entry order (per bucket under
    --roi_buckets), a block per item on the device path -> (score %, mean
    loss, s)."""
    N = data.eval_steps
    logger.write("[DEBUG] Evaluation Start")
    logger.write(f"[DEBUG] total eval data len: {data.eval_entries}")
    logger.write(f"[DEBUG] eval data loader len: {N}")
    acc = _zeros(device)
    start = time.time()
    with contextlib.closing(data.eval_stream()) as items:
        for i, item in enumerate(items):
            m = steps.block(*item) if data.mode != "host" else steps.batch(item)
            _accumulate(acc, m)
            if cfg.print_freq > 0 and (i + 1) % cfg.print_freq == 0:
                _log_progress(logger, acc, m["loss"], epoch, i, N, start)
    n = max(float(acc["n"]), 1.0)
    elapsed = time.time() - start
    return 100.0 * float(acc["score"]) / n, float(acc["loss_sum"]) / n, elapsed


def run_training(
    cfg: Config,
    train_ds: VQADataset,
    val_ds: VQADataset,
    model: ReGAT,
    device: torch.device,
    emb2_trainable: bool = False,
) -> Tuple[ReGAT, float]:
    """Train `model` (moved to `device`) for cfg.epochs epochs, evaluating
    after each, or from the newest checkpoint under --resume. Returns
    (model, best eval score %); raises `Preempted` after a preemption save.
    Under a process group every rank calls it with its own device."""
    mesh = make_mesh(cfg.dp_size, cfg.tp_size)
    check_grad_accum(cfg, mesh.dp)
    model.to(device)
    logger = Logger(os.path.join(cfg.output, "log.txt"))
    try:
        data = _DataPath(cfg, train_ds, val_ds, device, logger, mesh)
    except BaseException:
        logger.close()
        raise
    N = data.steps_per_epoch
    lr_fn = make_lr_schedule(cfg.base_lr, N, cfg.lr_decay_rate, cfg.lr_decay_step)
    opt = Adamax(model, trainable_mask(model, emb2_trainable), lr_fn, cfg.grad_clip)

    start_epoch, skip_steps, acc_resume, best_score = 0, 0, None, -1.0
    if cfg.resume:
        try:
            start_epoch, skip_steps, acc_resume, best_score = _resume_point(
                cfg, N, data.mode, model, opt, mesh.dp)
        except BaseException:
            logger.close()
            raise
    # every rank starts from its data group's first rank's parameters and
    # moments (the same part of each split leaf)
    distributed.broadcast_([*opt.params, *opt.mu, *opt.nu, opt.count_t], src=mesh.model,
                           group=mesh.data_group())
    run_sig = _run_signature(cfg, N, data.mode, mesh.dp)
    line = eager_line(mesh, gathers_rows(model), cfg.debug_nans)
    if line:
        logger.write(line)
    # the graphs capture the restored tensors: no step runs before the resume
    train = TrainSteps(model, opt, cfg, device, data.train_store, mesh=mesh)
    evaluate = data.eval_steps_of(model, pool=train.graphs.pool, debug_nans=cfg.debug_nans)
    try:
        capture = profiling.maybe_start_server(cfg.profile_port,
                                               os.path.join(cfg.output, "profile"),
                                               cfg.profile_dir)
    except BaseException:
        logger.close()
        raise

    metrics_writer = MetricsWriter(os.path.join(cfg.output, "metrics.jsonl"))
    logger.write(
        "optim: adamax lr=%.4f, decay_step=%d, decay_rate=%.2f,"
        % (cfg.base_lr, cfg.lr_decay_step, cfg.lr_decay_rate)
        + "grad_clip=%.2f" % cfg.grad_clip
    )
    # an exception anywhere (--debug_nans' FloatingPointError among them)
    # still joins the in-flight async write, so every checkpoint issued
    # before it is on disk; closing the batch stream ends the host path's
    # prefetch thread
    try:
        with ckpt.pending_joined(), _PreemptWatcher() as preempt, \
                debug_nans.watching(model, cfg.debug_nans):
            for epoch in range(start_epoch, cfg.epochs):
                skip = skip_steps if epoch == start_epoch else 0
                lr_now = lr_fn(epoch * N)
                # the LR line prints at every warmup epoch and at each decay
                # epoch; the from-value is the previous epoch's LR
                lr_old = lr_fn((epoch - 1) * N) if epoch > 0 else cfg.base_lr
                is_decay = (
                    epoch >= DECAY_START_EPOCH
                    and (epoch - DECAY_START_EPOCH) % cfg.lr_decay_step == 0
                )
                if epoch < len(WARMUP_FACTORS) or is_decay:
                    logger.write(
                        f"\nEpoch: {epoch}. Reducing Learning Rate from {lr_old} to {lr_now}"
                    )
                logger.write("--" * 50)
                logger.write(f"[DEBUG] epoch {epoch}, number of steps: {N}")
                logger.write("--" * 50)

                acc = _zeros(device)
                n_restored = 0.0  # examples the interrupted run already counted
                if skip and acc_resume is not None:
                    acc = {
                        k: torch.tensor(float(acc_resume.get(k, 0.0)), device=device)
                        for k in acc
                    }
                    n_restored = float(acc_resume.get("n", 0.0))
                start = time.time()
                done = skip  # optimizer steps of this epoch taken
                with profiling.trace_epoch(cfg.profile_dir, epoch), \
                        contextlib.closing(data.train_stream(epoch, skip)) as stream:
                    if capture is not None:
                        capture.poll()
                    for nsteps, item in stream:
                        m = (train.block(*item, nsteps) if data.mode != "host"
                             else train.batch(item))
                        if capture is not None:
                            capture.poll(nsteps)
                        # the block's loss_sum, not loss * n (the last step's
                        # loss weighted by the block's count)
                        for k in acc:
                            acc[k] += m[k]
                        prev, done = done, done + nsteps
                        i = done - 1  # the last step's index in the epoch
                        # a block prints and saves where it crosses a multiple
                        # (per step: (i + 1) % print_freq == 0)
                        if cfg.print_freq > 0 and (
                            done // cfg.print_freq > prev // cfg.print_freq
                        ):
                            _log_progress(logger, acc, m["loss"], epoch, i, N, start)
                        preempted = preempt.poll(epoch * N + done)
                        if preempted or (
                            cfg.checkpoint_every_steps > 0
                            and done // cfg.checkpoint_every_steps
                            > prev // cfg.checkpoint_every_steps
                            and done < N  # the epoch save supersedes it
                        ):
                            waited = ckpt.save_checkpoint(
                                cfg.output, full_state(model, opt), epoch, best_score, False,
                                step_in_epoch=done,
                                acc={k: float(v) for k, v in acc.items()},
                                # a preemption save must be on disk before exit
                                block=preempted or not cfg.async_checkpoint,
                                run_sig=run_sig, retain=cfg.keep_ckpts,
                            )
                            if waited > 1.0 and not preempted:
                                logger.write(
                                    f"[ckpt] async save back-pressure: waited "
                                    f"{waited:.1f}s for the previous write — "
                                    f"raise --checkpoint_every_steps (background "
                                    f"fetch+write outlasts the save cadence)"
                                )
                            if preempted:
                                logger.write(
                                    f"[preempt] checkpoint saved at epoch {epoch} "
                                    f"step {done}; exiting — rerun with --resume"
                                )
                                raise Preempted(f"epoch {epoch} step {done}")
                n = max(float(acc["n"]), 1.0)
                train_score = 100.0 * float(acc["score"]) / n
                train_time = time.time() - start

                eval_score, eval_loss, eval_time = _run_eval(
                    evaluate, data, cfg, epoch, logger, device
                )
                logger.write(
                    f"[DEBUG] train_score: {train_score:.4f} eval_score: {eval_score:.4f}"
                )
                if epoch == start_epoch:
                    logger.write(profiling.setup_line())
                metrics_writer.write({
                    "epoch": epoch,
                    "lr": lr_now,
                    "train_loss": float(acc["loss_sum"]) / n,
                    "train_score": train_score,
                    "eval_score": eval_score,
                    "eval_loss": eval_loss,
                    "train_time_s": train_time,
                    "eval_time_s": eval_time,
                    # only the examples this run stepped count
                    "train_qps": (float(acc["n"]) - n_restored) / max(train_time, 1e-9),
                })
                is_best = eval_score > best_score
                best_score = max(best_score, eval_score)
                if cfg.save_every_epoch:
                    waited = ckpt.save_checkpoint(
                        cfg.output, full_state(model, opt), epoch, best_score, is_best,
                        block=not cfg.async_checkpoint, run_sig=run_sig,
                        retain=cfg.keep_ckpts,
                    )
                    if waited > 1.0:
                        logger.write(
                            f"[ckpt] async save back-pressure: waited "
                            f"{waited:.1f}s for the previous epoch's write "
                            f"(epochs finish faster than the background "
                            f"fetch+write can drain)"
                        )
    finally:
        if capture is not None:
            capture.close()
        logger.close()
        metrics_writer.close()
    return model, best_score


def run_evaluation(
    cfg: Config, val_ds: VQADataset, model: ReGAT, device: torch.device,
    logger: Logger,
) -> Tuple[float, float, float]:
    """`--mode eval`: one eval pass over the split -> (score %, mean loss, s)."""
    model.to(device)
    mesh = make_mesh(cfg.dp_size, cfg.tp_size)
    data = _DataPath(cfg, None, val_ds, device, logger, mesh)
    line = eager_line(mesh, gathers_rows(model))
    if line:
        logger.write(line)
    return _run_eval(data.eval_steps_of(model), data, cfg, 0, logger, device)


def run_prediction(
    cfg: Config, ds: VQADataset, model: ReGAT, device: torch.device, logger: Logger,
    graphed: Optional[bool] = None,
) -> str:
    """`--mode predict`: one forward pass over the split in entry order,
    the argmax answers written as the VQA submission JSON
    (`[{"question_id": int, "answer": str}, ...]`) to
    `{output}/{relation_type}-{fusion}-{split}-predictions.json`. The device
    path reads no soft targets (the host path's are zero on an answerless
    split), so an answerless split works; raises if an entry is missed.
    The device and sharded paths run blocked_eval_stream's blocks; each
    forward pass is a replay of its R's graph on CUDA (`graphed`,
    train/graphs.py). Under a process group each rank answers its rows of
    every batch (a sharded rank's local entry ids mapped to the split's), the
    answers are summed over the data group and rank 0 writes the file."""
    model.to(device).eval()
    mesh = make_mesh(cfg.dp_size, cfg.tp_size)
    include_adj = cfg.relation_type != "implicit"
    mode = resolve_data_mode(cfg, ds, None, include_adj, dp=mesh.dp)
    check_roi_buckets_mode(cfg, mode)
    logger.write(data_mode_line(cfg, mode, ds, None, include_adj, dp=mesh.dp))
    line = eager_line(mesh, gathers_rows(model))
    if line:
        logger.write(line)
    qids = ds.entries.question_ids
    # -1-filled: a coverage gap fails the label2ans lookup, never writes garbage
    answers = np.full(len(qids), -1, dtype=np.int64)
    seen = np.zeros(len(qids), bool)
    pending = []  # (host entry indices, device labels), fetched once at the end
    eval_batch = cfg.resolved_eval_batch(mesh.dp)
    store = (build_store(cfg, ds, device, targets=False, mode=mode, mesh=mesh)
             if mode != "host" else None)

    def predict(R, inputs, generators):
        batch = inputs if store is None else gather_batch(store, inputs["idx"], R)
        with torch.no_grad():
            return model(batch).argmax(dim=-1)

    def mine(a: np.ndarray) -> np.ndarray:
        return batch_slice(a, mesh.data, mesh.dp)

    steps = StepGraphs(predict, device, resolve_graphed(mesh, graphed, gathers_rows(model)))
    if store is not None:
        for R, blk in blocked_eval_stream(cfg, store, eval_batch)[2]:
            nreal = real_batches(blk)
            entries = mine(store.to_global(blk) if mode == "sharded" else blk)
            idx = to_device(mine(blk)[:nreal], device)
            for j in range(nreal):
                # the graph's output is overwritten by the next replay
                pending.append((entries[j], steps(R, {"idx": idx[j]}).clone()))
    else:
        loader = host_loader(cfg, ds, eval_batch, False, mesh=mesh)
        with contextlib.closing(prefetch_to_device(loader, device, depth=cfg.prefetch)) \
                as batches:
            for pos, batch in zip(range(0, len(qids), eval_batch), batches):
                idx = mine(np.arange(pos, pos + eval_batch))
                pending.append((np.where(idx < len(qids), idx, -1),
                                steps(batch["features"].shape[1], batch).clone()))
    for idx, labels in pending:
        lab = labels.cpu().numpy()
        ok = idx >= 0
        answers[idx[ok]] = lab[ok]
        seen[idx[ok]] = True
    if mesh.group:
        # each entry is answered in one data group: the sum of (answer + 1,
        # else 0) over the data group
        got = torch.from_numpy(np.where(seen, answers + 1, 0)).to(device)
        distributed.all_reduce_([got], group=mesh.data_group())
        got = got.cpu().numpy()
        answers, seen = got - 1, got > 0
    if not seen.all():
        raise RuntimeError(
            f"prediction pass missed {int((~seen).sum())} entries — store/stream "
            "coverage bug; the submission would be invalid"
        )
    out_path = os.path.join(
        cfg.output, f"{cfg.relation_type}-{cfg.fusion}-{ds.name}-predictions.json"
    )
    if not distributed.is_primary():
        logger.write(f"{len(qids)} predictions computed; rank 0 writes {out_path}")
        return out_path
    os.makedirs(cfg.output, exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(
            [{"question_id": int(q), "answer": ds.label2ans[int(a)]}
             for q, a in zip(qids, answers)],
            fh,
        )
    logger.write(f"wrote {len(qids)} predictions to {out_path}")
    return out_path
