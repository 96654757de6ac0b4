"""Train and eval orchestration (counterpart of tf_vqa_regat_tpu/train/loop.py:
`run_training`, `run_evaluation`, `_run_eval`, `_log_progress`), over the
device-resident stores of data/store.py.

The log lines follow the JAX package's (and so the reference's) format: the
optimizer banner, the LR line at every warmup epoch and every decay epoch,
a step line every `print_freq` steps, an eval pass after every epoch and
`[DEBUG] train_score: .. eval_score: ..`. One record per epoch goes to
`{output}/metrics.jsonl` with the JAX keys. The metrics accumulate on the
device and are read at a print and at the end of an epoch.

Not ported (ROADMAP Queue A): per-epoch checkpoints, --resume and
preemption (persistence and the other modes); --grad_accum (multi-device);
--train_block, roi buckets and bf16 or int8 tables (main-path runtime).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.data.synthetic import SyntheticDataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.train.logging import Logger, MetricsWriter, time_since
from tf_vqa_regat_tpu_torch.train.optim import (
    DECAY_START_EPOCH,
    WARMUP_FACTORS,
    Adamax,
    make_lr_schedule,
)
from tf_vqa_regat_tpu_torch.train.step import eval_step, train_step

Metrics = Dict[str, torch.Tensor]


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


def _batches(
    store: DeviceStore, indices: Iterable[np.ndarray], num_rois: int, device: torch.device
):
    for idx in indices:
        yield gather_batch(store, torch.from_numpy(idx).to(device), num_rois)


def _run_eval(
    model: ReGAT, store: DeviceStore, cfg: Config, epoch: int, logger: Logger,
    device: torch.device,
) -> Tuple[float, float, float]:
    """One pass over the split in entry order -> (score %, mean loss, s)."""
    B = cfg.resolved_eval_batch()
    N = store.steps_per_epoch(B)
    logger.write("[DEBUG] Evaluation Start")
    logger.write(f"[DEBUG] total eval data len: {store.num_entries}")
    logger.write(f"[DEBUG] eval data loader len: {N}")
    acc = _zeros(device)
    start = time.time()
    indices = store.epoch_indices(0, B, shuffle=False, seed=cfg.seed)
    for i, batch in enumerate(_batches(store, indices, cfg.resolved_num_rois(), device)):
        m = eval_step(model, batch)
        _accumulate(acc, m)
        if cfg.print_freq > 0 and (i + 1) % cfg.print_freq == 0:
            _log_progress(logger, acc, m["loss"], epoch, i, N, start)
    n = max(float(acc["n"]), 1.0)
    elapsed = time.time() - start
    return 100.0 * float(acc["score"]) / n, float(acc["loss_sum"]) / n, elapsed


def run_training(
    cfg: Config,
    train_ds: SyntheticDataset,
    val_ds: SyntheticDataset,
    model: ReGAT,
    device: torch.device,
    emb2_trainable: bool = False,
) -> Tuple[ReGAT, float]:
    """Train `model` (moved to `device`) for cfg.epochs epochs, evaluating
    after each. Returns (model, best eval score %)."""
    model.to(device)
    train_store = DeviceStore(train_ds, device)
    eval_store = DeviceStore(val_ds, device)
    R = cfg.resolved_num_rois()
    N = train_store.steps_per_epoch(cfg.batch_size)
    lr_fn = make_lr_schedule(cfg.base_lr, N, cfg.lr_decay_rate, cfg.lr_decay_step)
    opt = Adamax(model, trainable_mask(model, emb2_trainable), lr_fn, cfg.grad_clip)

    logger = Logger(os.path.join(cfg.output, "log.txt"))
    metrics_writer = MetricsWriter(os.path.join(cfg.output, "metrics.jsonl"))
    logger.write(
        "optim: adamax lr=%.4f, decay_step=%d, decay_rate=%.2f,"
        % (cfg.base_lr, cfg.lr_decay_step, cfg.lr_decay_rate)
        + "grad_clip=%.2f" % cfg.grad_clip
    )
    best_score = -1.0
    try:
        for epoch in range(cfg.epochs):
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
            start = time.time()
            indices = train_store.epoch_indices(epoch, cfg.batch_size, True, cfg.seed)
            for i, batch in enumerate(_batches(train_store, indices, R, device)):
                m = train_step(model, opt, batch, opt.count, cfg.seed)
                _accumulate(acc, m)
                if cfg.print_freq > 0 and (i + 1) % cfg.print_freq == 0:
                    _log_progress(logger, acc, m["loss"], epoch, i, N, start)
            n = max(float(acc["n"]), 1.0)
            train_score = 100.0 * float(acc["score"]) / n
            train_time = time.time() - start

            eval_score, eval_loss, eval_time = _run_eval(
                model, eval_store, cfg, epoch, logger, device
            )
            logger.write(
                f"[DEBUG] train_score: {train_score:.4f} eval_score: {eval_score:.4f}"
            )
            metrics_writer.write({
                "epoch": epoch,
                "lr": lr_now,
                "train_loss": float(acc["loss_sum"]) / n,
                "train_score": train_score,
                "eval_score": eval_score,
                "eval_loss": eval_loss,
                "train_time_s": train_time,
                "eval_time_s": eval_time,
                "train_qps": float(acc["n"]) / max(train_time, 1e-9),
            })
            best_score = max(best_score, eval_score)
    finally:
        logger.close()
        metrics_writer.close()
    return model, best_score


def run_evaluation(
    cfg: Config, val_ds: SyntheticDataset, model: ReGAT, device: torch.device,
    logger: Logger,
) -> Tuple[float, float, float]:
    """`--mode eval`: one eval pass over the split -> (score %, mean loss, s)."""
    model.to(device)
    return _run_eval(model, DeviceStore(val_ds, device), cfg, 0, logger, device)
