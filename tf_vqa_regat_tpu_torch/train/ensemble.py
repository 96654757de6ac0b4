"""Three-branch ReGAT ensemble evaluation (counterpart of
tf_vqa_regat_tpu/train/ensemble.py at one process: its device-resident and
host paths).

Members are separate checkpoints, each trained with its own
--relation_type and otherwise the flags of this run: member `rt` is built
with `cfg.replace(relation_type=rt)` and loaded from its `.npz` or
checkpoint directory. At eval time every member runs on the same batch and
the sigmoid answer probabilities are averaged before the argmax VQA score.

The data path is train/loop.py's `resolve_data_mode`, with the members'
edge-label tables counted beside the store (JAX ensemble.py:300-330). On
the device path the split's tables are uploaded once, at --feature_dtype,
and shared; the batches are the ones eval and predict read (train/loop.py::
blocked_eval_stream, --eval_block batches per block), per bucket under
--roi_buckets. The shared batch
carries no edge labels: each explicit member adds its own table, uploaded
once and gathered for the batch (JAX ensemble.py:238-256): a semantic
member the split's semantic labels, a spatial member the file's spatial
labels where the split has them; without them it builds its labels from
the boxes in the step, as it does in training. On the host path one shared
loader streams the batches for all members, and each member's edge labels
are packed on the host from the file's table per batch and copied (JAX
ensemble.py:391-).

CLI: --mode ensemble_eval
     --ensemble_checkpoints implicit:PATH,spatial:PATH,semantic:PATH
(any non-empty subset of branches).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_adj, gather_batch
from tf_vqa_regat_tpu_torch.data.features import VQADataset
from tf_vqa_regat_tpu_torch.data.loader import prefetch_to_device
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.params import load_jax_arrays
from tf_vqa_regat_tpu_torch.train.checkpoint import load_params
from tf_vqa_regat_tpu_torch.train.graphs import StepGraphs, to_device
from tf_vqa_regat_tpu_torch.train.logging import Logger
from tf_vqa_regat_tpu_torch.train.loop import (
    blocked_eval_stream,
    build_store,
    check_roi_buckets_mode,
    data_mode_line,
    host_loader,
    resolve_data_mode,
)
from tf_vqa_regat_tpu_torch.train.loss import vqa_score_sum
from tf_vqa_regat_tpu_torch.train.step import real_batches

Member = Tuple[str, ReGAT]
# the host path's per-member edge labels among a graph's inputs
LABELS = "adj_label/"


def parse_members(spec: str) -> List[Tuple[str, str]]:
    """'implicit:P1,spatial:P2' -> [(relation_type, path), ...]."""
    members = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        rt, path = part.split(":", 1)
        if rt not in ("implicit", "spatial", "semantic"):
            raise ValueError(f"unknown ensemble relation_type {rt!r}")
        members.append((rt, path))
    if not members:
        raise ValueError("empty --ensemble_checkpoints")
    return members


def load_members(
    cfg: Config, ds: VQADataset, device: torch.device, logger: Logger
) -> List[Member]:
    """Each member of --ensemble_checkpoints, built under this run's flags
    with its relation type, loaded and in eval mode on `device`. Raises,
    naming the member, when its parameters do not fit those flags."""
    members = []
    for rt, path in parse_members(cfg.ensemble_checkpoints):
        model = ReGAT(cfg.replace(relation_type=rt), ds.ntoken, ds.v_dim, ds.num_ans)
        try:
            load_jax_arrays(model, load_params(path))
        except ValueError as e:
            raise ValueError(
                f"ensemble member {rt}:{path} does not fit this run's flags (every "
                f"member must be trained under them, --relation_type aside): {e}"
            ) from e
        members.append((rt, model.to(device).eval()))
        logger.write(f"[ensemble] loaded {rt} member from {path}")
    return members


def member_adj_sources(members: List[Member], ds: VQADataset) -> Dict[str, np.ndarray]:
    """Relation type -> the split's edge-label table [num_images, A, A] it
    reads, once per type among the members: semantic members the split's
    semantic table (required), spatial members the file's spatial table
    where there is one."""
    sources = {}
    for rt, _ in members:
        src = {"semantic": ds.store.semantic_adj, "spatial": ds.store.spatial_adj}.get(rt)
        if rt == "semantic" and src is None:
            raise ValueError("a semantic member needs the split's edge-label table")
        if src is not None:
            sources[rt] = src
    return sources


def member_adj_tables(
    members: List[Member], ds: VQADataset, device: torch.device
) -> Dict[str, torch.Tensor]:
    """member_adj_sources's tables on `device` as int8."""
    return {rt: torch.from_numpy(src.astype(np.int8)).to(device)
            for rt, src in member_adj_sources(members, ds).items()}


def averaged_probs(
    members: List[Member], store: DeviceStore, idx: torch.Tensor, num_rois: int,
    tables: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(mean of the members' sigmoid answer probabilities [B, num_ans], the
    shared batch) for index vector `idx`; `tables` from member_adj_tables."""
    batch = gather_batch(store, idx, num_rois, adj=False)
    img = store.entry_img[torch.clamp(idx, min=0).long()]
    labels = {rt: gather_adj(table, img, num_rois, batch["valid"])
              for rt, table in tables.items()}
    return member_probs(members, batch, labels), batch


def member_probs(
    members: List[Member], batch: Dict[str, torch.Tensor], labels: Dict[str, torch.Tensor],
) -> torch.Tensor:
    """The mean of the members' sigmoid answer probabilities on `batch`,
    each explicit member reading its edge labels from `labels`."""
    probs = None
    with torch.no_grad():
        for rt, model in members:
            b = dict(batch, adj_label=labels[rt]) if rt in labels else batch
            p = torch.sigmoid(model(b))
            probs = p if probs is None else probs + p
    return probs / len(members)


def run_ensemble_eval(
    cfg: Config, val_ds: VQADataset, device: torch.device, logger: Logger,
    graphed: Optional[bool] = None,
) -> float:
    """The ensemble's VQA score (%) over the split, in entry order. On CUDA
    (`graphed`, train/graphs.py) each batch is a replay of one graph that
    runs every member, as JAX's `one_batch` runs them in one program."""
    members = load_members(cfg, val_ds, device, logger)
    # the members' edge-label tables sit on the card beside the store in
    # device mode, so the budget counts them (int8, one byte each)
    sources = member_adj_sources(members, val_ds)
    extra = sum(int(src.size) for src in sources.values())
    mode = resolve_data_mode(cfg, val_ds, None, False, extra)
    check_roi_buckets_mode(cfg, mode)
    logger.write(data_mode_line(cfg, mode, val_ds, None, False, extra))
    score = torch.zeros((), device=device)
    n = torch.zeros((), device=device)
    start = time.time()
    for probs, batch in (_resident_passes if mode == "device" else _host_passes)(
            cfg, val_ds, device, members, sources, graphed):
        score += vqa_score_sum(probs, batch["target"], batch["valid"])
        n += batch["valid"].to(torch.float32).sum()
    score_pct = 100.0 * float(score) / max(float(n), 1.0)
    logger.write(
        f"[ensemble] members={[rt for rt, _ in members]} data={mode} "
        f"score={score_pct:.4f} ({time.time()-start:.1f}s)"
    )
    return score_pct


def _resident_passes(cfg, val_ds, device, members, sources, graphed=None):
    """(averaged probabilities, batch) per eval batch from the device store,
    walking blocked_eval_stream's blocks (JAX's ensemble block); on CUDA
    each batch is one replay, its outputs valid until the next."""
    store = build_store(cfg.replace(relation_type="implicit"), val_ds, device)
    tables = member_adj_tables(members, val_ds, device)

    def one_batch(R, inputs, generators):
        return averaged_probs(members, store, inputs["idx"], R, tables)

    steps = StepGraphs(one_batch, device, graphed)
    for R, blk in blocked_eval_stream(cfg, store, cfg.resolved_eval_batch())[2]:
        nreal = real_batches(blk)
        idx = to_device(blk[:nreal], device)
        for j in range(nreal):
            yield steps(R, {"idx": idx[j]})


def _host_passes(cfg, val_ds, device, members, sources, graphed=None):
    """(averaged probabilities, batch) per eval batch of one shared host
    stream; each member's edge labels packed from its table per batch. On
    CUDA each batch is one replay, its outputs valid until the next."""
    eval_batch, R = cfg.resolved_eval_batch(), cfg.resolved_num_rois()
    shared = dataclasses.replace(val_ds, relation_type="implicit")
    loader = host_loader(cfg, shared, eval_batch, False, include_adj=False)
    entry_img = val_ds.entries.image_index

    def one_batch(R, inputs, generators):
        batch = {k: v for k, v in inputs.items() if not k.startswith(LABELS)}
        labels = {k[len(LABELS):]: v for k, v in inputs.items() if k.startswith(LABELS)}
        return member_probs(members, batch, labels), batch

    steps = StepGraphs(one_batch, device, graphed)
    with contextlib.closing(prefetch_to_device(loader, device, depth=cfg.prefetch)) as batches:
        for lo, batch in zip(range(0, len(entry_img), eval_batch), batches):
            imgs = entry_img[lo : lo + eval_batch]
            inputs = dict(batch)
            for rt, src in sources.items():
                adj = np.zeros((eval_batch, R, R), np.int32)
                k = min(src.shape[1], R)
                adj[: len(imgs), :k, :k] = src[imgs, :k, :k]
                inputs[LABELS + rt] = to_device(adj, device)
            yield steps(R, inputs)
