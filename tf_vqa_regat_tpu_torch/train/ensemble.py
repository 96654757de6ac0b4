"""Three-branch ReGAT ensemble evaluation (counterpart of
tf_vqa_regat_tpu/train/ensemble.py: its device-resident, sharded and host
paths).

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

Over the sharded store (`--data_mode sharded`, or `auto` at dp > 1 when
only a shard fits; JAX `_member_sharded_arrays`, ensemble.py:187-216) the
members share one sharded base store without edge labels, and each
member's labels are partitioned with the base store's image assignment
(`ShardedDeviceStore.sharded_adj_table`); each data group scores its
segment of every global batch, and the score and count are summed over the
data group. Under a process group every member is built for the rank's
place on the mesh (its part of each split leaf at tp > 1), and the members
run eagerly at tp > 1 (train/step.py::eager_reason), and over the sharded
store under --ref_compat_q_att, whose batch-axis softmax then gathers the
data groups' segments into the global batch.

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
from tf_vqa_regat_tpu_torch.data.features import VQADataset
from tf_vqa_regat_tpu_torch.data.loader import prefetch_to_device
from tf_vqa_regat_tpu_torch.data.sharded_store import sharded_layout
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_adj, gather_batch
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.parallel import distributed
from tf_vqa_regat_tpu_torch.parallel.mesh import Mesh, batch_slice, make_mesh
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
from tf_vqa_regat_tpu_torch.train.step import (
    eager_line,
    gathers_rows,
    real_batches,
    resolve_graphed,
)

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
    cfg: Config, ds: VQADataset, device: torch.device, logger: Logger,
    mesh: Optional[Mesh] = None,
) -> List[Member]:
    """Each member of --ensemble_checkpoints, built under this run's flags
    with its relation type for this rank's place on `mesh`, loaded and in
    eval mode on `device`. Raises, naming the member, when its parameters
    do not fit those flags."""
    members = []
    tp = None if mesh is None else mesh.tensor_parallel()
    for rt, path in parse_members(cfg.ensemble_checkpoints):
        model = ReGAT(cfg.replace(relation_type=rt), ds.ntoken, ds.v_dim, ds.num_ans, tp=tp)
        arrays = load_params(path)  # an Orbax directory raises, naming the converter
        try:
            load_jax_arrays(model, arrays)
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
    mesh = make_mesh(cfg.dp_size, cfg.tp_size)
    members = load_members(cfg, val_ds, device, logger, mesh)
    # the members' edge-label tables sit on the card beside the store in
    # device mode, so the budget counts them (int8, one byte each); a
    # shard's tables pad to the largest shard's image count (JAX
    # ensemble.py:300-330)
    sources = member_adj_sources(members, val_ds)
    extra = sum(int(src.size) for src in sources.values())
    if sources and mesh.dp > 1:
        local_imgs = sharded_layout(val_ds, mesh.dp)[3]
        extra_sharded = sum(local_imgs * src.shape[1] * src.shape[2]
                            for src in sources.values())
    else:
        extra_sharded = 0
    mode = resolve_data_mode(cfg, val_ds, None, False, extra, dp=mesh.dp,
                             extra_sharded=extra_sharded)
    check_roi_buckets_mode(cfg, mode)
    logger.write(data_mode_line(cfg, mode, val_ds, None, False, extra, dp=mesh.dp))
    if mode == "sharded" and cfg.ref_compat_q_att:
        # each data group holds its segment of the global batch: the
        # batch-axis softmax spans the segments (models/language.py)
        for _, model in members:
            model.q_att.data = mesh.data_axis()
    gather = any(gathers_rows(model) for _, model in members)
    line = eager_line(mesh, gather)
    if line:
        logger.write(line)
    passes = {"device": _resident_passes, "sharded": _sharded_passes}.get(mode, _host_passes)
    score = torch.zeros((), device=device)
    n = torch.zeros((), device=device)
    start = time.time()
    for probs, batch in passes(cfg, val_ds, device, members, sources,
                               resolve_graphed(mesh, graphed, gather), mesh):
        score += vqa_score_sum(probs, batch["target"], batch["valid"])
        n += batch["valid"].to(torch.float32).sum()
    if mode == "sharded":  # each data group scored its own segments
        sums = torch.stack([score, n])
        distributed.all_reduce_([sums], group=mesh.data_group())
        score, n = sums[0], sums[1]
    score_pct = 100.0 * float(score) / max(float(n), 1.0)
    logger.write(
        f"[ensemble] members={[rt for rt, _ in members]} data={mode} "
        f"score={score_pct:.4f} ({time.time()-start:.1f}s)"
    )
    return score_pct


def _resident_passes(cfg, val_ds, device, members, sources, graphed=None, mesh=None):
    """(averaged probabilities, batch) per eval batch from the device store,
    walking blocked_eval_stream's blocks (JAX's ensemble block); on CUDA
    each batch is one replay, its outputs valid until the next. Every rank
    scores every batch."""
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


def _sharded_passes(cfg, val_ds, device, members, sources, graphed=None, mesh=None):
    """(averaged probabilities, batch) of this data group's segment of
    every global eval batch, from the sharded base store and the members'
    labels partitioned alike, with the batch's entry indices (-1 on padded
    rows) under "entry"; on CUDA each batch is one replay, its outputs
    valid until the next."""
    mesh = mesh if mesh is not None else Mesh(dp=1)
    store = build_store(cfg.replace(relation_type="implicit"), val_ds, device,
                        mode="sharded", mesh=mesh)
    tables = {rt: store.sharded_adj_table(src) for rt, src in sources.items()}

    def one_batch(R, inputs, generators):
        return averaged_probs(members, store, inputs["idx"], R, tables)

    steps = StepGraphs(one_batch, device, graphed)
    eval_batch = cfg.resolved_eval_batch(mesh.dp)
    for R, blk in blocked_eval_stream(cfg, store, eval_batch)[2]:
        nreal = real_batches(blk)
        entries = batch_slice(store.to_global(blk), mesh.data, mesh.dp)
        idx = to_device(batch_slice(blk, mesh.data, mesh.dp)[:nreal], device)
        for j in range(nreal):
            probs, batch = steps(R, {"idx": idx[j]})
            yield probs, dict(batch, entry=entries[j])


def _host_passes(cfg, val_ds, device, members, sources, graphed=None, mesh=None):
    """(averaged probabilities, batch) per eval batch of one shared host
    stream; each member's edge labels packed from its table per batch. On
    CUDA each batch is one replay, its outputs valid until the next. Every
    rank scores every batch."""
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
