"""Three-branch ReGAT ensemble evaluation (counterpart of
tf_vqa_regat_tpu/train/ensemble.py, its device-resident path).

Members are separate checkpoints, each trained with its own
--relation_type and otherwise the flags of this run: member `rt` is built
with `cfg.replace(relation_type=rt)` and loaded from its `.npz` or
checkpoint directory. At eval time every member runs on the same batch and
the sigmoid answer probabilities are averaged before the argmax VQA score.

The split's tables are uploaded once, at --feature_dtype, and shared; the
batches are the ones eval and predict read (train/loop.py::
eval_batch_stream), per bucket under --roi_buckets. The shared batch carries no
edge labels: each explicit member adds its own table, uploaded once and
gathered for the batch (JAX ensemble.py:238-256): a semantic member the
split's semantic labels, a spatial member the file's spatial labels where
the split has them; without them it builds its labels from the boxes in
the step, as it does in training.

CLI: --mode ensemble_eval
     --ensemble_checkpoints implicit:PATH,spatial:PATH,semantic:PATH
(any non-empty subset of branches).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_adj, gather_batch
from tf_vqa_regat_tpu_torch.data.features import VQADataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.params import load_jax_arrays
from tf_vqa_regat_tpu_torch.train.checkpoint import load_params
from tf_vqa_regat_tpu_torch.train.logging import Logger
from tf_vqa_regat_tpu_torch.train.loop import build_store, eval_batch_stream
from tf_vqa_regat_tpu_torch.train.loss import vqa_score_sum

Member = Tuple[str, ReGAT]


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


def member_adj_tables(
    members: List[Member], ds: VQADataset, device: torch.device
) -> Dict[str, torch.Tensor]:
    """Relation type -> its edge-label table on `device` [num_images, A, A]
    int8, once per type among the members: semantic members the split's
    semantic table (required), spatial members the file's spatial table
    where there is one."""
    tables = {}
    for rt, _ in members:
        src = {"semantic": ds.store.semantic_adj, "spatial": ds.store.spatial_adj}.get(rt)
        if rt == "semantic" and src is None:
            raise ValueError("a semantic member needs the split's edge-label table")
        if src is not None and rt not in tables:
            tables[rt] = torch.from_numpy(src.astype(np.int8)).to(device)
    return tables


def averaged_probs(
    members: List[Member], store: DeviceStore, idx: torch.Tensor, num_rois: int,
    tables: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(mean of the members' sigmoid answer probabilities [B, num_ans], the
    shared batch) for index vector `idx`; `tables` from member_adj_tables."""
    batch = gather_batch(store, idx, num_rois, adj=False)
    img = store.entry_img[torch.clamp(idx, min=0).long()]
    labels = {}
    probs = None
    with torch.no_grad():
        for rt, model in members:
            b = batch
            if rt in tables:
                if rt not in labels:
                    labels[rt] = gather_adj(tables[rt], img, num_rois, batch["valid"])
                b = dict(batch, adj_label=labels[rt])
            p = torch.sigmoid(model(b))
            probs = p if probs is None else probs + p
    return probs / len(members), batch


def run_ensemble_eval(
    cfg: Config, val_ds: VQADataset, device: torch.device, logger: Logger
) -> float:
    """The ensemble's VQA score (%) over the split, in entry order."""
    members = load_members(cfg, val_ds, device, logger)
    store = build_store(cfg.replace(relation_type="implicit"), val_ds, device)
    tables = member_adj_tables(members, val_ds, device)
    score = torch.zeros((), device=device)
    n = torch.zeros((), device=device)
    start = time.time()
    for R, idx in eval_batch_stream(cfg, store, cfg.resolved_eval_batch()):
        probs, batch = averaged_probs(members, store, torch.from_numpy(idx).to(device), R,
                                      tables)
        score += vqa_score_sum(probs, batch["target"], batch["valid"])
        n += batch["valid"].to(torch.float32).sum()
    score_pct = 100.0 * float(score) / max(float(n), 1.0)
    logger.write(
        f"[ensemble] members={[rt for rt, _ in members]} data=device "
        f"score={score_pct:.4f} ({time.time()-start:.1f}s)"
    )
    return score_pct
