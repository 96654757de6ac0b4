"""The harness's hold on the program under test, tf_vqa_regat_tpu_torch: its
Config for a configuration file and a traffic mix, its dataset type built
from the raw inputs (regat_bench/inputs.py), its model loaded with the
run's weights, and its optimizer. Nothing here computes what the program
computes."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.dictionary import Dictionary
from tf_vqa_regat_tpu_torch.data.entries import EntryTable
from tf_vqa_regat_tpu_torch.data.features import FeatureStore, VQADataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule


def config(cfg: dict, seed: int, **settings) -> Config:
    """The program's Config: the configuration file's keys that Config has,
    the run's seed, and the mix's settings (`settings`)."""
    known = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in cfg.items() if k in known}
    kw.update(settings)
    kw["seed"] = int(seed)
    return Config(**kw)


def word(i: int) -> str:
    """The vocabulary's word i."""
    return f"w{i}"


def dictionary(ntoken: int) -> Dictionary:
    words = [word(i) for i in range(ntoken)]
    return Dictionary({w: i for i, w in enumerate(words)}, words)


def dataset(raw: Dict[str, np.ndarray], name: str, relation_type: str) -> VQADataset:
    """The raw split as the program's VQADataset (adaptive layout: flat
    [T, v] tables and per-image [start, end) rows); image i has image id i."""
    start, count = raw["img_start"], raw["img_len"]
    store = FeatureStore(True, raw["features"], raw["norm_bb"], raw["bb"],
                         pos_boxes=np.stack([start, start + count], axis=1).astype(np.int64))
    labels, scores = raw["labels"], raw["scores"]
    used = labels >= 0
    offsets = np.zeros(len(labels) + 1, np.int64)
    np.cumsum(used.sum(axis=1), out=offsets[1:])
    n = len(raw["q_tokens"])
    entries = EntryTable(
        question_ids=np.arange(n, dtype=np.int64),
        image_ids=raw["img_of"].astype(np.int64),
        image_index=raw["img_of"].astype(np.int32),
        q_tokens=raw["q_tokens"].astype(np.int32),
        label_offsets=offsets,
        labels=labels[used].astype(np.int32),
        scores=scores[used].astype(np.float32),
        has_answers=True,
    )
    num_ans = int(raw["num_ans"])
    return VQADataset(name=name, entries=entries, store=store, num_ans=num_ans,
                      label2ans=[f"ans{i}" for i in range(num_ans)],
                      dictionary=dictionary(int(raw["ntoken"])), relation_type=relation_type)


def model(pcfg: Config, ds: VQADataset, weights: Dict[str, torch.Tensor],
          device: torch.device) -> ReGAT:
    """The program's ReGAT on `device`, holding a copy of `weights`."""
    m = ReGAT(pcfg, ds.ntoken, ds.v_dim, ds.num_ans).to(device)
    m.load_state_dict(weights, strict=True)
    return m


def adamax(m: ReGAT, pcfg: Config, steps_per_epoch: int) -> Adamax:
    """The program's optimizer over `m`, as its training loop builds it."""
    return Adamax(m, trainable_mask(m, False),
                  make_lr_schedule(pcfg.base_lr, steps_per_epoch, pcfg.lr_decay_rate,
                                   pcfg.lr_decay_step), pcfg.grad_clip)


class Lines:
    """A sink for the program's log lines (its data path reports the mode
    it took), kept for the run's standard error."""

    def __init__(self):
        self.lines = []

    def write(self, msg: str) -> None:
        self.lines.append(msg)
