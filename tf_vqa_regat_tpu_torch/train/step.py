"""Train and eval steps (counterpart of tf_vqa_regat_tpu/train/step.py
`_train_core` and `_eval_core`): loss, gradients and the Adamax update for
one batch, or the eval metrics of one batch. The metrics stay on the device
as 0-d tensors: {"loss", "score", "n"}.

A train step's dropout masks come from a generator on the batch's device
seeded from (seed + 1, step), as the JAX step folds the step into
PRNGKey(seed + 1), so they depend only on the seed and the step; a
captured step (train/graphs.py) is handed its generators, re-seeded so
before each replay.

Gradient accumulation (`grad_accum` k > 1, JAX `_accum_grads`): the batch
splits into k strided microbatches, microbatch a holding rows a, a+k,
a+2k, ... (so a padded final batch spreads its invalid rows as JAX's
does). Each runs forward and backward on its own, with its own generator
(seed + 1, step, a); the gradient of its loss sum (the valid-count mean
times its valid count) adds into f32 buffers and its activations are freed
before the next. The sum over the batch's valid count, max 1, takes one
clip and one Adamax update. The metrics are the loss sum over that count,
the score sum and the count.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.nn import step_generator, step_seed
from tf_vqa_regat_tpu_torch.train.graphs import StepGraphs, to_device
from tf_vqa_regat_tpu_torch.train.loss import bce_with_logits_sum, vqa_score_sum
from tf_vqa_regat_tpu_torch.train.optim import Adamax

Batch = Dict[str, torch.Tensor]


def _metrics(logits: torch.Tensor, loss: torch.Tensor, batch: Batch) -> Dict[str, torch.Tensor]:
    return {
        "loss": loss.detach(),
        "score": vqa_score_sum(logits.detach(), batch["target"], batch["valid"]),
        "n": batch["valid"].to(torch.float32).sum(),
    }


def train_forward(
    model: ReGAT, batch: Batch, step: int, seed: int, microbatch: int = 0,
    generator=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, logits) of the train forward pass of step `step` (of its
    microbatch `microbatch` under gradient accumulation), its dropout masks
    drawn from `generator`, by default step_generator(seed + 1, step,
    device, microbatch)."""
    model.train()
    if generator is None:
        generator = step_generator(seed + 1, step, batch["features"].device, microbatch)
    logits = model(batch, generator)
    return bce_with_logits_sum(logits, batch["target"], batch["valid"]), logits


def microbatch(batch: Batch, a: int, k: int) -> Batch:
    """Rows a, a+k, a+2k, ... of every tensor of the batch (JAX's strided
    split: [B] reshaped to [B/k, k], the k axis in front)."""
    return {key: v[a::k].contiguous() for key, v in batch.items()}


def train_step(
    model: ReGAT, opt: Adamax, batch: Batch, step: int, seed: int, grad_accum: int = 1,
    generators=None,
) -> Dict[str, torch.Tensor]:
    """One optimizer step on `batch` -> its metrics. The dropout masks come
    from `generators`, one per microbatch, seeded by the caller (a captured
    step keeps its generators), or by default from train_forward's."""
    gens = generators or [None] * grad_accum
    if grad_accum == 1:
        loss, logits = train_forward(model, batch, step, seed, 0, gens[0])
        grads = torch.autograd.grad(loss, opt.params)
        opt.step(grads)
        return _metrics(logits, loss, batch)
    grads, loss_sum, score, n_sum = None, 0.0, 0.0, 0.0
    for a in range(grad_accum):
        mb = microbatch(batch, a, grad_accum)
        loss, logits = train_forward(model, mb, step, seed, a, gens[a])
        m = _metrics(logits, loss, mb)
        g = torch.autograd.grad(loss * m["n"], opt.params)
        del loss, logits  # this microbatch's activations go before the next
        if grads is None:
            grads = list(g)
        else:
            torch._foreach_add_(grads, g)
        loss_sum = loss_sum + m["loss"] * m["n"]
        score = score + m["score"]
        n_sum = n_sum + m["n"]
    n = torch.clamp(n_sum, min=1.0)
    torch._foreach_div_(grads, n)
    opt.step(grads)
    return {"loss": loss_sum / n, "score": score, "n": n_sum}


def add_step(block: Dict[str, torch.Tensor], m: Dict[str, torch.Tensor]) -> None:
    """Fold one step's metrics into a block's sums, in place, as JAX's
    scanned blocks fold them: loss_sum += loss * n, score, n, and `loss`
    the last step's loss that had examples (JAX train/step.py:269-276)."""
    block["loss_sum"] += m["loss"] * m["n"]
    block["score"] += m["score"]
    block["n"] += m["n"]
    block["loss"] = torch.where(m["n"] > 0, m["loss"], block["loss"])


def block_zeros(device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), device=device) for k in ("loss", "loss_sum", "score", "n")}


@torch.no_grad()
def eval_step(model: ReGAT, batch: Batch) -> Dict[str, torch.Tensor]:
    model.eval()
    logits = model(batch)
    return _metrics(logits, bce_with_logits_sum(logits, batch["target"], batch["valid"]), batch)


def real_batches(blk: np.ndarray) -> int:
    """The real batches of an index block [K, B]: its leading rows with an
    entry, the rest being the tail's all -1 padding (JAX runs a batch when
    any(idx >= 0))."""
    return int((blk >= 0).any(axis=1).sum())


class TrainSteps:
    """The train steps of one model and optimizer, through train/graphs.py:
    on CUDA one graph per (R, grad_accum, compute dtype) whose replay
    gathers the batch from `store` by a static index vector (the device
    path) or reads a static copy of a host batch (`store` None), runs the
    step and updates the parameters. Each step's generators are re-seeded
    from (seed + 1, count, microbatch), as step_generator seeds them."""

    def __init__(self, model: ReGAT, opt: Adamax, cfg: Config, device: torch.device,
                 store: Optional[DeviceStore] = None, graphed: Optional[bool] = None,
                 pool: Any = None):
        self.opt, self.store = opt, store
        self.seed, self.k, self.dtype = cfg.seed, cfg.grad_accum, cfg.compute_dtype
        self.device = torch.device(device)
        seed, k = self.seed, self.k

        def step(key, inputs, generators) -> Dict[str, torch.Tensor]:
            batch = inputs if store is None else gather_batch(store, inputs["idx"], key[0])
            return train_step(model, opt, batch, opt.count, seed, k, generators)

        self.graphs = StepGraphs(step, self.device, graphed, generators=k,
                                 keep=opt.snapshot, pool=pool)

    def step(self, R: int, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step at roi count R -> its metrics (a graph's
        outputs: consume them before the next step)."""
        count = self.opt.count
        seeds = [step_seed(self.seed + 1, count, a) for a in range(self.k)]
        m = self.graphs((R, self.k, self.dtype), inputs, seeds)
        self.opt.count = count + 1
        return m

    def block(self, R: int, blk: np.ndarray, nreal: int) -> Dict[str, torch.Tensor]:
        """The first `nreal` batches of the index block `blk` [K, B], one
        step each, with one copy of the block to the card -> the block's
        metrics (add_step): JAX's scanned block, whose padded steps leave
        the state as it is."""
        idx = to_device(blk[:nreal], self.device)
        acc = block_zeros(self.device)
        for j in range(nreal):
            add_step(acc, self.step(R, {"idx": idx[j]}))
        return acc

    def batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One step on a batch of the host path -> a block of one."""
        acc = block_zeros(self.device)
        add_step(acc, self.step(batch["features"].shape[1], batch))
        return acc


class EvalSteps:
    """The eval steps of one model, through train/graphs.py: one graph per
    R, fed an index vector into `store` or a host batch."""

    def __init__(self, model: ReGAT, device: torch.device, store: Optional[DeviceStore] = None,
                 graphed: Optional[bool] = None, pool: Any = None):
        self.device = torch.device(device)

        def step(R, inputs, generators) -> Dict[str, torch.Tensor]:
            batch = inputs if store is None else gather_batch(store, inputs["idx"], R)
            return eval_step(model, batch)

        self.graphs = StepGraphs(step, self.device, graphed, pool=pool)

    def block(self, R: int, blk: np.ndarray) -> Dict[str, torch.Tensor]:
        """The metrics of the index block `blk` [K, B] as JAX's eval block
        gives them: score and n summed, loss the valid-weighted mean; a
        block of one is the step's own metrics. Padded batches do not run:
        they add nothing."""
        nreal = real_batches(blk)
        idx = to_device(blk[:nreal], self.device)
        if blk.shape[0] == 1:
            return self.graphs(R, {"idx": idx[0]})
        acc = block_zeros(self.device)
        for j in range(nreal):
            add_step(acc, self.graphs(R, {"idx": idx[j]}))
        return {"loss": acc["loss_sum"] / torch.clamp(acc["n"], min=1.0),
                "score": acc["score"], "n": acc["n"]}

    def batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return self.graphs(batch["features"].shape[1], batch)
