"""Train and eval steps (counterpart of tf_vqa_regat_tpu/train/step.py
`_train_core` and `_eval_core`): loss, gradients and the Adamax update for
one batch, or the eval metrics of one batch. The metrics stay on the device
as 0-d tensors: {"loss", "score", "n"}.

A train step's dropout masks come from a generator on the batch's device
seeded from (seed + 1, step), as the JAX step folds the step into
PRNGKey(seed + 1), so they depend only on the seed and the step.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.nn import step_generator
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
    model: ReGAT, batch: Batch, step: int, seed: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, logits) of the train forward pass of step `step`."""
    model.train()
    generator = step_generator(seed + 1, step, batch["features"].device)
    logits = model(batch, generator)
    return bce_with_logits_sum(logits, batch["target"], batch["valid"]), logits


def train_step(
    model: ReGAT, opt: Adamax, batch: Batch, step: int, seed: int
) -> Dict[str, torch.Tensor]:
    loss, logits = train_forward(model, batch, step, seed)
    grads = torch.autograd.grad(loss, opt.params)
    opt.step(grads)
    return _metrics(logits, loss, batch)


@torch.no_grad()
def eval_step(model: ReGAT, batch: Batch) -> Dict[str, torch.Tensor]:
    model.eval()
    logits = model(batch)
    return _metrics(logits, bce_with_logits_sum(logits, batch["target"], batch["valid"]), batch)
