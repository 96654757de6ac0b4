"""Train and eval steps (counterpart of tf_vqa_regat_tpu/train/step.py
`_train_core` and `_eval_core`): loss, gradients and the Adamax update for
one batch, or the eval metrics of one batch. The metrics stay on the device
as 0-d tensors: {"loss", "score", "n"}.

A train step's dropout masks come from a generator on the batch's device
seeded from (seed + 1, step), as the JAX step folds the step into
PRNGKey(seed + 1), so they depend only on the seed and the step.

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
    model: ReGAT, batch: Batch, step: int, seed: int, microbatch: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, logits) of the train forward pass of step `step` (of its
    microbatch `microbatch` under gradient accumulation)."""
    model.train()
    generator = step_generator(seed + 1, step, batch["features"].device, microbatch)
    logits = model(batch, generator)
    return bce_with_logits_sum(logits, batch["target"], batch["valid"]), logits


def microbatch(batch: Batch, a: int, k: int) -> Batch:
    """Rows a, a+k, a+2k, ... of every tensor of the batch (JAX's strided
    split: [B] reshaped to [B/k, k], the k axis in front)."""
    return {key: v[a::k].contiguous() for key, v in batch.items()}


def train_step(
    model: ReGAT, opt: Adamax, batch: Batch, step: int, seed: int, grad_accum: int = 1
) -> Dict[str, torch.Tensor]:
    if grad_accum == 1:
        loss, logits = train_forward(model, batch, step, seed)
        grads = torch.autograd.grad(loss, opt.params)
        opt.step(grads)
        return _metrics(logits, loss, batch)
    grads, loss_sum, score, n_sum = None, 0.0, 0.0, 0.0
    for a in range(grad_accum):
        mb = microbatch(batch, a, grad_accum)
        loss, logits = train_forward(model, mb, step, seed, a)
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


@torch.no_grad()
def eval_step(model: ReGAT, batch: Batch) -> Dict[str, torch.Tensor]:
    model.eval()
    logits = model(batch)
    return _metrics(logits, bce_with_logits_sum(logits, batch["target"], batch["valid"]), batch)
