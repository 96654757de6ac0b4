"""Loss and VQA score (counterpart of tf_vqa_regat_tpu/train/loss.py), on the
batch's device.

Elementwise sigmoid BCE against the soft targets, summed over answers and
averaged over the valid examples; `valid` masks the padded slots of a
statically sized last batch.
"""

from __future__ import annotations

import torch


def bce_with_logits_sum(
    logits: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Sum over answers, mean over valid examples. [b, A], [b, A], [b] -> [].
    The gradient is sigmoid(x) - target everywhere, at a logit of exactly 0
    too (the TF reference's `sigmoid_cross_entropy_with_logits` gradient):
    `maximum` splits the tie in half and |x| has gradient 0 there. JAX's
    formula gives -target at 0 (its |x| takes gradient 1), `clamp` gave
    1 - target: a jump at 0 turns a logit rounded to exactly 0 by another
    order of sums into a gradient that differs by half an example's
    weight (README, known deviations)."""
    per_elem = (
        torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
    per_example = per_elem.sum(dim=-1)
    n_valid = torch.clamp(valid.to(torch.float32).sum(), min=1.0)
    return torch.where(valid, per_example, torch.zeros_like(per_example)).sum() / n_valid


def vqa_score_sum(
    logits: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Sum over valid examples of the soft target at the argmax answer."""
    hit = torch.gather(targets, 1, logits.argmax(dim=-1)[:, None])[:, 0]
    return torch.where(valid, hit, torch.zeros_like(hit)).sum()
