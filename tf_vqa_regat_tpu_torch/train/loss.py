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
    """Sum over answers, mean over valid examples. [b, A], [b, A], [b] -> []."""
    per_elem = (
        torch.clamp(logits, min=0.0) - logits * targets
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
