"""Optimizer: per-tensor clipping, Adamax and the reference LR table
(counterpart of tf_vqa_regat_tpu/train/optim.py and its optax chain
clip_per_tensor -> adamax(schedule) -> freeze).

What the chain does, and this class does in the same order:
  - clip each gradient tensor to L2 norm `grad_clip`: g * min(1, c / max(|g|, 1e-12))
    (per tensor, not the global norm);
  - Adamax, b1 0.9, b2 0.999, eps 1e-8: mu = b1 mu + (1 - b1) g,
    nu = max(b2 nu, |g| + eps), update = -lr * mu / (1 - b1^t) / nu, with
    the learning rate read at the step count BEFORE the increment;
  - freeze: the update of a frozen leaf is zeroed AFTER Adamax, so its
    moments still advance while the leaf stays put.
The state lives in lists of tensors and every update is a `torch._foreach_*`
call over all of them. `state_dict` and `load_state_dict` carry it by
parameter name: `mu`, `nu` and the step `count`, the Adamax state of the
optax chain (train/checkpoint.py saves it beside the parameters).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Sequence

import torch
from torch import nn

WARMUP_FACTORS = (1.0, 1.0, 1.2, 1.3, 1.4)
DECAY_START_EPOCH = 5  # hardcoded range(5, epochs, step) in reference train.py:61


def make_lr_schedule(
    base_lr: float, steps_per_epoch: int, lr_decay_rate: float, lr_decay_step: int
) -> Callable[[int], float]:
    """Step -> learning rate: epochs 0-4 warm up by WARMUP_FACTORS, then the
    rate is multiplied by `lr_decay_rate` at epochs 5, 5 + step, 5 + 2 step..."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        if epoch < len(WARMUP_FACTORS):
            return base_lr * WARMUP_FACTORS[epoch]
        n_decays = (epoch - DECAY_START_EPOCH) // lr_decay_step + 1
        return base_lr * WARMUP_FACTORS[-1] * lr_decay_rate**n_decays

    return schedule


class Adamax:
    """The clip -> Adamax -> freeze chain over `model`'s parameters.
    `trainable` maps each parameter name to whether it takes updates
    (models.regat.trainable_mask). `count` is the number of steps taken."""

    def __init__(
        self,
        model: nn.Module,
        trainable: Mapping[str, bool],
        schedule: Callable[[int], float],
        grad_clip: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ):
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.trainable = [trainable[n] for n in self.names]
        self.schedule, self.grad_clip = schedule, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Apply one update from `grads`, one per parameter, in order."""
        scale = torch._foreach_norm(grads)
        torch._foreach_clamp_min_(scale, 1e-12)
        torch._foreach_reciprocal_(scale)
        torch._foreach_mul_(scale, self.grad_clip)
        torch._foreach_clamp_max_(scale, 1.0)
        g = torch._foreach_mul(grads, scale)

        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
        torch._foreach_abs_(g)
        torch._foreach_add_(g, self.eps)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_maximum_(self.nu, g)

        lr = self.schedule(self.count)
        self.count += 1
        live = [i for i, t in enumerate(self.trainable) if t]
        upd = torch._foreach_div([self.mu[i] for i in live], [self.nu[i] for i in live])
        torch._foreach_mul_(upd, -lr / (1.0 - self.b1**self.count))
        torch._foreach_add_([self.params[i] for i in live], upd)

    def state_dict(self) -> Dict[str, Any]:
        """{"mu": {name: tensor}, "nu": {name: tensor}, "count": int}: the
        live tensors, not copies."""
        return {
            "mu": dict(zip(self.names, self.mu)),
            "nu": dict(zip(self.names, self.nu)),
            "count": self.count,
        }

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copy `state` (as `state_dict` gives it, tensors on any device)
        into the moments; raises on a missing, unexpected or misshapen leaf."""
        for key, own in (("mu", self.mu), ("nu", self.nu)):
            given = state[key]
            missing = sorted(set(self.names) - set(given))
            unexpected = sorted(set(given) - set(self.names))
            if missing or unexpected:
                raise ValueError(
                    f"Adamax {key} keys differ from the model's: missing {missing}, "
                    f"unexpected {unexpected}"
                )
            for name, t in zip(self.names, own):
                v = torch.as_tensor(given[name])
                if v.shape != t.shape or v.dtype != t.dtype:
                    raise ValueError(
                        f"Adamax {key} {name}: checkpoint has {v.dtype}{tuple(v.shape)}, "
                        f"model {t.dtype}{tuple(t.shape)}"
                    )
        for key, own in (("mu", self.mu), ("nu", self.nu)):
            for name, t in zip(self.names, own):
                t.copy_(torch.as_tensor(state[key][name]))
        self.count = int(state["count"])
