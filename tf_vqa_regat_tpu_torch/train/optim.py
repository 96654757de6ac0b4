"""Optimizer: per-tensor clipping, Adamax and the reference LR table
(counterpart of tf_vqa_regat_tpu/train/optim.py and its optax chain
clip_per_tensor -> adamax(schedule) -> freeze).

What the chain does, and this class does in the same order:
  - clip each gradient tensor to L2 norm `grad_clip`: g * min(1, c / max(|g|, 1e-12))
    (per tensor, not the global norm);
  - Adamax, b1 0.9, b2 0.999, eps 1e-8: mu = b1 mu + (1 - b1) g,
    nu = max(b2 nu, |g| + eps), update = -lr * mu / (1 - b1^t) / nu, with
    the learning rate read at the step count BEFORE the increment; both the
    rate and 1 - b1^t are computed on the device from the count there;
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


class LRSchedule:
    """Step -> learning rate: epochs 0-4 warm up by WARMUP_FACTORS, then the
    rate is multiplied by `lr_decay_rate` at epochs 5, 5 + step, 5 + 2 step...
    Called with an int it gives the rate on the host (the log lines); `at`
    gives it on the device from a 0-d step tensor, in JAX's f32 formula
    (optim.py::make_lr_schedule), so a captured optimizer step reads the
    step count at each replay."""

    def __init__(self, base_lr: float, steps_per_epoch: int, lr_decay_rate: float,
                 lr_decay_step: int):
        self.base_lr, self.steps_per_epoch = base_lr, steps_per_epoch
        self.lr_decay_rate, self.lr_decay_step = lr_decay_rate, lr_decay_step

    def __call__(self, step: int) -> float:
        epoch = step // self.steps_per_epoch
        if epoch < len(WARMUP_FACTORS):
            return self.base_lr * WARMUP_FACTORS[epoch]
        n_decays = (epoch - DECAY_START_EPOCH) // self.lr_decay_step + 1
        return self.base_lr * WARMUP_FACTORS[-1] * self.lr_decay_rate**n_decays

    def at(self, step: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
        """The f32 rate at the 0-d int64 `step`; `factors` is WARMUP_FACTORS
        as an f32 tensor on the step's device (a table made once, since a
        capture may not copy from the host)."""
        epoch = torch.div(step, self.steps_per_epoch, rounding_mode="floor")
        # index_select: indexing with a 0-d tensor would read it on the host
        warm = self.base_lr * factors.index_select(
            0, torch.clamp(epoch, max=len(WARMUP_FACTORS) - 1).view(1)).view(())
        n_decays = torch.clamp(
            torch.div(epoch - DECAY_START_EPOCH, self.lr_decay_step, rounding_mode="floor") + 1,
            min=0)
        decayed = self.base_lr * WARMUP_FACTORS[-1] * torch.pow(
            self.lr_decay_rate, n_decays.to(torch.float32))
        return torch.where(epoch < len(WARMUP_FACTORS), warm, decayed)


def make_lr_schedule(
    base_lr: float, steps_per_epoch: int, lr_decay_rate: float, lr_decay_step: int
) -> LRSchedule:
    return LRSchedule(base_lr, steps_per_epoch, lr_decay_rate, lr_decay_step)


class Adamax:
    """The clip -> Adamax -> freeze chain over `model`'s parameters.
    `trainable` maps each parameter name to whether it takes updates
    (models.regat.trainable_mask). The step count lives twice: `count_t`, a
    0-d int64 tensor on the parameters' device that the update reads (the
    learning rate, the bias correction) and advances, so that a step
    captured in a CUDA graph reads it anew at each replay; and `count`, its
    mirror on the host (the dropout seeds, the checkpoints), which `step`
    advances and a graph's caller advances per replay."""

    def __init__(
        self,
        model: nn.Module,
        trainable: Mapping[str, bool],
        schedule: LRSchedule,
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
        device = self.params[0].device
        self.count = 0
        self.count_t = torch.zeros((), dtype=torch.int64, device=device)
        self._factors = torch.tensor(WARMUP_FACTORS, dtype=torch.float32, device=device)

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

        # the rate at the count before the increment, the bias correction
        # 1 - b1^t after it (optax's count_inc), both f32 on the device
        lr = self.schedule.at(self.count_t, self._factors)
        self.count_t += 1
        self.count += 1
        step_size = -lr / (1.0 - torch.pow(self.b1, self.count_t.to(torch.float32)))
        live = [i for i, t in enumerate(self.trainable) if t]
        upd = torch._foreach_div([self.mu[i] for i in live], [self.nu[i] for i in live])
        torch._foreach_mul_(upd, step_size)
        torch._foreach_add_([self.params[i] for i in live], upd)

    @torch.no_grad()
    def snapshot(self) -> Callable[[], None]:
        """Copy the parameters, the moments and both counts; the returned
        function writes them back in place (the tensors keep their
        addresses, which a captured step reads and writes)."""
        live = [*self.params, *self.mu, *self.nu, self.count_t]
        saved = [t.detach().clone() for t in live]
        count = self.count

        def restore() -> None:
            with torch.no_grad():
                for t, v in zip(live, saved):
                    t.copy_(v)
            self.count = count

        return restore

    def state_dict(self) -> Dict[str, Any]:
        """{"mu": {name: tensor}, "nu": {name: tensor}, "count": int}: the
        live tensors, not copies; the count from the host's mirror."""
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
        self.count_t.fill_(self.count)
