"""--debug_nans (counterpart of JAX's `jax_debug_nans`, set by
tf_vqa_regat_tpu/train/loop.py:228-229, which raises FloatingPointError at
the first operation that produces a NaN).

`watching(model, enabled)` scopes a training run: a forward hook on every
module of the model raises FloatingPointError naming the first module
whose output holds a non-finite value; the graph-attention layer checks
the output of its fused attention Function, B1 (`ImplicitAttention`) or
B2 (`GraphAttention`), by name (`check_output`); and the backward runs
under autograd's anomaly mode, whose RuntimeError for a Function that
returned NaN is raised again as FloatingPointError. Per-op checks cannot
live inside a CUDA graph replay, so under the flag the train steps and
the in-training eval passes run eagerly (train/step.py::eager_reason).
With the flag off nothing is installed.
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Iterator

import torch
from torch import nn

# set while a run is watched; read by check_output
_WATCHING = [False]

_ANOMALY = re.compile(r"Function '(\w+)' returned nan values")


def _tensors(out: Any) -> Iterator[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _tensors(x)
    elif isinstance(out, dict):
        for x in out.values():
            yield from _tensors(x)


def _finite(t: torch.Tensor) -> bool:
    return not t.is_floating_point() or bool(torch.isfinite(t).all())


def check_output(name: str, out: torch.Tensor) -> None:
    """Raise FloatingPointError when a watched run's `out` of the Function
    `name` holds a non-finite value (a no-op outside `watching`)."""
    if _WATCHING[0] and not _finite(out):
        raise FloatingPointError(
            f"--debug_nans: the output of the Function {name} holds a non-finite value")


def _hook(name: str):
    def hook(module: nn.Module, inputs: Any, output: Any) -> None:
        if not all(_finite(t) for t in _tensors(output)):
            raise FloatingPointError(
                f"--debug_nans: the output of module {name or '(the model)'} "
                f"({type(module).__name__}) holds a non-finite value")
    return hook


@contextlib.contextmanager
def watching(model: nn.Module, enabled: bool) -> Iterator[None]:
    """The checks of the module docstring over the block, when `enabled`."""
    if not enabled:
        yield
        return
    handles = [m.register_forward_hook(_hook(n)) for n, m in model.named_modules()]
    _WATCHING[0] = True
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    except RuntimeError as e:
        found = _ANOMALY.search(str(e))
        if found is None:
            raise
        raise FloatingPointError(
            f"--debug_nans: the backward of {found.group(1)} returned a NaN ({e})") from e
    finally:
        _WATCHING[0] = False
        for h in handles:
            h.remove()
