"""Parameters carried across between the JAX package and the port.

The flat form is a dict keyed by JAX pytree path — dict keys and list
indices joined by '/', e.g. ``v_relation/gatt/neighbor/0/pair_pos_fc/layers/0/v``
— with numpy arrays in the JAX layouts. The port's modules carry the same
names, so a state-dict key is the path with '/' written as '.'. The port's
checkpoint is ``np.savez`` of the flat dict, which needs no JAX to read
(an orbax checkpoint does; reading one is in ROADMAP Queue A, persistence and
the other modes).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists of arrays -> {path: np.ndarray}."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    flat: Dict[str, np.ndarray] = {}
    for key, sub in items:
        flat.update(flatten_tree(sub, f"{prefix}/{key}" if prefix else str(key)))
    return flat


def from_jax_arrays(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX arrays -> a state dict (CPU tensors, copied)."""
    return {k.replace("/", "."): torch.from_numpy(np.array(v)) for k, v in flat.items()}


def to_jax_arrays(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A state dict -> flat JAX arrays (numpy, on the host)."""
    return {
        k.replace(".", "/"): v.detach().cpu().numpy() for k, v in state_dict.items()
    }


def load_jax_arrays(model: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Load flat JAX arrays into `model`; raises on a missing or unexpected
    key, or a shape or dtype that differs."""
    state = from_jax_arrays(flat)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise ValueError(
            f"parameter keys differ from the model's: missing {missing}, "
            f"unexpected {unexpected}"
        )
    for k, v in state.items():
        if v.shape != own[k].shape or v.dtype != own[k].dtype:
            raise ValueError(
                f"{k}: checkpoint has {v.dtype}{tuple(v.shape)}, model "
                f"{own[k].dtype}{tuple(own[k].shape)}"
            )
    model.load_state_dict(state, strict=True)


def save_npz(path: str, model: nn.Module) -> None:
    np.savez(path, **to_jax_arrays(model.state_dict()))


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
