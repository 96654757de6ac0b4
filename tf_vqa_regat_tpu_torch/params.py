"""Parameters carried across between the JAX package and the port.

The flat form is a dict keyed by JAX pytree path — dict keys and list
indices joined by '/', e.g. ``v_relation/gatt/neighbor/0/pair_pos_fc/layers/0/v``
— with numpy arrays in the JAX layouts. The port's modules carry the same
names, so a state-dict key is the path with '/' written as '.'. The port's
checkpoint is ``np.savez`` of the flat dict, which needs no JAX to read
(an orbax checkpoint does; its converter is in ROADMAP Queue A).

The full training state (train/checkpoint.py) is the same flat dict plus the
Adamax state of train/optim.py under ``opt/mu/<path>``, ``opt/nu/<path>``
and ``opt/count``. A JAX train state ``{"params", "opt_state", "step"}``,
taken to numpy, maps to that form through `train_state_arrays`; a
params-only file is the form without the ``opt/`` keys.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

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


OPT_PREFIX = "opt/"


def state_tensors(model: nn.Module, opt: Optional[Any] = None) -> Dict[str, torch.Tensor]:
    """The flat full state of `model` and its `Adamax` (params only when
    `opt` is None): the live tensors, keyed by pytree path; `opt/count` is
    a 0-d int64 CPU tensor."""
    flat = {k.replace(".", "/"): v.detach() for k, v in model.state_dict().items()}
    if opt is not None:
        st = opt.state_dict()
        for m in ("mu", "nu"):
            flat.update({f"{OPT_PREFIX}{m}/{n.replace('.', '/')}": t for n, t in st[m].items()})
        flat[OPT_PREFIX + "count"] = torch.tensor(st["count"], dtype=torch.int64)
    return flat


def split_state(
    flat: Mapping[str, np.ndarray]
) -> Tuple[Dict[str, np.ndarray], Optional[Dict[str, np.ndarray]]]:
    """(params, the `opt/` entries with the prefix cut, or None when the
    file holds params only)."""
    params = {k: v for k, v in flat.items() if not k.startswith(OPT_PREFIX)}
    opt = {k[len(OPT_PREFIX):]: v for k, v in flat.items() if k.startswith(OPT_PREFIX)}
    return params, (opt or None)


def load_state_arrays(model: nn.Module, opt: Any, flat: Mapping[str, np.ndarray]) -> None:
    """Load a flat full state into `model` and its `Adamax`; raises when a
    key is missing or unexpected, a shape or dtype differs, or the state
    holds no optimizer."""
    params, opt_flat = split_state(flat)
    if opt_flat is None:
        raise ValueError("the state holds parameters only, no optimizer state")
    load_jax_arrays(model, params)
    moments = {}
    for m in ("mu", "nu"):
        pre = m + "/"
        moments[m] = {
            k[len(pre):].replace("/", "."): torch.from_numpy(np.array(v))
            for k, v in opt_flat.items() if k.startswith(pre)
        }
    unknown = sorted(k for k in opt_flat if k != "count" and not k.startswith(("mu/", "nu/")))
    if "count" not in opt_flat or unknown:
        raise ValueError(f"optimizer state: count missing or unexpected keys {unknown}")
    opt.load_state_dict({**moments, "count": int(opt_flat["count"])})


def _adamax_state(node: Any) -> Any:
    """The optax Adamax state (the node with `mu` and `nu`) inside an
    opt_state of nested tuples."""
    if hasattr(node, "mu") and hasattr(node, "nu"):
        return node
    children = node.values() if isinstance(node, Mapping) else (
        node if isinstance(node, (list, tuple)) else ()
    )
    for child in children:
        found = _adamax_state(child)
        if found is not None:
            return found
    return None


def train_state_arrays(state: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX train state {"params", "opt_state", "step"} with numpy leaves
    -> the port's flat full state: Adamax `mu` and `nu` by pytree path,
    `count` from the JAX step."""
    adam = _adamax_state(state["opt_state"])
    if adam is None:
        raise ValueError("the JAX opt_state holds no Adamax state (mu, nu)")
    flat = flatten_tree(state["params"])
    for m in ("mu", "nu"):
        flat.update({f"{OPT_PREFIX}{m}/{k}": v for k, v in flatten_tree(getattr(adam, m)).items()})
    flat[OPT_PREFIX + "count"] = np.asarray(int(state["step"]), np.int64)
    return flat

