#!/usr/bin/env python3
"""Convert the JAX package's Orbax checkpoints to the PyTorch port's files.

    python tools/orbax_to_npz.py SRC OUT

Runs where JAX and Orbax are installed (the port's GPU machine has
neither; the converted files are what travel there). SRC is one of:

- a params-only directory (`train/checkpoint.py::save_params_only`, the
  final artifact `{output}/{relation_type}-{fusion}-pretrained_model`):
  OUT becomes the flat `.npz` of `params.flatten_tree`, keyed by pytree
  path (`.npz` is appended when OUT lacks it); `--checkpoint OUT` of the
  port's eval, predict, serve and ensemble_eval reads it;
- a train-state directory (`save_checkpoint`'s `epoch_EEEE`,
  `epoch_EEEE_step_SSSSSSSS` or `best`): OUT becomes the port's checkpoint
  directory, OUT/state.npz, the parameters with Adamax's `mu`, `nu` and
  `count` (params.py::train_state_arrays);
- a whole `{output}/checkpoints/` root: OUT becomes the port's root, each
  train-state directory converted and `meta.json` copied as it is, so the
  port's `--resume --output X` with OUT = X/checkpoints continues where the
  JAX run stopped (a mid-epoch step checkpoint only when the run
  signature in meta.json matches the port's for the same flags; otherwise
  the port refuses the skip by name).

Each written file is printed with its leaf count and bytes. The port
itself imports neither JAX nor Orbax, nor this script.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
from typing import Any, Dict

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from tf_vqa_regat_tpu_torch.params import flatten_tree, train_state_arrays  # noqa: E402

MARKER = "_CHECKPOINT_METADATA"
STATE_FILE = "state.npz"
# the directories of a checkpoints/ root that hold a state (Orbax's
# temporary directories of an unfinished save are left out)
_STATE_DIR = re.compile(r"(epoch_\d{4}(_step_\d{8})?|best)")


def restore(path: str) -> Any:
    """The checkpoint's tree with numpy leaves, restored against a target
    built from its own metadata."""
    import jax
    import orbax.checkpoint as ocp

    jax.config.update("jax_platforms", "cpu")
    ckptr = ocp.StandardCheckpointer()
    meta = ckptr.metadata(os.path.abspath(path)).item_metadata
    tree = meta.tree if hasattr(meta, "tree") else meta
    target = jax.tree.map(lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype), tree)
    return jax.tree.map(np.asarray, ckptr.restore(os.path.abspath(path), target))


def is_train_state(tree: Any) -> bool:
    return isinstance(tree, dict) and {"params", "opt_state", "step"} <= set(tree)


def _report(path: str, flat: Dict[str, np.ndarray]) -> None:
    nbytes = sum(int(v.nbytes) for v in flat.values())
    print(f"wrote {path}: {len(flat)} leaves, {nbytes} bytes", flush=True)


def convert_state_dir(src: str, out: str) -> Dict[str, np.ndarray]:
    """A train-state directory -> the port's checkpoint directory out/."""
    tree = restore(src)
    if not is_train_state(tree):
        raise ValueError(f"{src}: not a train state (no params, opt_state and step)")
    flat = train_state_arrays(tree)
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, STATE_FILE), **flat)
    _report(os.path.join(out, STATE_FILE), flat)
    return flat


def convert(src: str, out: str) -> str:
    """Convert SRC (module docstring) to OUT; returns what was written."""
    src = os.path.abspath(src)
    if os.path.exists(os.path.join(src, MARKER)):
        tree = restore(src)
        if is_train_state(tree):
            convert_state_dir(src, out)
            return out
        flat = flatten_tree(tree)
        path = out if out.endswith(".npz") else out + ".npz"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **flat)
        _report(path, flat)
        return path
    if not os.path.isdir(src):
        raise ValueError(f"{src}: not an Orbax checkpoint directory or checkpoints/ root")
    dirs = sorted(d for d in os.listdir(src) if _STATE_DIR.fullmatch(d)
                  and os.path.exists(os.path.join(src, d, MARKER)))
    if not dirs:
        raise ValueError(f"{src}: holds no Orbax checkpoint ({MARKER})")
    os.makedirs(out, exist_ok=True)
    for d in dirs:
        convert_state_dir(os.path.join(src, d), os.path.join(out, d))
    meta = os.path.join(src, "meta.json")
    if os.path.exists(meta):
        shutil.copyfile(meta, os.path.join(out, "meta.json"))
        with open(meta) as fh:
            print(f"copied meta.json: {json.load(fh)}", flush=True)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("src", help="an Orbax params-only or train-state directory, or a "
                        "checkpoints/ root of the JAX package")
    parser.add_argument("out", help="the .npz (params-only) or directory to write")
    args = parser.parse_args(argv)
    convert(args.src, args.out)


if __name__ == "__main__":
    main()
