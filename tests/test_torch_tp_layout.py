"""The port's tensor-parallel layout (parallel/mesh.py::shard_axis, the
split modules, params.py) against the JAX package's `param_shardings` and
`train_state_shardings` on a 1 x 2 mesh of the virtual CPU devices, for
implicit, spatial and semantic relations with BUTD, and implicit with BAN
and MuTAN, at small widths:

- every leaf's split axis (or none) equals the axis JAX's spec puts on the
  model axis, and so does every Adamax moment's (`opt/mu/<path>`,
  `opt/nu/<path>`);
- a model built for model index i of 2 holds, leaf for leaf, part i of the
  one-device model of the same seed along that axis (the rest whole);
- params.py's cut of the full arrays to the two parts, put back together,
  is the identity, and loading a part into the split model loads it.

Exact: layouts and copies.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.config import Config as JaxConfig
from tf_vqa_regat_tpu.models.regat import init_regat
from tf_vqa_regat_tpu.models.regat import trainable_mask as jax_trainable_mask
from tf_vqa_regat_tpu.parallel.mesh import MODEL_AXIS, make_mesh, param_shardings
from tf_vqa_regat_tpu.parallel.mesh import train_state_shardings
from tf_vqa_regat_tpu.train.optim import make_optimizer
from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.parallel.mesh import shard_axis
from tf_vqa_regat_tpu_torch.parallel.tensor import TensorParallel
from tf_vqa_regat_tpu_torch.params import load_jax_arrays, shard_arrays
from tf_vqa_regat_tpu_torch.params import to_jax_arrays

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

NTOKEN, V_DIM, NUM_ANS = 20, 32, 9
BASE = JaxConfig(num_hid=32, relation_dim=48, num_heads=4, nongt_dim=6, imp_pos_emb_dim=16,
                 fusion="butd", relation_type="implicit", mutan_rank=3)
FAMILIES = {
    "implicit": BASE,
    "spatial": BASE.replace(relation_type="spatial"),
    "semantic": BASE.replace(relation_type="semantic"),
    "ban": BASE.replace(fusion="ban"),
    "mutan": BASE.replace(fusion="mutan"),
}


def _axis(spec):
    """The axis a PartitionSpec puts on the model axis, or None."""
    return next((i for i, a in enumerate(spec) if a == MODEL_AXIS), None)


def _port_cfg(cfg):
    return Config(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(Config)})


@pytest.mark.parametrize("family", list(FAMILIES))
def test_split_axes_equal_jax_param_and_train_state_shardings(family):
    cfg = FAMILIES[family]
    mesh = make_mesh(1, 2, devices=jax.devices()[:2])
    # the layout needs shapes only
    params = jax.eval_shape(lambda k: init_regat(k, cfg, NTOKEN, V_DIM, NUM_ANS),
                            jax.random.PRNGKey(0))
    specs = {k: _axis(s.spec) for k, s in
             _flat_specs(param_shardings(params, mesh)).items()}
    port_paths = to_jax_arrays(ReGAT(_port_cfg(cfg), NTOKEN, V_DIM, NUM_ANS).state_dict())
    assert set(specs) == set(port_paths)
    assert any(a is not None for a in specs.values())
    for path, axis in specs.items():
        assert shard_axis(path) == axis, path
    opt = make_optimizer(1e-3, 0.25, 4, 0.75, 2, jax_trainable_mask(params, False))
    moments = _flat_specs(train_state_shardings(params, opt, mesh)["opt_state"])
    checked = 0
    for path, sharding in moments.items():
        for marker in ("/mu/", "/nu/"):
            if marker in f"/{path}/":
                sub = path.split(marker.strip("/") + "/", 1)[1]
                key = f"opt/{marker.strip('/')}/{sub}"
                assert shard_axis(key) == _axis(sharding.spec) == specs[sub], key
                checked += 1
    assert checked == 2 * len(specs)


def _flat_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    out = {}
    for kp, s in leaves:
        keys = []
        for k in kp:
            for attr in ("key", "idx", "name"):
                if hasattr(k, attr):
                    keys.append(str(getattr(k, attr)))
                    break
        out["/".join(keys)] = s
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_a_split_model_holds_its_part_and_the_cut_is_invertible(family):
    cfg = _port_cfg(FAMILIES[family])
    full = to_jax_arrays(ReGAT(cfg, NTOKEN, V_DIM, NUM_ANS).state_dict())
    parts = []
    for i in range(2):
        tp = TensorParallel(2, i)
        model = ReGAT(cfg, NTOKEN, V_DIM, NUM_ANS, tp=tp)
        own = to_jax_arrays(model.state_dict())
        cut = shard_arrays(full, tp)
        assert sorted(own) == sorted(full)
        for k, v in own.items():
            axis = shard_axis(k)
            want_shape = list(full[k].shape)
            if axis is not None:
                want_shape[axis] //= 2
            assert list(v.shape) == want_shape, k
            np.testing.assert_array_equal(v, cut[k], err_msg=k)
        # a part loads into the split model: the one-device params, cut
        shifted = {k: v + 1.0 for k, v in full.items()}
        load_jax_arrays(model, shifted)
        for k, v in to_jax_arrays(model.state_dict()).items():
            np.testing.assert_array_equal(v, shard_arrays(shifted, tp)[k], err_msg=k)
        parts.append(cut)
    for k, v in full.items():
        axis = shard_axis(k)
        joined = v if axis is None else np.concatenate([p[k] for p in parts], axis=axis)
        np.testing.assert_array_equal(joined, v, err_msg=k)
    moments = {f"opt/mu/{k}": v for k, v in full.items()}
    for k, v in moments.items():
        axis = shard_axis(k)
        if axis is not None:
            joined = np.concatenate([shard_arrays(moments, TensorParallel(2, i))[k]
                                     for i in range(2)], axis=axis)
            np.testing.assert_array_equal(joined, v, err_msg=k)
