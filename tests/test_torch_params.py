"""Parameters carried between the JAX package and the PyTorch port
(tf_vqa_regat_tpu_torch/params.py): a JAX tree written as .npz, loaded into
the port and written back out must be bit-identical, with no key missing or
unexpected, for BUTD, BAN and MuTAN fusion (list-valued leaves, BAN's
scalar `h_mat/g`, MuTAN's plain `merge0/w`)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.config import Config
from tf_vqa_regat_tpu.models.regat import init_regat
from tf_vqa_regat_tpu_torch import config as tconfig
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.params import (
    flatten_tree,
    load_jax_arrays,
    load_npz,
    save_npz,
    to_jax_arrays,
)

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CFG = Config(
    num_hid=64, relation_dim=96, num_heads=4, nongt_dim=10, imp_pos_emb_dim=64,
    fusion="butd", relation_type="implicit", adaptive=True, num_rois=16,
    residual_connection=True, mutan_rank=3,
)
NTOKEN, V_DIM, NUM_ANS = 25, 32, 11
# a leaf of each fusion's own that the generic loader must carry
FUSION_LEAF = {
    "butd": "joint_emb/linear/layers/0/v",
    "ban": "joint_emb/b_v_net/1/layers/0/v",
    "mutan": "joint_emb/att_fusion/merge0/w",
}


@functools.lru_cache(maxsize=None)
def _jax_init(seed, fusion):
    cfg = dataclasses.replace(CFG, fusion=fusion)
    params = init_regat(jax.random.PRNGKey(seed), cfg, NTOKEN, V_DIM, NUM_ANS)
    return flatten_tree(jax.tree.map(np.asarray, params))


def _jax_flat(seed=0, fusion="butd"):
    """A fresh dict of the JAX init's arrays (callers drop and replace keys)."""
    return dict(_jax_init(seed, fusion))


def _port(fusion="butd"):
    cfg = dataclasses.replace(CFG, fusion=fusion)
    port_cfg = tconfig.Config(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(tconfig.Config)}
    )
    return ReGAT(port_cfg, NTOKEN, V_DIM, NUM_ANS, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("fusion", ["butd", "ban", "mutan"])
def test_npz_roundtrip_is_bit_identical(tmp_path, fusion):
    flat = _jax_flat(fusion=fusion)
    assert FUSION_LEAF[fusion] in flat
    if fusion == "ban":
        assert flat["joint_emb/h_mat/g"].shape == ()
    path = str(tmp_path / "jax.npz")
    np.savez(path, **flat)
    model = _port(fusion)
    load_jax_arrays(model, load_npz(path))
    save_npz(str(tmp_path / "port.npz"), model)
    back = load_npz(str(tmp_path / "port.npz"))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert np.array_equal(back[k], v), k
    assert np.array_equal(
        to_jax_arrays(model.state_dict())["v_relation/gatt/neighbor/0/pair_pos_fc/layers/0/v"],
        flat["v_relation/gatt/neighbor/0/pair_pos_fc/layers/0/v"],
    )


@pytest.mark.parametrize("fusion", ["butd", "ban", "mutan"])
def test_port_init_has_the_jax_tree(fusion):
    """The port's own init gives exactly the JAX pytree's keys, shapes and
    dtypes, so a checkpoint made by either side loads into the other."""
    flat = _jax_flat(fusion=fusion)
    ours = to_jax_arrays(_port(fusion).state_dict())
    assert sorted(ours) == sorted(flat)
    for k, v in flat.items():
        assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_loader_rejects_mismatched_trees(fault):
    flat = _jax_flat()
    key = "classifier/fc1/v"
    if fault == "missing":
        del flat[key]
    elif fault == "unexpected":
        flat["v_relation/gatt/bias/layers/0/v"] = np.zeros((1, 1), np.float32)
    else:
        flat[key] = flat[key][:, :-1]
    with pytest.raises(ValueError):
        load_jax_arrays(_port(), flat)
