"""The port's train step against the JAX package's on the CPU, with the JAX
parameters carried across (params.py) and the same batches (the port's
device-store gather, handed to both):

- per-leaf gradients of the loss at --dropout 0 against `jax.grad` of
  `bce_with_logits_sum(apply_regat(train=True))`, at impl="pallas" (B1 in
  interpret mode, VJP `_fused_v3_bwd`) and impl="jnp", for BUTD, BAN and
  MuTAN fusion (MuTAN at rank 3); every parameter gets a gradient;
- a 5-step trajectory of `train_step` against the JAX `build_train_step`
  (one-device mesh, impl="pallas");
- at --dropout 0.2 and 0.5 (BUTD) and 0.2 (BAN, MuTAN): the dropout
  sites, in order, with their shapes and rates, against the JAX ones (recorded by wrapping
  `tf_vqa_regat_tpu.nn.dropout` while the forward is traced, impl="jnp",
  whose sinusoid dropout is B1's keep-mask); the keep rate; and masks that
  depend only on seed and step.

Tolerances: gradients atol/rtol 1e-4 (f32 sums in another order through the
stacked matmuls, the GRU and the attention backward); per-step losses
rel 1e-4; final parameters atol 1e-5 after 5 Adamax steps of lr 1e-3, where
one step moves a leaf by at most lr (Adamax's |update| <= lr).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu import nn as jnn
from tf_vqa_regat_tpu.config import Config
from tf_vqa_regat_tpu.models.regat import apply_regat, init_regat
from tf_vqa_regat_tpu.models.regat import trainable_mask as jax_trainable_mask
from tf_vqa_regat_tpu.parallel.mesh import make_mesh
from tf_vqa_regat_tpu.train.loss import bce_with_logits_sum
from tf_vqa_regat_tpu.train.optim import make_optimizer
from tf_vqa_regat_tpu.train.step import build_train_step, init_train_state
from tf_vqa_regat_tpu_torch import config as tconfig
from tf_vqa_regat_tpu_torch import nn as tnn
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.params import flatten_tree, load_jax_arrays
from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
from tf_vqa_regat_tpu_torch.train.step import train_forward, train_step

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CFG = Config(
    num_hid=64, relation_dim=96, num_heads=4, nongt_dim=10, imp_pos_emb_dim=64,
    fusion="butd", relation_type="implicit", adaptive=True, num_rois=16,
    residual_connection=True, dropout=0.0, batch_size=8, base_lr=1e-3, mutan_rank=3,
)
V_DIM, NUM_ANS, SEED = 32, 9, 3
TOL = dict(atol=1e-4, rtol=1e-4)


def _port_cfg(cfg):
    return tconfig.Config(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(tconfig.Config)}
    )


@pytest.fixture(scope="module")
def data():
    """(ntoken, five batches): 40 questions over 8 images, batches of 8 in
    the seed's epoch-0 order."""
    ds = synthetic_dataset(num_images=8, num_questions=40, v_dim=V_DIM, num_ans=NUM_ANS, seed=SEED)
    store = DeviceStore(ds, torch.device("cpu"))
    R = CFG.resolved_num_rois()
    batches = [
        gather_batch(store, torch.from_numpy(idx).long(), R)
        for idx in store.epoch_indices(0, CFG.batch_size, True, CFG.seed)
    ]
    return ds.ntoken, batches


@functools.lru_cache(maxsize=None)
def _jax_flat(fusion, ntoken):
    """The JAX init of the model with `fusion`, as flat numpy arrays (the
    dropout rate does not change it)."""
    cfg = dataclasses.replace(CFG, fusion=fusion)
    params = jax.jit(lambda k: init_regat(k, cfg, ntoken, V_DIM, NUM_ANS))(jax.random.PRNGKey(0))
    return flatten_tree(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def setup(data):
    """(JAX params as numpy, ntoken, five batches) of the BUTD model."""
    ntoken, batches = data
    return _jax_flat("butd", ntoken), ntoken, batches


def _port_model(flat, ntoken, cfg=CFG):
    model = ReGAT(_port_cfg(cfg), ntoken, V_DIM, NUM_ANS, torch.Generator().manual_seed(0))
    load_jax_arrays(model, flat)
    return model


def _jax_batch(batch):
    out = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    out["question"] = out["question"].astype(jnp.int32)
    out["num_boxes"] = out["num_boxes"].astype(jnp.int32)
    out["norm_bb"] = jnp.zeros(batch["bb"].shape[:2] + (6,), jnp.float32)
    return out


def _unflatten(flat):
    """Flat {path: array} -> the nested JAX tree (lists where keys are indices)."""
    tree = {}
    for path, v in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(v)

    def fix(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(tree)


@pytest.mark.parametrize(
    "fusion, impl",
    [("butd", "pallas"), ("butd", "jnp"), ("ban", "pallas"), ("mutan", "pallas")],
)
def test_per_leaf_gradients_match_jax(data, fusion, impl):
    ntoken, batches = data
    cfg = dataclasses.replace(CFG, fusion=fusion)
    flat = _jax_flat(fusion, ntoken)
    batch = batches[-1]  # padded slots included
    jb = _jax_batch(batch)

    def loss_fn(p):
        logits = apply_regat(p, cfg, jb, ntoken, train=True, rng=jax.random.PRNGKey(1), impl=impl)
        return bce_with_logits_sum(logits, jb["target"], jb["valid"])

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(_unflatten(flat))
    want = flatten_tree(jax.tree.map(np.asarray, want))
    model = _port_model(flat, ntoken, cfg)
    loss, _ = train_forward(model, batch, 0, CFG.seed)
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    names = dict(model.named_parameters())
    assert {k.replace(".", "/") for k in names} == set(want)
    for name, p in names.items():
        assert p.grad is not None, name  # no path drops a gradient
        np.testing.assert_allclose(p.grad.numpy(), want[name.replace(".", "/")], **TOL, err_msg=name)


def test_five_step_trajectory_matches_build_train_step(setup):
    flat, ntoken, batches = setup
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    params = _unflatten(flat)
    steps = len(batches)
    opt = make_optimizer(
        CFG.base_lr, CFG.grad_clip, steps, CFG.lr_decay_rate, CFG.lr_decay_step,
        jax_trainable_mask(params, False),
    )
    state = init_train_state(params, opt, mesh)
    step = build_train_step(CFG, ntoken, opt, mesh, "pallas", params)
    rng = jax.random.PRNGKey(CFG.seed + 1)

    model = _port_model(flat, ntoken)
    schedule = make_lr_schedule(CFG.base_lr, steps, CFG.lr_decay_rate, CFG.lr_decay_step)
    port_opt = Adamax(model, trainable_mask(model, False), schedule, CFG.grad_clip)
    for i, batch in enumerate(batches):
        state, m = step(state, _jax_batch(batch), rng)
        got = train_step(model, port_opt, batch, i, CFG.seed)
        assert got["loss"].item() == pytest.approx(float(m["loss"]), rel=1e-4), i
        assert got["n"].item() == float(m["n"])
    want = flatten_tree(jax.tree.map(np.asarray, state["params"]))
    moved = 0.0
    for name, p in model.named_parameters():
        w = want[name.replace(".", "/")]
        np.testing.assert_allclose(p.detach().numpy(), w, atol=1e-5, rtol=0, err_msg=name)
        moved = max(moved, float(np.abs(w - flat[name.replace(".", "/")]).max()))
    assert moved > 1e-3  # the parameters did move


def _record_jax_sites(cfg, flat, ntoken, batch, monkeypatch):
    sites = []
    real = jnn.dropout

    def wrapper(x, rate, train, rngs):
        if train and rate > 0.0:
            sites.append((tuple(x.shape), rate))
        return real(x, rate, train, rngs)

    monkeypatch.setattr(jnn, "dropout", wrapper)
    jax.eval_shape(  # traces the forward once, without compiling it
        lambda p, b: apply_regat(
            p, cfg, b, ntoken, train=True, rng=jax.random.PRNGKey(1), impl="jnp"
        ),
        _unflatten(flat), _jax_batch(batch),
    )
    return sites


@pytest.mark.parametrize(
    "fusion, drop", [("butd", 0.2), ("butd", 0.5), ("ban", 0.2), ("mutan", 0.2)]
)
def test_dropout_sites_rates_and_masks(data, monkeypatch, fusion, drop):
    ntoken, batches = data
    cfg = dataclasses.replace(CFG, dropout=drop, fusion=fusion)
    flat = _jax_flat(fusion, ntoken)
    batch = batches[0]
    want = _record_jax_sites(cfg, flat, ntoken, batch, monkeypatch)

    masks, sites = [], []
    real = tnn.dropout_draw

    def recorder(shape, rate, generator, device):
        bits, t = real(shape, rate, generator, device)
        sites.append((tuple(shape), rate))
        masks.append(bits >= t)
        return bits, t

    # every draw, B1's keep-mask's included, goes through nn.dropout_draw
    monkeypatch.setattr(tnn, "dropout_draw", recorder)
    model = _port_model(flat, ntoken, cfg)
    loss, _ = train_forward(model, batch, 4, cfg.seed)
    assert sites == want
    b, R, n, P = batch["features"].shape[0], cfg.resolved_num_rois(), cfg.nongt_dim, 64
    assert sites.count(((b, R, n, P), 0.2)) == 2  # B1's keep-mask, one per direction
    assert drop in {r for _, r in sites} and 0.2 in {r for _, r in sites}

    kept = torch.cat([m.flatten() for m, (_, r) in zip(masks, sites) if r == 0.2]).double()
    p = 205.0 / 256.0
    assert abs(kept.mean().item() - p) < 3.0 * np.sqrt(p * (1 - p) / kept.numel())

    first = list(masks)
    masks.clear()
    loss_again, _ = train_forward(model, batch, 4, cfg.seed)
    assert all(torch.equal(a, b) for a, b in zip(first, masks))
    assert loss_again.item() == loss.item()
    masks.clear()
    train_forward(model, batch, 5, cfg.seed)
    assert not all(torch.equal(a, b) for a, b in zip(first, masks))
