"""The port's explicit relation families (spatial, semantic) with BUTD fusion
against the JAX package on the CPU, with the JAX parameters carried across
(params.py) and the same batches (the port's store gather, handed to both):

- eval logits against `apply_regat(train=False)` at impl="pallas" (B2 in
  interpret mode, one launch per direction) and impl="jnp" (both directions
  folded, per-head softmax), atol/rtol 1e-4, the same argmax;
- per-leaf gradients of the loss at --dropout 0 against `jax.grad` of
  `apply_regat(train=True, impl="pallas")` (VJP `_fused_bwd`), 1e-5 of each
  leaf's largest magnitude, that magnitude floored at 1e-6 of the largest
  gradient of all leaves: at this random init some leaves (q_att's first
  bias, BUTD's v2attention bias) get gradients a millionth of the largest,
  where both sides hold float noise. Leaves whose true gradient is zero (the
  frozen key biases, and the edge-label FC's bias, which shifts every edge
  key alike) carry only noise: they are held to 1e-5 of the largest gradient
  of all leaves;
- the dropout sites, in order, with their shapes and rates, against the JAX
  ones (recorded by wrapping `tf_vqa_regat_tpu.nn.dropout`, impl="jnp");
- the semantic synthetic split and the gathered `adj_label` against
  `fixtures.synthetic_dataset(semantic=True)` and `gather_adj`;
- the explicit parameter tree, leaf for leaf;
- the entry point on the CPU: train, eval and serve of each family.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu import nn as jnn
from tf_vqa_regat_tpu.config import Config
from tf_vqa_regat_tpu.data.device_store import DeviceStore as JaxDeviceStore
from tf_vqa_regat_tpu.data.device_store import gather_batch as jax_gather_batch
from tf_vqa_regat_tpu.data.fixtures import synthetic_dataset as jax_synthetic_dataset
from tf_vqa_regat_tpu.models.regat import apply_regat, init_regat
from tf_vqa_regat_tpu.train.loss import bce_with_logits_sum
from tf_vqa_regat_tpu_torch import config as tconfig
from tf_vqa_regat_tpu_torch import nn as tnn
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.main import build_server, main
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.params import flatten_tree, load_jax_arrays, to_jax_arrays
from tf_vqa_regat_tpu_torch.train.step import train_forward

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["spatial", "semantic"]
V_DIM, NUM_ANS, R = 32, 9, 16
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_RTOL = 1e-5


def _cfg(relation_type, dropout=0.0):
    return Config(
        num_hid=64, relation_dim=96, num_heads=4, nongt_dim=10, fusion="butd",
        relation_type=relation_type, adaptive=True, num_rois=R, label_bias=True,
        residual_connection=True, dropout=dropout, batch_size=8,
    )


def _port_cfg(cfg):
    return tconfig.Config(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(tconfig.Config)}
    )


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(cfg, JAX params tree, flat params, ntoken, two batches): 13 questions
    over 8 images, batches of 8 (the second with 3 padded slots)."""
    cfg = _cfg(request.param)
    ds = synthetic_dataset(num_images=8, num_questions=13, v_dim=V_DIM, num_ans=NUM_ANS,
                           seed=3, semantic=request.param == "semantic")
    store = DeviceStore(ds, torch.device("cpu"))
    params = jax.jit(lambda k: init_regat(k, cfg, ds.ntoken, V_DIM, NUM_ANS))(
        jax.random.PRNGKey(0)
    )
    batches = [
        gather_batch(store, torch.from_numpy(idx).long(), R)
        for idx in store.epoch_indices(0, cfg.batch_size, True, cfg.seed)
    ]
    assert ("adj_label" in batches[0]) == (request.param == "semantic")
    flat = flatten_tree(jax.tree.map(np.asarray, params))
    return cfg, params, flat, ds.ntoken, batches


def _port_model(cfg, flat, ntoken):
    model = ReGAT(_port_cfg(cfg), ntoken, V_DIM, NUM_ANS, torch.Generator().manual_seed(0))
    load_jax_arrays(model, flat)
    return model


def _jax_batch(batch):
    out = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    for k in ("question", "num_boxes", "adj_label"):
        if k in out:
            out[k] = out[k].astype(jnp.int32)
    return out


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
def test_logits_match_apply_regat(family, impl):
    cfg, params, flat, ntoken, batches = family
    model = _port_model(cfg, flat, ntoken).eval()
    fwd = jax.jit(lambda p, b: apply_regat(p, cfg, b, ntoken, train=False, impl=impl))
    for batch in batches:
        want = np.asarray(fwd(params, _jax_batch(batch)))
        with torch.inference_mode():
            got = model(batch).numpy()
        assert got.shape == (cfg.batch_size, NUM_ANS) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_per_leaf_gradients_match_jax(family):
    cfg, params, flat, ntoken, batches = family
    batch = batches[-1]  # padded slots included
    jb = _jax_batch(batch)

    def loss_fn(p):
        logits = apply_regat(p, cfg, jb, ntoken, train=True, rng=jax.random.PRNGKey(1),
                             impl="pallas")
        return bce_with_logits_sum(logits, jb["target"], jb["valid"])

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = flatten_tree(jax.tree.map(np.asarray, want))
    model = _port_model(cfg, flat, ntoken)
    loss, _ = train_forward(model, batch, 0, cfg.seed)
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    names = dict(model.named_parameters())
    assert {k.replace(".", "/") for k in names} == set(want)
    zero_grad = {n for n, t in trainable_mask(model, False).items() if not t}
    zero_grad.add("v_relation.gatt.bias.layers.0.b")
    top = max(np.abs(w).max() for w in want.values())
    for name, p in names.items():
        assert p.grad is not None, name  # no path drops a gradient
        w = want[name.replace(".", "/")]
        scale = top if name in zero_grad else max(np.abs(w).max(), 1e-6 * top)
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= GRAD_RTOL * scale, (name, err, scale)
    # the edge-label FC is reached through B2's dbias
    assert np.abs(names["v_relation.gatt.bias.layers.0.v"].grad.numpy()).max() > 0.0


def _record_jax_sites(cfg, params, ntoken, batch, monkeypatch):
    sites = []
    real = jnn.dropout

    def wrapper(x, rate, train, rngs):
        if train and rate > 0.0:
            sites.append((tuple(x.shape), rate))
        return real(x, rate, train, rngs)

    monkeypatch.setattr(jnn, "dropout", wrapper)
    jax.eval_shape(  # traces the forward once, without compiling it
        lambda p, b: apply_regat(p, cfg, b, ntoken, train=True, rng=jax.random.PRNGKey(1),
                                 impl="jnp"),
        params, _jax_batch(batch),
    )
    return sites


def test_dropout_sites_and_rates(family, monkeypatch):
    """At --dropout 0.5: the language stack and the classifier at 0.5; the
    relation encoder (self_weights input; per direction the one-hot labels,
    then Q and K inputs; the summed output) and BUTD at 0.2."""
    cfg, params, flat, ntoken, batches = family
    cfg = dataclasses.replace(cfg, dropout=0.5)
    batch = batches[0]
    want = _record_jax_sites(cfg, params, ntoken, batch, monkeypatch)
    sites = []
    real = tnn.dropout_draw

    def recorder(shape, rate, generator, device):
        sites.append((tuple(shape), rate))
        return real(shape, rate, generator, device)

    monkeypatch.setattr(tnn, "dropout_draw", recorder)
    model = _port_model(cfg, flat, ntoken)
    train_forward(model, batch, 4, cfg.seed)
    assert sites == want
    b, n, L, D = cfg.batch_size, cfg.nongt_dim, 11 if cfg.relation_type == "spatial" else 15, 96
    label_sites = [i for i, s in enumerate(sites) if s == ((b, R, n, L), 0.2)]
    assert len(label_sites) == 2  # one per direction, before the label FC
    for i in label_sites:  # then that direction's Q and K inputs
        assert sites[i + 1 : i + 3] == [((b, R, D), 0.2), ((b, n, D), 0.2)]


def test_semantic_split_and_adj_gather_equal_jax():
    kw = dict(num_images=9, num_questions=21, v_dim=16, num_ans=20, seed=4)
    ours = synthetic_dataset(semantic=True, **kw)
    ref = jax_synthetic_dataset(adaptive=True, semantic=True, **kw)
    assert ours.store.semantic_adj.dtype == ref.store.semantic_adj.dtype
    np.testing.assert_array_equal(ours.store.semantic_adj, ref.store.semantic_adj)
    for a, b in [(ours.store.features, ref.store.features), (ours.store.bb, ref.store.bb),
                 (ours.store.normalized_bb, ref.store.normalized_bb)]:
        np.testing.assert_array_equal(a, b)
    for field in [f.name for f in dataclasses.fields(ours.entries)]:
        np.testing.assert_array_equal(getattr(ours.entries, field), getattr(ref.entries, field))

    port = DeviceStore(ours, torch.device("cpu"))
    jstore = JaxDeviceStore(ref, include_adj=True)
    idx = list(port.epoch_indices(0, 16, True, seed=7))[-1]  # 11 padded slots
    for num_rois in (24, 120):  # cut to, and padded past, the table's 100
        got = gather_batch(port, torch.from_numpy(idx).long(), num_rois)
        want = jax_gather_batch(jstore.arrays, jnp.asarray(idx), num_rois, 20, ref.padding_idx)
        for k in ("adj_label", "norm_bb", "bb", "num_boxes", "valid"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        adj = got["adj_label"].numpy()
        assert not adj[~got["valid"].numpy()].any() and adj.max() == 15
        assert not adj[:, 100:].any() and not adj[:, :, 100:].any()


@pytest.mark.parametrize("relation_type", FAMILIES)
def test_explicit_parameter_tree_matches_jax(relation_type):
    """The port's init has the JAX explicit pytree (`gatt/bias`, no
    `pair_pos_fc`), with and without the label FC's bias."""
    for label_bias in (True, False):
        cfg = dataclasses.replace(_cfg(relation_type), label_bias=label_bias)
        params = jax.eval_shape(lambda: init_regat(jax.random.PRNGKey(0), cfg, 25, V_DIM, NUM_ANS))
        leaves = flatten_tree(jax.tree.map(lambda s: np.empty(s.shape, s.dtype), params))
        want = {k: (v.shape, v.dtype) for k, v in leaves.items()}
        ours = to_jax_arrays(ReGAT(_port_cfg(cfg), 25, V_DIM, NUM_ANS).state_dict())
        assert {k: (v.shape, v.dtype) for k, v in ours.items()} == want
        assert ("v_relation/gatt/bias/layers/0/b" in ours) == label_bias
        assert not any("pair_pos_fc" in k for k in ours)


@pytest.mark.parametrize("relation_type", FAMILIES)
def test_entry_point_trains_evaluates_and_serves(relation_type, tmp_path):
    flags = [
        "--config", os.path.join(REPO, "configs", f"{relation_type}_vqa.json"),
        "--num_hid", "64", "--relation_dim", "96", "--num_heads", "4", "--nongt_dim", "10",
        "--num_rois", "24", "--synthetic", "--synthetic_val_size", "16", "--batch_size", "16",
        "--device", "cpu", "--output", str(tmp_path),
    ]
    path = main(flags + ["--mode", "train", "--epochs", "1", "--synthetic_train_size", "32"])
    assert path.endswith(f"{relation_type}-butd-pretrained_model.npz")
    with open(tmp_path / "metrics.jsonl") as fh:
        last = [json.loads(line) for line in fh][-1]
    score, loss = main(flags + ["--mode", "eval", "--checkpoint", path])
    assert loss == last["eval_loss"] and score == last["eval_score"]
    server, batcher, engine = build_server(
        flags + ["--mode", "serve", "--checkpoint", path, "--serve_port", "0",
                 "--serve_batch_sizes", "2"]
    )
    try:
        answers = engine.infer(["what color is the cat ?", "is the man on the car ?"], [1, 5])
        assert all(a["answer"] in engine.ds.label2ans for a in answers)
        assert (engine.store.adj is not None) == (relation_type == "semantic")
    finally:
        batcher.close()
        server.server_close()
