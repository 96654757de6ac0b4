"""`--compute_dtype bfloat16` for the BAN and MuTAN fusions of the port
against the JAX package on the CPU, with the JAX parameters carried across
(params.py), the same inputs from a numpy seed, dropout off unless a test
says otherwise:

- BAN (glimpse 2 and 4), a MuTAN block in each formulation (rank 3: the
  naive per-roi merge, fed the question already broadcast over the rois,
  and the reassociated fold) and the whole MuTAN fusion: outputs and
  per-leaf gradients (random cotangents on every output);
- the whole model (implicit relations, B1's plain version on the port's
  side, JAX at impl="pallas" with B1 in interpret mode) with BAN and with
  MuTAN: answer logits, the per-leaf gradients of one train step's loss,
  and an Adamax step that leaves the parameters and its state in f32;
- the dtype of every activation site JAX casts at (dense layers, FCNets,
  dropout inputs, contractions, module outputs), read from the JAX modules'
  trace in call order, in train with dropout for BAN, for MuTAN's naive
  train step and for its reassociated one (`mutan_shared_qdrop`);
- the entry point at small widths: `--compute_dtype bfloat16` trains
  ban_vqa.json and mutan_vqa_cp.json (with and without
  `--mutan_shared_qdrop`), and `--mode eval` reproduces the last eval loss.

Tolerance (test_torch_bf16.py's rule): a bf16 value of the port is held to
JAX's f32 value within twice the gap JAX's own bf16 value shows,
gap(port_bf16, jax_f32) <= 2 * gap(jax_bf16, jax_f32), with gap the largest
difference over the largest |jax_f32|; and the port's gap must exceed 1e-4,
so that bf16 really ran. Gradients, leaf by leaf, with three refinements:

- a leaf is not held closer than one bf16 unit roundoff, 2**-8 of its
  largest |gradient|: both frameworks round the gradient of every rounded
  operand to bf16 (the VJP of the cast), so a gap below that is where the
  roundings fell, and twice a lucky draw is no bound;
- a weight norm's scale g (a 0-d leaf) has for gradient <dW, v>/||v||, a
  sum that cancels to ~1e-2 of its terms, so bf16 rounding moves it by
  ~10% in either framework. It is held through the kernel it scales: the
  rule applies to dW = (||v|| / g) dv + (dg / ||v||) v, the gradient of
  W = g v / ||v|| that (dv, dg) encode;
- a leaf whose true gradient is zero (a bias that shifts every roi's score
  alike before a softmax, or B1's pos-FC kernel while every relu output sits
  under the log's 1e-6 floor) holds only rounding noise, at f32 too. Such a
  leaf is known by its f32 gradients disagreeing across the two frameworks
  by more than 1e-3 of their size (test_torch_train_step.py holds every
  other leaf to 1e-4, and here they agree to 1e-4); it is held to stay
  below one bf16 unit roundoff of the call's largest gradient.
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
from tf_vqa_regat_tpu.models import ban as jban
from tf_vqa_regat_tpu.models import mutan as jmutan
from tf_vqa_regat_tpu.models.regat import apply_regat, init_regat
from tf_vqa_regat_tpu.ops import weight_norm as jwn
from tf_vqa_regat_tpu.train.loss import bce_with_logits_sum
from tf_vqa_regat_tpu_torch import config as tconfig
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.main import main
from tf_vqa_regat_tpu_torch.models import ban as tban
from tf_vqa_regat_tpu_torch.models import mutan as tmutan
from tf_vqa_regat_tpu_torch.models.ban import BAN
from tf_vqa_regat_tpu_torch.models.mutan import MutanBlock, MuTAN
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.ops import weight_norm as twn
from tf_vqa_regat_tpu_torch.ops.weight_norm import FCNet
from tf_vqa_regat_tpu_torch.params import flatten_tree, load_jax_arrays
from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
from tf_vqa_regat_tpu_torch.train.step import train_forward, train_step

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, R, T, V_DIM, Q_DIM, NUM_ANS, RANK, GLIMPSE = 3, 10, 14, 40, 32, 17, 3, 2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
U_BF16 = 2.0 ** -8
F32_AGREE = 1e-3  # a leaf's f32 gradients across frameworks; above: rounding noise only


def _gap(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _within_twice_jax(port, jax_bf16, jax_f32, what):
    gap, jax_gap = _gap(port, jax_f32), _gap(jax_bf16, jax_f32)
    assert 1e-4 < gap <= 2 * jax_gap, (what, gap, jax_gap)


def _kernel_grads(grads, params):
    """Each weight norm's scale leaf `.../g` -> the gradient of the kernel it
    makes, keyed `.../W`; every other leaf as it is."""
    out = {}
    for k, d in grads.items():
        if k.endswith("/g"):
            v, g = params[k[:-1] + "v"].astype(np.float64), float(params[k])
            n = np.linalg.norm(v)
            out[k[:-1] + "W"] = (n / g) * grads[k[:-1] + "v"] + (float(d) / n) * v
        else:
            out[k] = d
    return out


def _grads_within_rule(port_bf16, port_f32, jax_bf16, jax_f32, params, leaves=None):
    """The gradient rule of the module docstring over `leaves` (default all)
    -> the number of leaves held as rounding noise."""
    leaves = set(leaves or jax_f32)
    port_bf16, port_f32, jax_bf16, jax_f32 = (
        _kernel_grads({k: v for k, v in grads.items() if k in leaves}, params)
        for grads in (port_bf16, port_f32, jax_bf16, jax_f32))
    scale = max(float(np.abs(g).max()) for g in jax_f32.values())
    noise = 0
    for k in jax_f32:
        if _gap(port_f32[k], jax_f32[k]) > F32_AGREE:
            noise += 1
            assert float(np.abs(port_bf16[k]).max()) <= U_BF16 * scale, k
            continue
        gap, jax_gap = _gap(port_bf16[k], jax_f32[k]), _gap(jax_bf16[k], jax_f32[k])
        assert gap <= max(2 * jax_gap, U_BF16), (k, gap, jax_gap)
    return noise


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    num_boxes = np.array([R, 6, 0])  # whole, partly padded, fully padded
    roi_mask = np.arange(R)[None, :] < num_boxes[:, None]
    v = (rng.randn(B, R, V_DIM) * roi_mask[..., None]).astype(np.float32)
    q_seq = rng.randn(B, T, Q_DIM).astype(np.float32)
    return v, q_seq, roi_mask


def _load(port, params):
    load_jax_arrays(port, flatten_tree(jax.tree.map(np.asarray, params)))
    return port


def _run(jax_fn, port_fn, params, cotangent_seed=5):
    """Per dtype: outputs and parameter gradients of the JAX function and of
    the port, for the loss sum(out * w) over every output with random w.
    `port_fn(dtype)` -> (the port module, a call that gives its outputs)."""
    res = {}
    for name, (jd, td) in DTYPES.items():
        port, call = port_fn(td)
        outs = call()
        rng = np.random.RandomState(cotangent_seed)
        w = [rng.randn(*o.shape).astype(np.float32) for o in outs]
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, w)).backward()

        def loss_fn(p):
            return sum(jnp.sum(o * c) for o, c in zip(jax_fn(p, jd), w))

        want = jax.jit(jax.grad(loss_fn))(params)
        res[name] = {
            "jax": ([np.asarray(o) for o in jax.jit(lambda p: jax_fn(p, jd))(params)],
                    flatten_tree(jax.tree.map(np.asarray, want))),
            "port": ([o.detach().numpy() for o in outs],
                     {k.replace(".", "/"): p.grad.numpy() for k, p in port.named_parameters()}),
        }
    return res


def _check(res, params, what):
    f32, bf16 = res["float32"], res["bfloat16"]
    for i, (got, jb, jf) in enumerate(zip(bf16["port"][0], bf16["jax"][0], f32["jax"][0])):
        assert got.dtype == np.float32 and np.isfinite(got).all()
        _within_twice_jax(got, jb, jf, f"{what} output {i}")
    assert sorted(bf16["port"][1]) == sorted(f32["jax"][1])
    _grads_within_rule(bf16["port"][1], f32["port"][1], bf16["jax"][1], f32["jax"][1],
                       flatten_tree(jax.tree.map(np.asarray, params)))


@pytest.mark.parametrize("glimpse", [2, 4])
def test_ban_bf16_outputs_and_gradients(glimpse):
    params = jban.ban_init(jax.random.PRNGKey(glimpse), V_DIM, Q_DIM, glimpse)
    v, q, roi_mask = _inputs()

    def jax_fn(p, cd):
        return jban.ban_apply(p, jnp.asarray(v), jnp.asarray(q), jnp.asarray(roi_mask),
                              0.0, True, None, cd)

    def port_fn(cd):
        port = _load(BAN(V_DIM, Q_DIM, glimpse, torch.Generator().manual_seed(0), 0.0, cd),
                     params).train()
        return port, lambda: port(*map(torch.from_numpy, (v, q, roi_mask)))

    _check(_run(jax_fn, port_fn, params), params, f"ban glimpse {glimpse}")


@pytest.mark.parametrize("branch", ["naive", "reassociated"])
def test_mutan_block_bf16_outputs_and_gradients(monkeypatch, branch):
    params = jmutan._mutan_block_init(jax.random.PRNGKey(3), Q_DIM, V_DIM, 24, RANK)
    v, q_seq, _ = _inputs(2)
    q = q_seq[:, 0]
    x0 = q[:, None, :] if branch == "reassociated" else np.repeat(q[:, None, :], R, axis=1)
    calls = []
    real = getattr(MutanBlock, branch)
    monkeypatch.setattr(MutanBlock, branch,
                        lambda self, h0, h1: calls.append(branch) or real(self, h0, h1))

    def jax_fn(p, cd):
        return (jmutan._mutan_block_apply(p, jnp.asarray(x0), jnp.asarray(v), RANK, 0.0,
                                          True, None, cd),)

    def port_fn(cd):
        port = _load(MutanBlock(Q_DIM, V_DIM, 24, RANK, torch.Generator().manual_seed(0),
                                dtype=cd), params).train()
        return port, lambda: (port(torch.from_numpy(x0), torch.from_numpy(v)),)

    _check(_run(jax_fn, port_fn, params), params, f"mutan block {branch}")
    assert calls == [branch, branch]


def test_mutan_bf16_outputs_and_gradients():
    """The whole fusion: the attention block reassociated, the answer block
    naive (its inputs have no roi axis)."""
    params = jmutan.mutan_init(jax.random.PRNGKey(4), V_DIM, Q_DIM, NUM_ANS, RANK, GLIMPSE)
    v, q_seq, roi_mask = _inputs(3)
    q = q_seq[:, 0]

    def jax_fn(p, cd):
        return jmutan.mutan_apply(p, jnp.asarray(v), jnp.asarray(q), jnp.asarray(roi_mask),
                                  0.0, True, None, cd, RANK)

    def port_fn(cd):
        port = _load(MuTAN(V_DIM, Q_DIM, NUM_ANS, RANK, GLIMPSE,
                           torch.Generator().manual_seed(0), dtype=cd), params).train()
        return port, lambda: port(*map(torch.from_numpy, (v, q, roi_mask)))

    _check(_run(jax_fn, port_fn, params), params, "mutan")


def _jax_sites(monkeypatch, fn):
    """(kind, dtype) of every site in call order while `fn` is traced."""
    sites = []

    def wrap(module, name, kind, when=lambda *a: True, out=lambda r, *a: r):
        real = getattr(module, name)

        def wrapper(*a, **kw):
            r = real(*a, **kw)
            if when(*a):
                sites.append((kind, str(out(r, *a).dtype)))
            return r

        monkeypatch.setattr(module, name, wrapper)

    wrap(jmutan, "_linear", "linear")
    wrap(jwn, "fcnet_apply", "fcnet")
    wrap(jnp, "einsum", "contraction")
    wrap(jnn, "dropout", "dropout", when=lambda x, rate, train, rngs: train and rate > 0.0,
         out=lambda r, x, *a: x)
    try:
        jax.eval_shape(fn)
    finally:
        monkeypatch.undo()
    return sites


def _port_sites(monkeypatch, module, fn):
    sites = []
    for m in module.modules():
        if isinstance(m, (tmutan.Linear, FCNet)):
            kind = "linear" if isinstance(m, tmutan.Linear) else "fcnet"
            m.register_forward_hook(
                lambda _, __, out, kind=kind: sites.append((kind, str(out.dtype)[6:])))
    for name in ("einsum", "bmm"):
        def contraction(*a, real=getattr(torch, name)):
            r = real(*a)
            sites.append(("contraction", str(r.dtype)[6:]))
            return r

        monkeypatch.setattr(torch, name, contraction)
    for mod in (tban, tmutan, twn):
        real = mod.dropout

        def dropout(x, rate, train, generator=None, real=real):
            if train and rate > 0.0:
                sites.append(("dropout", str(x.dtype)[6:]))
            return real(x, rate, train, generator)

        monkeypatch.setattr(mod, "dropout", dropout)
    outs = fn()
    monkeypatch.undo()
    return sites, outs


@pytest.mark.parametrize("fusion", ["ban", "mutan_naive", "mutan_reassociated"])
def test_bf16_site_dtypes_match_jax(monkeypatch, fusion):
    """Train with dropout on: BAN's second dropout acts on its bf16 visual
    projection; MuTAN's input dropout on f32 dense outputs; the naive merge
    stays f32, the reassociated fold, zb and z are bf16; the attention MLP
    bf16; the glimpse sum, BAN's logits and pooling f32."""
    v, q_seq, roi_mask = _inputs(4)
    gen = torch.Generator().manual_seed(1)
    rngs = jnn.RngGen(jax.random.PRNGKey(1))
    if fusion == "ban":
        params = jban.ban_init(jax.random.PRNGKey(2), V_DIM, Q_DIM, GLIMPSE)
        want = _jax_sites(monkeypatch, lambda: jban.ban_apply(
            params, jnp.asarray(v), jnp.asarray(q_seq), jnp.asarray(roi_mask), 0.2, True,
            rngs, jnp.bfloat16))
        port = _load(BAN(V_DIM, Q_DIM, GLIMPSE, gen, 0.2, torch.bfloat16), params).train()
        args = (v, q_seq, roi_mask)
    else:
        shared = fusion == "mutan_reassociated"
        params = jmutan.mutan_init(jax.random.PRNGKey(2), V_DIM, Q_DIM, NUM_ANS, RANK, GLIMPSE)
        want = _jax_sites(monkeypatch, lambda: jmutan.mutan_apply(
            params, jnp.asarray(v), jnp.asarray(q_seq[:, 0]), jnp.asarray(roi_mask), 0.2,
            True, rngs, jnp.bfloat16, RANK, shared))
        port = _load(MuTAN(V_DIM, Q_DIM, NUM_ANS, RANK, GLIMPSE, gen, 0.2, shared,
                           torch.bfloat16), params).train()
        args = (v, q_seq[:, 0], roi_mask)
    got, outs = _port_sites(monkeypatch, port, lambda: port(
        *[torch.from_numpy(x) for x in args], torch.Generator().manual_seed(2)))
    assert got == want
    assert [str(o.dtype) for o in outs] == ["torch.float32", "torch.float32"]
    kinds = {k for k, _ in want}
    assert {"dropout", "fcnet", "contraction"} <= kinds and ("bfloat16" in str(want))
    if fusion == "mutan_reassociated":  # fold, zb, z
        assert [d for k, d in want if k == "contraction"][:3] == ["bfloat16"] * 3


V, A, RM = 32, 9, 16


def _cfg(fusion, compute_dtype):
    return Config(
        num_hid=64, relation_dim=96, num_heads=4, nongt_dim=10, fusion=fusion,
        relation_type="implicit", adaptive=True, num_rois=RM, residual_connection=True,
        dropout=0.0, batch_size=8, compute_dtype=compute_dtype, mutan_rank=RANK,
        ban_glimpse=GLIMPSE, use_pallas=True,
    )


@pytest.fixture(scope="module")
def model_batch():
    ds = synthetic_dataset(num_images=8, num_questions=13, v_dim=V, num_ans=A, seed=3)
    store = DeviceStore(ds, torch.device("cpu"))
    idx = next(store.epoch_indices(0, 8, False, 0))
    batch = gather_batch(store, torch.from_numpy(idx).long(), RM)
    jb = {k: jnp.asarray(x.numpy()) for k, x in batch.items()}
    jb["question"] = jb["question"].astype(jnp.int32)
    jb["num_boxes"] = jb["num_boxes"].astype(jnp.int32)
    return ds.ntoken, batch, jb


@pytest.mark.parametrize("fusion", ["ban", "mutan"])
def test_regat_bf16_logits_gradients_and_step(model_batch, fusion):
    ntoken, batch, jb = model_batch
    params = init_regat(jax.random.PRNGKey(0), _cfg(fusion, "float32"), ntoken, V, A)
    flat = flatten_tree(jax.tree.map(np.asarray, params))
    res = {}
    for cd in DTYPES:
        cfg = _cfg(fusion, cd)

        def loss_fn(p, cfg=cfg):
            logits = apply_regat(p, cfg, jb, ntoken, train=True, rng=jax.random.PRNGKey(1),
                                 impl="pallas")
            return bce_with_logits_sum(logits, jb["target"], jb["valid"]), logits

        (_, jlogits), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        port_cfg = tconfig.Config(
            **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(tconfig.Config)})
        model = ReGAT(port_cfg, ntoken, V, A)
        load_jax_arrays(model, flat)
        loss, logits = train_forward(model, batch, 0, cfg.seed)
        loss.backward()
        res[cd] = (np.asarray(jlogits), flatten_tree(jax.tree.map(np.asarray, jgrads)),
                   logits.detach().numpy(),
                   {k.replace(".", "/"): p.grad.numpy() for k, p in model.named_parameters()})
    (jf_logits, jf_grads, pf_logits, pf_grads), (jb_logits, jb_grads, pb_logits, pb_grads) = (
        res["float32"], res["bfloat16"])
    assert pb_logits.dtype == np.float32 and np.isfinite(pb_logits).all()
    _within_twice_jax(pb_logits, jb_logits, jf_logits, f"{fusion} logits")
    trainable = [k.replace(".", "/") for k, t in trainable_mask(model, False).items() if t]
    _grads_within_rule(pb_grads, pf_grads, jb_grads, jf_grads, flat, trainable)

    opt = Adamax(model, trainable_mask(model, False), make_lr_schedule(1e-3, 4, 0.25, 2), 0.25)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    m = train_step(model, opt, batch, 1, 0)
    assert m["loss"].dtype == torch.float32 and torch.isfinite(m["loss"])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(t.dtype == torch.float32 for t in opt.mu + opt.nu)
    moved = [k for k, t in model.state_dict().items() if not torch.equal(t, before[k])]
    assert len(moved) > 40


WIDTHS = [
    "--num_hid", "64", "--relation_dim", "96", "--num_heads", "4", "--nongt_dim", "10",
    "--num_rois", "24", "--synthetic", "--synthetic_val_size", "32",
    "--synthetic_train_size", "64", "--batch_size", "16", "--print_freq", "2",
    "--device", "cpu", "--compute_dtype", "bfloat16",
]
RUNS = {
    "ban": ["ban_vqa.json"],
    "mutan": ["mutan_vqa_cp.json", "--mutan_rank", "3"],
    "mutan_shared_qdrop": ["mutan_vqa_cp.json", "--mutan_rank", "3", "--mutan_shared_qdrop"],
}


@pytest.mark.parametrize("run", list(RUNS))
def test_entry_point_trains_and_evaluates_in_bf16(tmp_path, capsys, run):
    config, *flags = RUNS[run]
    argv = ["--config", os.path.join(REPO, "configs", config), *flags, *WIDTHS,
            "--output", str(tmp_path)]
    path = main(argv + ["--mode", "train", "--epochs", "1"])
    with open(tmp_path / "metrics.jsonl") as fh:
        last = [json.loads(line) for line in fh][-1]
    assert np.isfinite(last["train_loss"]) and np.isfinite(last["eval_loss"])
    score, loss = main(argv + ["--mode", "eval", "--checkpoint", path])
    assert loss == last["eval_loss"] and score == last["eval_score"]
