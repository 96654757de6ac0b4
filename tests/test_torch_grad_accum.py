"""`--grad_accum` in the port (train/step.py, train/loop.py) on the CPU,
after the JAX package's tests/test_train.py::test_grad_accum_matches_single_pass
and test_grad_accum_divisibility_validated:

- BUTD at small widths, dropout 0, 48 questions at batch 32 (the second
  batch half padded), two epochs: the port's k = 2 and 4 against its k = 1,
  and the port at k = 1, 2, 4 against the JAX `build_train_step` at the
  same k (one-device mesh, impl="jnp"; the port has the semantics of JAX's
  Pallas path, and the two agree on these inputs);
- the strided split: microbatch a holds rows a, a+k, a+2k, ... and the
  model sees exactly those;
- with dropout on: each microbatch draws from its own generator, a
  function of (seed, step, a) only, no two (step, a) share one, and k = 1
  keeps the generator (and so the masks) of the single-pass step;
- a batch size that k does not divide is refused with JAX's message;
- B1's plain version runs twice per microbatch, 2 k times per step;
- a run at --grad_accum 2 with dropout on, preempted mid-epoch and resumed,
  equals the uninterrupted run bit for bit.

Tolerances: parameters after the four steps atol 1e-5 and per-step losses
rel 1e-4, as test_torch_train_step.py holds its five-step trajectory
(gradients summed over microbatches in another order; Adamax moves a leaf
by at most lr 1e-3 a step).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.config import Config as JaxConfig
from tf_vqa_regat_tpu.models.regat import init_regat
from tf_vqa_regat_tpu.models.regat import trainable_mask as jax_trainable_mask
from tf_vqa_regat_tpu.parallel.mesh import make_mesh
from tf_vqa_regat_tpu.train.loop import run_training as jax_run_training
from tf_vqa_regat_tpu.train.optim import make_optimizer
from tf_vqa_regat_tpu.train.step import build_train_step, init_train_state
from tf_vqa_regat_tpu_torch import nn as tnn
from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as b1
from tf_vqa_regat_tpu_torch.params import flatten_tree, load_jax_arrays
from tf_vqa_regat_tpu_torch.train import step as tstep
from tf_vqa_regat_tpu_torch.train.loop import Preempted, run_training
from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
V_DIM, NUM_ANS, R = 32, 9, 12
CFG = JaxConfig(
    num_hid=32, relation_dim=48, num_heads=4, nongt_dim=6, imp_pos_emb_dim=16,
    fusion="butd", relation_type="implicit", adaptive=True, num_rois=R,
    residual_connection=True, base_lr=1e-3, dropout=0.0, batch_size=32,
)
STEPS = 4  # two epochs of two batches


def _port_cfg(cfg):
    return Config(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(Config)})


@pytest.fixture(scope="module")
def setup():
    """(ntoken, the two batches of 32 in entry order, the JAX init as flat
    numpy arrays)."""
    ds = synthetic_dataset(num_images=8, num_questions=48, v_dim=V_DIM, num_ans=NUM_ANS)
    store = DeviceStore(ds, CPU)
    batches = [gather_batch(store, torch.from_numpy(idx).long(), R)
               for idx in store.epoch_indices(0, CFG.batch_size, False, CFG.seed)]
    assert [int(b["valid"].sum()) for b in batches] == [32, 16]
    params = init_regat(jax.random.PRNGKey(0), CFG, ds.ntoken, V_DIM, NUM_ANS)
    return ds.ntoken, batches, flatten_tree(jax.tree.map(np.asarray, params))


def _schedule(cfg):
    return make_lr_schedule(cfg.base_lr, 2, cfg.lr_decay_rate, cfg.lr_decay_step)


def _port_run(setup, k):
    ntoken, batches, flat = setup
    cfg = _port_cfg(CFG.replace(grad_accum=k))
    model = ReGAT(cfg, ntoken, V_DIM, NUM_ANS)
    load_jax_arrays(model, flat)
    opt = Adamax(model, trainable_mask(model, False), _schedule(cfg), cfg.grad_clip)
    metrics = [tstep.train_step(model, opt, batches[i % 2], i, cfg.seed, k)
               for i in range(STEPS)]
    params = {n.replace(".", "/"): p.detach().numpy() for n, p in model.named_parameters()}
    return params, [{key: float(v) for key, v in m.items()} for m in metrics]


@pytest.fixture(scope="module")
def single_pass(setup):
    return _port_run(setup, 1)


def _jax_run(setup, k):
    ntoken, batches, flat = setup
    cfg = CFG.replace(grad_accum=k)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    params = init_regat(jax.random.PRNGKey(0), cfg, ntoken, V_DIM, NUM_ANS)
    opt = make_optimizer(cfg.base_lr, cfg.grad_clip, 2, cfg.lr_decay_rate,
                         cfg.lr_decay_step, jax_trainable_mask(params, False))
    state = init_train_state(params, opt, mesh)
    step = build_train_step(cfg, ntoken, opt, mesh, "jnp", params)
    rng = jax.random.PRNGKey(cfg.seed + 1)
    metrics = []
    for i in range(STEPS):
        jb = {key: jnp.asarray(v.numpy()) for key, v in batches[i % 2].items()}
        jb["question"] = jb["question"].astype(jnp.int32)
        jb["num_boxes"] = jb["num_boxes"].astype(jnp.int32)
        state, m = step(state, jb, rng)
        metrics.append({key: float(v) for key, v in m.items()})
    return flatten_tree(jax.tree.map(np.asarray, state["params"])), metrics


def _assert_same(got, want, flat):
    (params, metrics), (want_params, want_metrics) = got, want
    for a, b in zip(metrics, want_metrics):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["n"] == b["n"] and a["score"] == pytest.approx(b["score"], rel=1e-4)
    moved = 0.0
    for key, w in want_params.items():
        np.testing.assert_allclose(params[key], w, atol=1e-5, rtol=0, err_msg=key)
        moved = max(moved, float(np.abs(w - flat[key]).max()))
    assert moved > 1e-3  # the parameters did move


@pytest.mark.parametrize("k", [2, 4])
def test_accumulation_equals_the_single_pass_step(setup, single_pass, k):
    _assert_same(_port_run(setup, k), single_pass, setup[2])
    assert [m["n"] for m in single_pass[1]] == [32.0, 16.0] * 2


@pytest.mark.parametrize("k", [1, 2, 4])
def test_accumulation_equals_jax_build_train_step(setup, single_pass, k):
    got = single_pass if k == 1 else _port_run(setup, k)
    _assert_same(got, _jax_run(setup, k), setup[2])


def test_microbatches_are_strided(setup, monkeypatch):
    ntoken, batches, flat = setup
    batch = batches[1]  # rows 16-31 padded
    k = 4
    for a in range(k):
        mb = tstep.microbatch(batch, a, k)
        assert mb.keys() == batch.keys()
        for key, v in mb.items():
            assert torch.equal(v, batch[key][a::k]) and v.is_contiguous(), key
        assert int(mb["valid"].sum()) == 4  # the padded rows spread over all four
    seen = []
    real = tstep.train_forward

    def spy(model, mb, step, seed, microbatch=0, generator=None):
        seen.append((microbatch, mb["question"].clone()))
        return real(model, mb, step, seed, microbatch, generator)

    monkeypatch.setattr(tstep, "train_forward", spy)
    model = ReGAT(_port_cfg(CFG), ntoken, V_DIM, NUM_ANS)
    opt = Adamax(model, trainable_mask(model, False), _schedule(CFG), CFG.grad_clip)
    tstep.train_step(model, opt, batch, 0, CFG.seed, k)
    assert [a for a, _ in seen] == list(range(k))
    for a, q in seen:
        assert torch.equal(q, batch["question"][a::k])


def test_microbatch_generators(setup, monkeypatch):
    """Distinct across microbatches, a function of (seed, step, a) only,
    never shared by two (step, a); microbatch 0 is the single-pass step's."""
    seed = CFG.seed + 1
    seeds = [tnn.step_generator(seed, step, CPU, a).initial_seed()
             for step in range(4096) for a in range(64)]
    assert len(set(seeds)) == len(seeds)
    # the CPU's generator keeps the lower 32 bits of the seed
    assert len({s & 0xFFFFFFFF for s in seeds}) == len(seeds)
    for step in (0, 7, 2**31 + 5):
        # the single-pass step's generator: (seed, step) in the two halves
        assert tnn.step_generator(seed, step, CPU).initial_seed() == (seed << 32) | step
        assert tnn.step_generator(seed, step, CPU, 0).initial_seed() == (seed << 32) | step
    ntoken, batches, _ = setup
    cfg = _port_cfg(CFG.replace(dropout=0.2))
    model = ReGAT(cfg, ntoken, V_DIM, NUM_ANS)
    masks = []
    real = tnn.dropout_draw

    def recorder(shape, rate, generator, device):
        bits, t = real(shape, rate, generator, device)
        masks.append(bits >= t)
        return bits, t

    # every draw, B1's keep-mask's included, goes through nn.dropout_draw
    monkeypatch.setattr(tnn, "dropout_draw", recorder)

    def draws(step, a):
        masks.clear()
        loss, _ = tstep.train_forward(model, tstep.microbatch(batches[0], a, 2), step,
                                      cfg.seed, a)
        return [m.clone() for m in masks], loss.item()

    first, loss = draws(3, 1)
    again, loss_again = draws(3, 1)
    assert len(first) > 5 and all(torch.equal(x, y) for x, y in zip(first, again))
    assert loss_again == loss
    other, _ = draws(3, 0)
    assert not all(torch.equal(x, y) for x, y in zip(first, other))
    # k = 1 draws the masks of the single-pass step
    masks.clear()
    tstep.train_forward(model, batches[0], 3, cfg.seed)
    single = [m.clone() for m in masks]
    masks.clear()
    model(batches[0], tnn.step_generator(cfg.seed + 1, 3, CPU))
    assert len(single) == len(masks) and all(torch.equal(x, y) for x, y in zip(single, masks))


def test_indivisible_batch_is_refused_with_jax_message(setup):
    """JAX's check on its 8-device CPU mesh names dp = 8; the port's dp is 1."""
    ntoken, _, _ = setup
    jcfg = CFG.replace(batch_size=32, grad_accum=3)
    with pytest.raises(ValueError) as want:
        jax_run_training(jcfg, None, None)
    cfg = _port_cfg(jcfg)
    with pytest.raises(ValueError) as got:
        run_training(cfg, None, None, ReGAT(cfg, ntoken, V_DIM, NUM_ANS), CPU)
    assert "grad_accum*dp = 3*8" in str(want.value)
    assert str(got.value) == str(want.value).replace("3*8", "3*1")


@pytest.mark.parametrize("k", [1, 2, 4])
def test_b1_plain_version_runs_twice_per_microbatch(setup, monkeypatch, k):
    ntoken, batches, _ = setup
    calls = []
    real = b1.implicit_attention_plain
    monkeypatch.setattr(b1, "implicit_attention_plain",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    cfg = _port_cfg(CFG)
    model = ReGAT(cfg, ntoken, V_DIM, NUM_ANS)
    opt = Adamax(model, trainable_mask(model, False), _schedule(cfg), cfg.grad_clip)
    tstep.train_step(model, opt, batches[0], 0, cfg.seed, k)
    assert calls == [{"save_pwr": True}] * (2 * k)


def _run_cfg(out, **kw):
    return Config(
        num_hid=32, relation_dim=48, num_heads=4, nongt_dim=6, imp_pos_emb_dim=16,
        fusion="butd", relation_type="implicit", residual_connection=True, adaptive=True,
        num_rois=R, epochs=2, batch_size=16, print_freq=100, base_lr=5e-3, dropout=0.2,
        grad_accum=2, output=str(out) + "/", **kw,
    )


def test_preempted_and_resumed_run_equals_uninterrupted(tmp_path, monkeypatch):
    train = synthetic_dataset(num_images=8, num_questions=64, v_dim=V_DIM, num_ans=NUM_ANS)
    val = synthetic_dataset(num_images=4, num_questions=16, v_dim=V_DIM, num_ans=NUM_ANS,
                            seed=1, name="val")

    def run(cfg):
        model = ReGAT(cfg, train.ntoken, V_DIM, NUM_ANS)
        model, _ = run_training(cfg, train, val, model, CPU)
        return {k: v.clone() for k, v in model.state_dict().items()}

    full = run(_run_cfg(tmp_path / "a"))
    cfg = _run_cfg(tmp_path / "b", resume=True, checkpoint_every_steps=2)
    monkeypatch.setenv("REGAT_FAULT_PREEMPT_STEP", "6")  # epoch 1, step 2 of 4
    with pytest.raises(Preempted):
        run(cfg)
    monkeypatch.delenv("REGAT_FAULT_PREEMPT_STEP")
    resumed = run(cfg)
    assert all(torch.equal(full[k], resumed[k]) for k in full)
    metrics = [[json.loads(line) for line in open(os.path.join(d, "metrics.jsonl"))]
               for d in (tmp_path / "a", tmp_path / "b")]
    assert metrics[0][-1]["train_loss"] == metrics[1][-1]["train_loss"]
