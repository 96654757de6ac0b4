"""The port's checkpoints and --resume (tf_vqa_regat_tpu_torch/train/
checkpoint.py, train/loop.py) on the CPU, case for case after the JAX
package's tests/test_checkpoint.py: resumed runs equal the uninterrupted run
(killed between steps, preempted mid-epoch by the fault hook, resumed at an
epoch boundary), async saves equal blocking ones, a write error is raised
again, step checkpoints are pruned, --keep_ckpts keeps the newest epochs,
the fallback skips temporary directories and a stale step meta, a changed
run signature is refused, and the SIGTERM watcher sets its flag and
restores the previous handler. Then the carry-across: a JAX train state
after 3 steps, loaded into the port by params.py, takes one more step in
each package.

Tolerances: resumed vs uninterrupted rtol 1e-6 / atol 1e-7 on parameters
and per-epoch metrics, as the JAX tests hold them (the port's CPU run is
deterministic, so they are in fact bit-equal). The carried state equals the
JAX state bit for bit. After one more step in each package (JAX at
impl="jnp", no Pallas call; dropout 0; lr 1e-3): the loss rel 1e-6, as
tests/test_torch_train.py holds it; the moments rtol 1e-6 with atol 1e-7 and
the parameters atol 1e-5, as tests/test_torch_train_step.py holds a step.
The two packages' gradients differ by up to ~1e-4 (that file's gradient
tolerance), and Adamax turns that into up to ~lr/100 on leaves whose
gradient is near zero, where mu/nu is a ratio of two rounding-sized numbers
(measured at lr 5e-3: 5.2e-5 on the parameters, 2e-8 on mu, 8.7e-8 on nu).
"""

import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.main import main
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.params import (
    flatten_tree,
    load_jax_arrays,
    load_state_arrays,
    state_tensors,
    train_state_arrays,
)
from tf_vqa_regat_tpu_torch.train import checkpoint as ckpt
from tf_vqa_regat_tpu_torch.train.loop import Preempted, _PreemptWatcher, run_training
from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
from tf_vqa_regat_tpu_torch.train.step import train_forward, train_step

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
V_DIM, NUM_ANS = 24, 7
TOL = dict(rtol=1e-6, atol=1e-7)


def _cfg(out, **kw):
    base = dict(
        num_hid=32, relation_dim=48, num_heads=4, nongt_dim=6, imp_pos_emb_dim=16,
        fusion="butd", relation_type="implicit", residual_connection=True, adaptive=True,
        num_rois=24, epochs=2, batch_size=16, print_freq=100, base_lr=5e-3,
        train_block=1, output=str(out) + "/",
    )
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def datasets():
    """Train: 64 questions, 4 steps of 16; val: 16 questions."""
    train = synthetic_dataset(num_images=8, num_questions=64, v_dim=V_DIM, num_ans=NUM_ANS)
    val = synthetic_dataset(num_images=4, num_questions=16, v_dim=V_DIM, num_ans=NUM_ANS,
                            seed=1, name="val")
    return train, val


def _train(cfg, datasets):
    train, val = datasets
    model = ReGAT(cfg, train.ntoken, V_DIM, NUM_ANS)
    model, best = run_training(cfg, train, val, model, CPU)
    return {k: v.clone() for k, v in model.state_dict().items()}, best


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        return {rec["epoch"]: rec for rec in map(json.loads, fh)}


def _assert_same_run(params_a, params_b, out_a, out_b, epochs=(0, 1)):
    for k in params_a:
        np.testing.assert_allclose(params_b[k].numpy(), params_a[k].numpy(), **TOL, err_msg=k)
    ma, mb = _metrics(out_a), _metrics(out_b)
    for epoch in epochs:
        for key in ("train_loss", "train_score", "eval_score", "eval_loss", "lr"):
            np.testing.assert_allclose(mb[epoch][key], ma[epoch][key], rtol=1e-6,
                                       err_msg=f"epoch {epoch} {key}")


def _model_and_opt(datasets, cfg=None):
    cfg = cfg or _cfg("unused")
    train, _ = datasets
    model = ReGAT(cfg, train.ntoken, V_DIM, NUM_ANS)
    opt = Adamax(model, trainable_mask(model, False),
                 make_lr_schedule(cfg.base_lr, 4, 0.75, 2), cfg.grad_clip)
    return model, opt


def _batches(datasets, cfg):
    train, _ = datasets
    store = DeviceStore(train, CPU)
    return [gather_batch(store, torch.from_numpy(idx).long(), cfg.resolved_num_rois())
            for idx in store.epoch_indices(0, cfg.batch_size, True, cfg.seed)]


def test_checkpoint_roundtrip_holds_params_moments_and_count(tmp_path, datasets):
    cfg = _cfg(tmp_path)
    model, opt = _model_and_opt(datasets)
    train_step(model, opt, _batches(datasets, cfg)[0], 0, cfg.seed)
    ckpt.save_checkpoint(cfg.output, state_tensors(model, opt), 0, 1.5, True)
    latest = ckpt.latest_checkpoint(cfg.output)
    assert latest.endswith("epoch_0000") and os.path.isfile(os.path.join(latest, "state.npz"))
    fresh, fresh_opt = _model_and_opt(datasets)
    load_state_arrays(fresh, fresh_opt, ckpt.restore_checkpoint(latest))
    for k, v in state_tensors(model, opt).items():
        assert torch.equal(state_tensors(fresh, fresh_opt)[k], v), k
    assert fresh_opt.count == 1 and ckpt.restore_meta_full(cfg.output)["best_score"] == 1.5
    # best/ holds the same state; load_params takes either directory's params
    best = ckpt.restore_checkpoint(os.path.join(tmp_path, "checkpoints", "best"))
    assert sorted(best) == sorted(ckpt.restore_checkpoint(latest))
    params = ckpt.load_params(latest)
    assert not any(k.startswith("opt/") for k in params)
    load_jax_arrays(fresh, params)


def test_kill_and_resume_reproduces_uninterrupted_steps(tmp_path, datasets):
    cfg = _cfg(tmp_path)
    batches = _batches(datasets, cfg)
    model, opt = _model_and_opt(datasets)
    full = [train_step(model, opt, b, opt.count, cfg.seed)["loss"].item() for b in batches]

    model, opt = _model_and_opt(datasets)
    for b in batches[:2]:
        train_step(model, opt, b, opt.count, cfg.seed)
    ckpt.save_checkpoint(cfg.output, state_tensors(model, opt), 0, 0.0, False)
    del model, opt
    model2, opt2 = _model_and_opt(datasets)
    load_state_arrays(model2, opt2, ckpt.restore_checkpoint(ckpt.latest_checkpoint(cfg.output)))
    resumed = [train_step(model2, opt2, b, opt2.count, cfg.seed)["loss"].item()
               for b in batches[2:]]
    np.testing.assert_allclose(resumed, full[2:], rtol=1e-6)


@pytest.fixture(scope="module")
def uninterrupted(datasets, tmp_path_factory):
    """Two epochs of 4 steps, no checkpoint read: (params, best, output)."""
    cfg = _cfg(tmp_path_factory.mktemp("a"))
    params, best = _train(cfg, datasets)
    return params, best, cfg.output


def test_mid_epoch_preempt_and_resume_reproduces_uninterrupted_run(
    tmp_path, datasets, uninterrupted, monkeypatch
):
    """Fault at global step 6 = epoch 1, step 2 of 4: a step checkpoint with
    the epoch's accumulators; the resumed run equals the uninterrupted one."""
    params_a, best_a, out_a = uninterrupted
    cfg = _cfg(tmp_path, resume=True)  # no checkpoint yet: a fresh start
    monkeypatch.setenv("REGAT_FAULT_PREEMPT_STEP", "6")
    with pytest.raises(Preempted):
        _train(cfg, datasets)
    meta = ckpt.restore_meta_full(cfg.output)
    assert meta["epoch"] == 1 and meta["step_in_epoch"] == 2 and "_step_" in meta["dir"]
    assert set(meta["acc"]) == {"score", "loss_sum", "n"} and meta["acc"]["n"] == 32.0
    assert meta["run"] == {"batch_size": 16, "seed": 42, "steps_per_epoch": 4, "order": 2,
                           "roi_buckets": [], "data_mode": "device", "dp": 1,
                           "train_block": 1}
    with open(os.path.join(cfg.output, "log.txt")) as fh:
        assert "[preempt] checkpoint saved at epoch 1 step 2; exiting" in fh.read()

    monkeypatch.delenv("REGAT_FAULT_PREEMPT_STEP")
    params_b, best_b = _train(cfg, datasets)
    assert best_b == best_a
    _assert_same_run(params_a, params_b, out_a, cfg.output)
    assert all(torch.equal(params_a[k], params_b[k]) for k in params_a)  # bit-equal here
    root = os.path.join(cfg.output, "checkpoints")
    assert not [d for d in os.listdir(root) if "_step_" in d]  # the epoch save pruned it
    assert ckpt.latest_checkpoint(cfg.output).endswith("epoch_0001")


def test_epoch_boundary_resume_reproduces_uninterrupted_run(tmp_path, datasets, uninterrupted):
    params_a, _, out_a = uninterrupted
    _train(_cfg(tmp_path, epochs=1), datasets)
    params_b, _ = _train(_cfg(tmp_path, epochs=2, resume=True), datasets)
    _assert_same_run(params_a, params_b, out_a, str(tmp_path) + "/")
    with open(os.path.join(tmp_path, "log.txt")) as fh:
        assert fh.read().count("[DEBUG] epoch 1, number of steps: 4") == 1


def test_main_exits_cleanly_on_preemption(tmp_path, monkeypatch, capsys):
    """`--mode train` prints the JAX message, returns, and writes no final
    file; the same command with --resume finishes the run."""
    argv = ["--config", os.path.join(os.path.dirname(__file__), "..", "configs", "butd_vqa.json"),
            "--num_hid", "32", "--relation_dim", "48", "--num_heads", "4", "--nongt_dim", "6",
            "--num_rois", "24", "--synthetic", "--synthetic_train_size", "32",
            "--synthetic_val_size", "16", "--batch_size", "16", "--epochs", "2",
            "--print_freq", "0", "--device", "cpu", "--output", str(tmp_path) + "/",
            "--mode", "train", "--no-async_checkpoint", "--keep_ckpts", "1",
            "--train_block", "1"]
    monkeypatch.setenv("REGAT_FAULT_PREEMPT_STEP", "3")
    assert main(argv) is None
    assert "preempted at epoch 1 step 1 — checkpoint saved; rerun the same command with " \
        "--resume" in capsys.readouterr().out
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    monkeypatch.delenv("REGAT_FAULT_PREEMPT_STEP")
    path = main(argv + ["--resume"])
    assert os.path.isfile(path) and path.endswith("implicit-butd-pretrained_model.npz")
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["best", "epoch_0001", "meta.json"]


def test_checkpoint_every_steps_saves_and_prunes(tmp_path, datasets, monkeypatch):
    saved = []
    real = ckpt.save_checkpoint

    def spy(output, state, epoch, *a, **kw):
        saved.append((epoch, kw.get("step_in_epoch")))
        return real(output, state, epoch, *a, **kw)

    monkeypatch.setattr(ckpt, "save_checkpoint", spy)
    cfg = _cfg(tmp_path, epochs=1, checkpoint_every_steps=2, print_freq=0)
    _train(cfg, datasets)
    # the step-4 save is left to the epoch save, which prunes the step-2 one
    assert saved == [(0, 2), (0, None)]
    root = os.path.join(cfg.output, "checkpoints")
    assert not [d for d in os.listdir(root) if "_step_" in d]
    meta = ckpt.restore_meta_full(cfg.output)
    assert meta["dir"] == "epoch_0000" and "step_in_epoch" not in meta


def test_async_checkpoint_equals_blocking(tmp_path, datasets):
    cfg_a = _cfg(tmp_path / "async", checkpoint_every_steps=3)
    assert cfg_a.async_checkpoint  # the default
    _train(cfg_a, datasets)
    cfg_b = _cfg(tmp_path / "block", checkpoint_every_steps=3, async_checkpoint=False)
    _train(cfg_b, datasets)
    for cfg in (cfg_a, cfg_b):
        assert sorted(os.listdir(os.path.join(cfg.output, "checkpoints"))) == [
            "best", "epoch_0000", "epoch_0001", "meta.json"]
    assert ckpt.restore_meta_full(cfg_a.output) == ckpt.restore_meta_full(cfg_b.output)
    ma, mb = _metrics(cfg_a.output), _metrics(cfg_b.output)
    for epoch in (0, 1):
        for key in ("train_loss", "train_score", "eval_score", "eval_loss", "lr"):
            assert ma[epoch][key] == mb[epoch][key], (epoch, key)
    for name in ("epoch_0000", "epoch_0001", "best"):
        a = ckpt.restore_checkpoint(os.path.join(cfg_a.output, "checkpoints", name))
        b = ckpt.restore_checkpoint(os.path.join(cfg_b.output, "checkpoints", name))
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a), name


def test_async_save_snapshots_before_returning(tmp_path):
    """The state changes in place right after an async save returns; the
    checkpoint holds the values at the call."""
    w = torch.arange(4.0)
    ckpt.save_checkpoint(str(tmp_path), {"w": w}, 0, 0.0, False, block=False)
    w.add_(100.0)
    ckpt.wait_pending()
    np.testing.assert_array_equal(
        ckpt.restore_checkpoint(ckpt.latest_checkpoint(str(tmp_path)))["w"], np.arange(4.0))


def _boom(*a, **k):
    raise OSError("disk full")


def test_wait_pending_reraises_write_errors(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt.np, "savez", _boom)
    ckpt.save_checkpoint(str(tmp_path), {"w": torch.zeros(2)}, 0, -1.0, False, block=False)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_pending()
    assert ckpt.wait_pending() == 0.0  # raised once, then nothing pending


def test_pending_joined_keeps_async_write_durable_across_exception(tmp_path, monkeypatch):
    out = str(tmp_path)
    with pytest.raises(FloatingPointError, match="primary"):
        with ckpt.pending_joined():
            ckpt.save_checkpoint(out, {"w": torch.ones(3)}, 0, 0.5, False, block=False)
            raise FloatingPointError("primary")
    latest = ckpt.latest_checkpoint(out)
    assert latest.endswith("epoch_0000") and ckpt.restore_meta_full(out) == {
        "epoch": 0, "best_score": 0.5, "dir": "epoch_0000"}
    np.testing.assert_array_equal(ckpt.restore_checkpoint(latest)["w"], np.ones(3))
    monkeypatch.setattr(ckpt.np, "savez", _boom)
    with pytest.raises(FloatingPointError, match="primary"):  # the first error wins
        with ckpt.pending_joined():
            ckpt.save_checkpoint(out, {"w": torch.ones(3)}, 1, 0.5, False, block=False)
            raise FloatingPointError("primary")
    with pytest.raises(OSError, match="disk full"):  # on the clean path it surfaces
        with ckpt.pending_joined():
            ckpt.save_checkpoint(out, {"w": torch.ones(3)}, 1, 0.5, False, block=False)


def test_save_reports_backpressure_wait(tmp_path, monkeypatch):
    import time

    real = ckpt._to_host

    def slow(state, event):
        time.sleep(1.5)
        return real(state, event)

    monkeypatch.setattr(ckpt, "_to_host", slow)
    out = str(tmp_path)
    assert ckpt.save_checkpoint(out, {"w": torch.zeros(2)}, 0, 0.0, False, block=False) == 0.0
    assert ckpt.save_checkpoint(out, {"w": torch.zeros(2)}, 1, 0.0, False, block=False) > 0.5
    ckpt.wait_pending()


def test_keep_ckpts_retention(tmp_path):
    out = str(tmp_path)
    w = torch.arange(4.0)
    for epoch in range(5):
        w = w + 1.0
        ckpt.save_checkpoint(out, {"w": w}, epoch, 2.0, epoch == 1, block=epoch % 2 == 0,
                             retain=2)
    ckpt.wait_pending()
    root = tmp_path / "checkpoints"
    assert sorted(d.name for d in root.iterdir() if d.is_dir()) == [
        "best", "epoch_0003", "epoch_0004"]
    latest = ckpt.latest_checkpoint(out)
    assert latest.endswith("epoch_0004")
    np.testing.assert_array_equal(ckpt.restore_checkpoint(latest)["w"], np.arange(4.0) + 5)
    np.testing.assert_array_equal(
        ckpt.restore_checkpoint(str(root / "best"))["w"], np.arange(4.0) + 2)


def test_keep_ckpts_never_deletes_fresh_save_over_stale_dirs(tmp_path):
    root = tmp_path / "checkpoints"
    root.mkdir()
    for stale in ["epoch_0009", "epoch_0010", "epoch_0003.tmp-7"]:
        (root / stale).mkdir()
    ckpt.save_checkpoint(str(tmp_path), {"w": torch.zeros(3)}, 0, 0.0, False, retain=2)
    assert sorted(d.name for d in root.iterdir() if d.is_dir()) == [
        "epoch_0000", "epoch_0003.tmp-7", "epoch_0009", "epoch_0010"]
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("epoch_0000")


def test_keep_ckpts_step_saves_do_not_consume_epoch_slots(tmp_path):
    state = {"w": torch.zeros(2)}
    ckpt.save_checkpoint(str(tmp_path), state, 0, 0.0, False, retain=1)
    ckpt.save_checkpoint(str(tmp_path), state, 1, 0.0, False, step_in_epoch=5, acc={},
                         retain=1)
    root = tmp_path / "checkpoints"
    assert sorted(d.name for d in root.iterdir() if d.is_dir()) == [
        "epoch_0000", "epoch_0001_step_00000005"]


def test_latest_checkpoint_fallback_ignores_tmp_dirs(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), {"w": torch.zeros(2)}, 2, 0.0, False)
    root = tmp_path / "checkpoints"
    (root / "epoch_0005.tmp-3").mkdir()
    (root / "meta.json").unlink()
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("epoch_0002")
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_resume_ignores_stale_step_meta(tmp_path, datasets, uninterrupted):
    """meta names a step checkpoint that is gone: the fallback epoch
    directory decides the epoch, and meta's skip and accumulators are
    ignored, so epoch 1 reruns in full."""
    _, _, out_a = uninterrupted
    _train(_cfg(tmp_path, epochs=1), datasets)
    meta_path = tmp_path / "checkpoints" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta.update(dir="epoch_0001_step_00000002", epoch=1, step_in_epoch=2,
                acc={"score": 999.0, "loss_sum": 999.0, "n": 32.0})
    meta_path.write_text(json.dumps(meta))
    _train(_cfg(tmp_path, epochs=2, resume=True), datasets)
    ma, mb = _metrics(out_a), _metrics(str(tmp_path) + "/")
    for key in ("train_loss", "train_score", "eval_score", "eval_loss"):
        np.testing.assert_allclose(mb[1][key], ma[1][key], rtol=1e-6, err_msg=key)


def test_mid_epoch_resume_refuses_changed_signature(tmp_path, datasets, monkeypatch):
    cfg = _cfg(tmp_path)
    monkeypatch.setenv("REGAT_FAULT_PREEMPT_STEP", "2")
    with pytest.raises(Preempted):
        _train(cfg, datasets)
    monkeypatch.delenv("REGAT_FAULT_PREEMPT_STEP")
    for change in (dict(batch_size=8), dict(seed=7777)):
        with pytest.raises(ValueError, match="mid-epoch resume"):
            _train(_cfg(tmp_path, resume=True, **change), datasets)
    meta_path = tmp_path / "checkpoints" / "meta.json"
    meta = json.loads(meta_path.read_text())
    for order in (None, 3):  # a writer without the key counts as version 1
        run = dict(meta["run"])
        if order is None:
            del run["order"]
        else:
            run["order"] = order
        meta_path.write_text(json.dumps(dict(meta, run=run)))
        with pytest.raises(ValueError, match="order"):
            _train(_cfg(tmp_path, resume=True), datasets)
    meta_path.write_text(json.dumps(meta))
    _, best = _train(_cfg(tmp_path, resume=True), datasets)  # the matching config resumes
    assert np.isfinite(best)


def test_epoch_boundary_resume_refuses_changed_steps_per_epoch(tmp_path, datasets):
    _train(_cfg(tmp_path, epochs=1), datasets)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        _train(_cfg(tmp_path, epochs=2, resume=True, batch_size=8), datasets)
    _train(_cfg(tmp_path, epochs=2, resume=True), datasets)
    assert 1 in _metrics(str(tmp_path) + "/")


def test_sigterm_watcher_flag_and_handler_restore():
    prev = signal.getsignal(signal.SIGTERM)
    with _PreemptWatcher() as w:
        assert not w.poll(1)
        os.kill(os.getpid(), signal.SIGTERM)
        assert w.poll(2)
    assert signal.getsignal(signal.SIGTERM) == prev


def test_optimizer_state_load_is_strict(datasets):
    model, opt = _model_and_opt(datasets)
    state = state_tensors(model, opt)
    flat = {k: v.numpy() for k, v in state.items()}
    key = next(k for k in flat if k.startswith("opt/mu/"))
    for fault in ("missing", "shape", "params only"):
        bad = dict(flat)
        if fault == "missing":
            del bad[key]
        elif fault == "shape":
            bad[key] = bad[key].reshape(-1)[:1]
        else:
            bad = {k: v for k, v in bad.items() if not k.startswith("opt/")}
        with pytest.raises(ValueError):
            load_state_arrays(*_model_and_opt(datasets), bad)


def test_jax_train_state_carries_across(datasets):
    """3 JAX steps, the state carried into the port, then one more step in
    each package on the same batch."""
    from tf_vqa_regat_tpu.config import Config as JaxConfig
    from tf_vqa_regat_tpu.models.regat import init_regat
    from tf_vqa_regat_tpu.models.regat import trainable_mask as jax_trainable_mask
    from tf_vqa_regat_tpu.parallel.mesh import make_mesh
    from tf_vqa_regat_tpu.train.optim import make_optimizer
    from tf_vqa_regat_tpu.train.step import build_train_step, init_train_state

    cfg = _cfg("unused", dropout=0.0, base_lr=1e-3)
    jcfg = JaxConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(Config)})
    train, _ = datasets
    batches = _batches(datasets, cfg)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    params = init_regat(jax.random.PRNGKey(0), jcfg, train.ntoken, V_DIM, NUM_ANS)
    opt = make_optimizer(cfg.base_lr, cfg.grad_clip, 4, 0.75, 2, jax_trainable_mask(params, False))
    state = init_train_state(params, opt, mesh)
    step = build_train_step(jcfg, train.ntoken, opt, mesh, "jnp", params)
    rng = jax.random.PRNGKey(cfg.seed + 1)

    def jax_batch(b):
        out = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
        out["question"] = out["question"].astype(jnp.int32)
        out["num_boxes"] = out["num_boxes"].astype(jnp.int32)
        return out

    for b in batches[:3]:
        state, _ = step(state, jax_batch(b), rng)
    carried = train_state_arrays(jax.device_get(state))
    assert int(carried["opt/count"]) == 3
    model, port_opt = _model_and_opt(datasets, cfg)
    load_state_arrays(model, port_opt, carried)
    assert port_opt.count == 3
    loaded = state_tensors(model, port_opt)
    assert sorted(loaded) == sorted(carried)
    for k, v in carried.items():
        assert np.array_equal(loaded[k].numpy(), v), k

    state, m = step(state, jax_batch(batches[3]), rng)
    got = train_step(model, port_opt, batches[3], port_opt.count, cfg.seed)
    assert got["loss"].item() == pytest.approx(float(m["loss"]), rel=1e-6)
    want = train_state_arrays(jax.device_get(state))
    ours = {k: v.numpy() for k, v in state_tensors(model, port_opt).items()}
    assert sorted(ours) == sorted(want) and int(ours["opt/count"]) == 4
    moved = 0.0
    for k, v in want.items():
        if k.startswith(("opt/mu/", "opt/nu/")):
            np.testing.assert_allclose(ours[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-5, err_msg=k)
            moved = max(moved, float(np.abs(v - carried[k]).max()))
    assert moved > 5e-4  # the step moved the parameters by far more than the tolerance
    assert flatten_tree(jax.device_get(state["params"])).keys() == {
        k for k in want if not k.startswith("opt/")}


def test_train_step_gradients_are_deterministic(datasets):
    """Two backward passes of one batch give the same bits: the word
    embedding's backward (F.embedding) sums each row in a fixed order, where
    advanced indexing's did not on the CPU, and a resume could not be exact."""
    cfg = _cfg("unused")
    model, _ = _model_and_opt(datasets)
    batch = _batches(datasets, cfg)[0]
    grads = []
    for _ in range(2):
        loss, _ = train_forward(model, batch, 0, cfg.seed)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    names = [n for n, _ in model.named_parameters()]
    assert [n for n, a, b in zip(names, *grads) if not torch.equal(a, b)] == []
