"""--train_block and --eval_block in the port (train/loop.py, the steps of
train/step.py through train/graphs.py, which run eagerly on the CPU)
against the JAX package, on the CPU:

(a) `_block_batches_counted` over a ragged three-R stream and
    `blocked_eval_stream` over a bucketed split equal JAX's, K = 1, 2, 3, 8;
(b) `resolve_train_block` per data mode and flag equals JAX's; an explicit
    K > 1 on the host path is refused with JAX's message; the parser takes
    both flags and refuses a negative one, as JAX's config does;
(c) the run signature records the effective K (JAX's `_run_signature`);
    a mid-epoch resume under another K is refused; a skip inside a block
    raises JAX's error, one on a block boundary skips whole blocks;
(d) one epoch of `--train_block 2 --roi_buckets 36,100 --eval_block 3`
    through `run_training` against JAX's `build_store_train_block` driven
    over JAX's blocked stream from the same parameters at `--dropout 0` (the
    two packages' dropout streams differ): the batch order block by block,
    the final parameters and Adamax state leaf for leaf, the train metrics;
    then the eval metrics against JAX's `build_store_eval_block` and the
    `eval data loader len` line, and `--mode predict`'s answers against
    JAX's `build_store_predict_block`, at `--eval_block 3`;
(e) without buckets, `--train_block 2` and 3 against `--train_block 1`:
    the same parameters bit for bit (dropout on);
(f) the step line, the step checkpoints and the preemption fall where a
    block crosses a multiple, at K = 3 against K = 1;
(g) Adamax's device-side count, learning rate and bias correction against
    optax across the warm-up, the decay start and one decay step; the
    state_dict round trip with an int count; a state.npz in the format of
    the earlier checkpoints (count a 0-d int64) loads into both counts.

Tolerances. (a)-(c), (e), (f): exact. (d): the parameters atol 1e-5 and the
Adamax moments rtol 1e-5 / atol 1e-7, the train and eval losses and scores
rtol 1e-6 (tests/test_torch_store_layouts.py holds a bucketed per-step run
so, tests/test_torch_checkpoint.py the moments after one step at rtol 1e-6
/ atol 1e-7; they follow the gradients, whose last bits differ between the
packages, over 6 steps here), the implicit relation's pos-FC leaves at
POS_ATOL and their moments at POS_LEAF_RTOL of the leaf's largest magnitude
(their comment says why); the predicted
answers exactly. (g): rtol 1e-6, as tests/test_torch_train.py holds the
optax chain.
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
from tf_vqa_regat_tpu.data.fixtures import synthetic_dataset as jax_synthetic_dataset
from tf_vqa_regat_tpu.models.regat import init_regat, resolve_impl
from tf_vqa_regat_tpu.models.regat import trainable_mask as jax_trainable_mask
from tf_vqa_regat_tpu.parallel.mesh import make_mesh
from tf_vqa_regat_tpu.train import loop as jloop
from tf_vqa_regat_tpu.train.optim import make_lr_schedule as jax_lr_schedule
from tf_vqa_regat_tpu.train.optim import make_optimizer
from tf_vqa_regat_tpu.train.step import (
    build_store_eval_block,
    build_store_predict_block,
    build_store_train_block,
    init_train_state,
)
from tf_vqa_regat_tpu_torch.config import Config, parse_with_config
from tf_vqa_regat_tpu_torch.data.store import DeviceStore
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.params import (
    flatten_tree,
    load_jax_arrays,
    load_state_arrays,
    state_tensors,
    train_state_arrays,
)
from tf_vqa_regat_tpu_torch.train import checkpoint as ckpt
from tf_vqa_regat_tpu_torch.train import loop
from tf_vqa_regat_tpu_torch.train.logging import Logger
from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
V_DIM, NUM_ANS = 24, 7
BUCKETS = "36,100"
# (d)'s implicit relation's pos-FC leaves: their gradients divide by the
# post-relu weights wherever those sit just above the 1e-6 floor of the log,
# which magnifies the last bits in which the two packages' forward passes
# differ (chip_smoke.py states the same for B1's dW_pos and db_pos, and
# holds them relative to the leaf's largest magnitude). Measured here after
# the 6 steps: parameters 5.7e-5 apart, moments 3e-3 of their leaf's largest
# (0.14 of a small element); every other leaf within the tolerances above.
POS_ATOL, POS_LEAF_RTOL = 2e-4, 2e-2


def _cfg(out, **kw):
    base = dict(
        num_hid=32, relation_dim=48, num_heads=4, nongt_dim=6, imp_pos_emb_dim=16,
        fusion="butd", relation_type="implicit", residual_connection=True, adaptive=True,
        epochs=1, batch_size=16, eval_batch=8, print_freq=100, base_lr=1e-3, dropout=0.0,
        save_every_epoch=False, data_mode="device", output=str(out) + "/",
    )
    base.update(kw)
    return Config(**base)


def _jax_cfg(cfg):
    return JaxConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(Config)},
                     use_pallas=True)


@pytest.fixture(scope="module")
def splits():
    kw = dict(v_dim=V_DIM, num_ans=NUM_ANS, adaptive=True)
    train = dict(num_images=16, num_questions=80, **kw)
    val = dict(num_images=8, num_questions=24, seed=1, name="val", **kw)
    return ((synthetic_dataset(**train), synthetic_dataset(**val)),
            (jax_synthetic_dataset(**train), jax_synthetic_dataset(**val)))


def _mesh():
    return make_mesh(1, 1, devices=jax.devices()[:1])


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def _log(out):
    with open(os.path.join(out, "log.txt")) as fh:
        return fh.read().splitlines()


def _run(cfg, train, val, init=None):
    model = ReGAT(cfg, train.ntoken, V_DIM, NUM_ANS)
    if init is not None:
        load_jax_arrays(model, init)
    loop.run_training(cfg, train, val, model, CPU)
    return {k: v.clone() for k, v in model.state_dict().items()}


# ------------------------------------------------------------------ (a)
def _ragged_stream():
    """Three R interleaved with 5, 1 and 3 batches of 4, some -1 slots."""
    rng = np.random.RandomState(3)
    rs = [36] * 5 + [64] + [100] * 3
    rng.shuffle(rs)
    out = []
    for R in rs:
        idx = rng.randint(0, 50, size=4).astype(np.int32)
        idx[rng.rand(4) < 0.2] = -1
        out.append((R, idx))
    return out


@pytest.mark.parametrize("K", [1, 2, 3, 8])
def test_block_batches_counted_equals_jax(K):
    stream = _ragged_stream()
    got = list(loop._block_batches_counted(iter(stream), K, 4))
    want = list(jloop._block_batches_counted(iter(stream), K, 4))
    assert len(got) == len(want)
    for (R, blk, n), (jR, jblk, jn) in zip(got, want):
        assert (R, n) == (jR, jn) and blk.dtype == jblk.dtype
        np.testing.assert_array_equal(blk, jblk)
    assert [b[0] for b in got] == [b[0] for b in loop._block_batches(iter(stream), K, 4)]


@pytest.mark.parametrize("K", [1, 2, 3, 8])
def test_blocked_eval_stream_equals_jax(splits, K):
    (_, val), (_, jval) = splits
    cfg = _cfg("unused", roi_buckets=BUCKETS, eval_block=K)
    jcfg = _jax_cfg(cfg)
    store = DeviceStore(val, CPU)
    jstore = jloop.build_store(jcfg, jval, _mesh(), "device")
    k, sizes, stream = loop.blocked_eval_stream(cfg, store, 8)
    jk, jsizes, _, jstream = jloop.blocked_eval_stream(jcfg, jstore, _mesh(), 8)
    assert (k, sizes) == (jk, jsizes)
    got, want = list(stream), list(jstream)
    assert len(got) == len(want) > 1
    for (R, blk), (jR, jblk) in zip(got, want):
        assert R == jR and blk.shape == (K, 8)
        np.testing.assert_array_equal(blk, jblk)


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("mode", ["device", "host"])
@pytest.mark.parametrize("train_block", [0, 1, 3])
def test_resolve_train_block_equals_jax(train_block, mode):
    cfg = _cfg("unused", train_block=train_block)
    want = jloop.resolve_train_block(_jax_cfg(cfg), mode)
    assert loop.resolve_train_block(cfg, mode) == want
    assert want == {0: 8 if mode == "device" else 1, 1: 1, 3: 3}[train_block]


def test_host_path_refuses_an_explicit_block_and_the_parser_takes_both(splits, tmp_path):
    (train, val), _ = splits
    log = Logger(str(tmp_path / "log.txt"))
    with pytest.raises(ValueError, match="--train_block requires the device or sharded "
                                         "data mode \\(resolved mode: 'host'\\)"):
        loop._DataPath(_cfg(tmp_path, data_mode="host", train_block=2), train, val, CPU, log)
    # auto resolves to one step per block there; eval-only use takes any K
    assert loop._DataPath(_cfg(tmp_path, data_mode="host"), train, val, CPU, log).train_block == 1
    loop._DataPath(_cfg(tmp_path, data_mode="host", train_block=2), None, val, CPU, log)
    log.close()
    cfg = parse_with_config(["--train_block", "4", "--eval_block", "2"])
    assert (cfg.train_block, cfg.eval_block) == (4, 2)
    defaults = parse_with_config([])
    assert (defaults.train_block, defaults.eval_block) == (JaxConfig().train_block,
                                                           JaxConfig().eval_block) == (0, 8)
    for flag in ("--train_block", "--eval_block"):
        with pytest.raises(ValueError, match="must be >= 0"):
            parse_with_config([flag, "-1"])


# ------------------------------------------------------------------ (c)
def test_signature_records_the_block_and_resume_refuses_another(splits, tmp_path, monkeypatch):
    """Two epochs of 6 bucketed steps in blocks of 2; the fault hook at
    global step 8 = epoch 1, step 2."""
    (train, val), _ = splits
    cfg = _cfg(tmp_path, epochs=2, roi_buckets=BUCKETS, train_block=2, resume=True,
               save_every_epoch=True)
    monkeypatch.setenv("REGAT_FAULT_PREEMPT_STEP", "8")
    with pytest.raises(loop.Preempted):
        _run(cfg, train, val)
    monkeypatch.delenv("REGAT_FAULT_PREEMPT_STEP")
    meta = ckpt.restore_meta_full(cfg.output)
    assert meta["epoch"] == 1 and meta["step_in_epoch"] == 2
    want = jloop._run_signature(_jax_cfg(cfg), 6, "device", 1)
    assert meta["run"] == want and want["train_block"] == 2
    with pytest.raises(ValueError, match="'train_block': \\(2, 3\\)"):
        _run(dataclasses.replace(cfg, train_block=3), train, val)


def test_a_skip_inside_a_block_raises(splits, tmp_path):
    (train, val), _ = splits
    log = Logger(str(tmp_path / "log.txt"))
    data = loop._DataPath(_cfg(tmp_path, train_block=2), train, val, CPU, log)
    log.close()
    full = list(data.train_stream(0))
    assert [n for n, _ in full] == [2, 2, 1]
    with pytest.raises(ValueError, match="mid-epoch resume at step 1 does not align with "
                                         "the --train_block 2 dispatch boundaries"):
        list(data.train_stream(0, 1))
    rest = list(data.train_stream(0, 2))
    assert len(rest) == 2
    for (n, (R, blk)), (m, (jR, jblk)) in zip(rest, full[1:]):
        assert (n, R) == (m, jR)
        np.testing.assert_array_equal(blk, jblk)


# ------------------------------------------------------------------ (d)
@pytest.fixture(scope="module")
def jax_blocked(splits):
    """JAX's blocked train epoch (K = 2, buckets 36,100), then its eval and
    predict blocks (K = 3) on the trained parameters."""
    (train, _), (jtrain, jval) = splits
    cfg = _cfg("unused", roi_buckets=BUCKETS, train_block=2, eval_block=3)
    jcfg, mesh = _jax_cfg(cfg), _mesh()
    buckets = cfg.parsed_roi_buckets()
    params = init_regat(jax.random.PRNGKey(0), jcfg, jtrain.ntoken, V_DIM, NUM_ANS)
    init = flatten_tree(jax.tree.map(np.array, params))
    store = jloop.build_store(jcfg, jtrain, mesh, "device")
    N = store.bucketed_steps_per_epoch(cfg.batch_size, buckets)
    opt = make_optimizer(cfg.base_lr, cfg.grad_clip, N, cfg.lr_decay_rate, cfg.lr_decay_step,
                         jax_trainable_mask(params, False))
    state = init_train_state(params, opt, mesh)
    impl = resolve_impl(jcfg)
    train_blocks = {R: build_store_train_block(jcfg.replace(num_rois=R), jtrain.ntoken, opt,
                                               mesh, impl, params, NUM_ANS, store.padding_idx, 2)
                    for R in buckets}
    rng = jax.random.PRNGKey(cfg.seed + 1)
    order, acc = [], {"loss_sum": 0.0, "score": 0.0, "n": 0.0}
    raw = store.epoch_indices_bucketed(0, cfg.batch_size, buckets, True, cfg.seed)
    for R, blk, nreal in jloop._block_batches_counted(raw, 2, cfg.batch_size):
        state, m = train_blocks[R](state, store.arrays, jnp.asarray(blk), rng)
        order.append((nreal, R, blk))
        for k in acc:
            acc[k] += float(m[k])
    final = train_state_arrays(jax.device_get(state))
    vstore = jloop.build_store(jcfg, jval, mesh, "device")
    K, sizes, _, stream = jloop.blocked_eval_stream(jcfg, vstore, mesh, 8)
    ev = {R: build_store_eval_block(jcfg.replace(num_rois=R), jval.ntoken, mesh, impl,
                                    NUM_ANS, vstore.padding_idx, K) for R in sizes}
    pr = {R: build_store_predict_block(jcfg.replace(num_rois=R), jval.ntoken, mesh, impl,
                                       NUM_ANS, vstore.padding_idx, K) for R in sizes}
    eacc = {"loss_sum": 0.0, "score": 0.0, "n": 0.0}
    answers, nblocks = {}, 0
    for R, blk in stream:
        m = ev[R](state["params"], vstore.arrays, jnp.asarray(blk))
        eacc["loss_sum"] += float(m["loss"]) * float(m["n"])
        eacc["score"] += float(m["score"])
        eacc["n"] += float(m["n"])
        labels = np.asarray(pr[R](state["params"], vstore.arrays, jnp.asarray(blk)))
        ok = blk >= 0
        answers.update(zip(blk[ok].tolist(), labels[ok].tolist()))
        nblocks += 1
    return dict(init=init, final=final, order=order, train=acc, eval=eacc,
                answers=answers, eval_blocks=nblocks, steps=N)


def test_blocked_epoch_equals_jax_train_block(splits, jax_blocked, tmp_path):
    (train, val), (_, jval) = splits
    cfg = _cfg(tmp_path / "port", roi_buckets=BUCKETS, train_block=2, eval_block=3,
               save_every_epoch=True)
    # the batch order, block by block
    log = Logger(str(tmp_path / "order.txt"))
    data = loop._DataPath(cfg, train, val, CPU, log)
    log.close()
    got = list(data.train_stream(0))
    assert data.steps_per_epoch == jax_blocked["steps"] and len(got) == len(jax_blocked["order"])
    assert len({R for _, (R, _) in got}) == 2 and sorted(n for n, _ in got) != [2] * len(got)
    for (n, (R, blk)), (jn, jR, jblk) in zip(got, jax_blocked["order"]):
        assert (n, R) == (jn, jR)
        np.testing.assert_array_equal(blk, jblk)

    init = jax_blocked["init"]
    _run(cfg, train, val, init)
    state = ckpt.restore_checkpoint(ckpt.latest_checkpoint(cfg.output))
    want = jax_blocked["final"]
    assert sorted(state) == sorted(want) and int(state["opt/count"]) == jax_blocked["steps"]
    for k, v in want.items():
        if "pair_pos_fc" in k:  # behind log(max(relu(x), 1e-6)): POS_* above
            bound = POS_ATOL if k.startswith("v_") else POS_LEAF_RTOL * np.abs(v).max()
            assert np.abs(state[k] - v).max() <= bound, k
        elif k.startswith(("opt/mu/", "opt/nu/")):
            np.testing.assert_allclose(state[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        elif k != "opt/count":
            np.testing.assert_allclose(state[k], v, rtol=0, atol=1e-5, err_msg=k)
    assert max(float(np.abs(want[k] - init[k]).max()) for k in init) > 1e-3
    (m,) = _metrics(cfg.output)
    tr, ev = jax_blocked["train"], jax_blocked["eval"]
    np.testing.assert_allclose(m["train_loss"], tr["loss_sum"] / tr["n"], rtol=1e-6)
    np.testing.assert_allclose(m["train_score"], 100 * tr["score"] / tr["n"], rtol=1e-6)
    np.testing.assert_allclose(m["eval_loss"], ev["loss_sum"] / ev["n"], rtol=1e-6)
    np.testing.assert_allclose(m["eval_score"], 100 * ev["score"] / ev["n"], rtol=1e-6)
    assert f"[DEBUG] eval data loader len: {jax_blocked['eval_blocks']}" in _log(cfg.output)

    # --mode predict on the trained parameters, blocks of 3
    model = ReGAT(cfg, train.ntoken, V_DIM, NUM_ANS)
    load_jax_arrays(model, {k: v for k, v in state.items() if not k.startswith("opt/")})
    log = Logger(str(tmp_path / "predict.txt"))
    path = loop.run_prediction(cfg, val, model, CPU, log)
    log.close()
    with open(path) as fh:
        got = {e["question_id"]: e["answer"] for e in json.load(fh)}
    qids = val.entries.question_ids
    answers = jax_blocked["answers"]
    assert len(got) == len(qids) == len(answers)
    assert got == {int(qids[i]): jval.label2ans[a] for i, a in answers.items()}


# ------------------------------------------------------------------ (e)
@pytest.fixture(scope="module")
def per_step(splits, tmp_path_factory):
    (train, val), _ = splits
    cfg = _cfg(tmp_path_factory.mktemp("k1"), epochs=2, train_block=1, dropout=0.2,
               base_lr=5e-3)
    return cfg, _run(cfg, train, val)


@pytest.mark.parametrize("K", [2, 3])
def test_blocked_run_equals_per_step_without_buckets(splits, per_step, tmp_path, K):
    (train, val), _ = splits
    cfg1, want = per_step
    cfg = dataclasses.replace(cfg1, train_block=K, output=str(tmp_path) + "/")
    got = _run(cfg, train, val)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(_metrics(cfg.output), _metrics(cfg1.output)):
        for key in ("train_loss", "train_score", "eval_loss", "eval_score", "lr"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-6, err_msg=key)


# ------------------------------------------------------------------ (f)
@pytest.mark.parametrize("K,printed,saved,preempted", [
    (1, [1, 3], [2, 4], 2),
    (3, [2, 4], [3], 3),
])
def test_print_checkpoint_and_preempt_fall_on_block_boundaries(
        splits, tmp_path, monkeypatch, K, printed, saved, preempted):
    """5 steps: --print_freq 2 and --checkpoint_every_steps 2 fire where
    `done` crosses a multiple of 2; the fault hook at step 2 fires at the
    first boundary at or after it (JAX loop.py:433-470)."""
    (train, val), _ = splits
    saves = []
    real = ckpt.save_checkpoint

    def spy(*a, **kw):
        saves.append(kw.get("step_in_epoch"))
        return real(*a, **kw)

    monkeypatch.setattr(ckpt, "save_checkpoint", spy)
    cfg = _cfg(tmp_path / "a", train_block=K, print_freq=2, checkpoint_every_steps=2)
    _run(cfg, train, val)
    lines = _log(cfg.output)
    train_lines = lines[:lines.index("[DEBUG] Evaluation Start")]
    assert [int(ln.split("][")[1].split("/")[0]) for ln in train_lines
            if ln.startswith("Epoch [1][")] == printed
    assert saves == saved
    saves.clear()
    monkeypatch.setenv("REGAT_FAULT_PREEMPT_STEP", "2")
    cfg = _cfg(tmp_path / "b", train_block=K)
    with pytest.raises(loop.Preempted, match=f"epoch 0 step {preempted}"):
        _run(cfg, train, val)
    assert saves == [preempted]
    assert ckpt.restore_meta_full(cfg.output)["step_in_epoch"] == preempted


# ------------------------------------------------------------------ (g)
class _Three(torch.nn.Module):
    def __init__(self, shapes):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, torch.nn.Parameter(torch.zeros(shape)))


SHAPES = {"a": (5, 3), "b": (7,), "frozen": (4, 2)}
MASK = {"a": True, "b": True, "frozen": False}


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(rng):
    return {k: (rng.randn(*s) * (0.01 if k == "b" else 1.0)).astype(np.float32)
            for k, s in SHAPES.items()}


def test_adamax_device_count_follows_optax_across_the_schedule():
    """One step per epoch for 8 epochs at --lr_decay_step 2: the warm-up
    (epochs 0-4), the decay start (5) and one decay step (7)."""
    params = _params()
    opt = make_optimizer(1e-2, 0.25, 1, 0.5, 2, MASK)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jparams)
    model = _Three(SHAPES)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    schedule = make_lr_schedule(1e-2, 1, 0.5, 2)
    port = Adamax(model, MASK, schedule, 0.25)
    ref = jax_lr_schedule(1e-2, 1, 0.5, 2)
    rng = np.random.RandomState(1)
    for s in range(8):
        lr = schedule.at(port.count_t, port._factors)
        np.testing.assert_allclose(float(lr), float(ref(jnp.asarray(s))), rtol=1e-6)
        assert float(lr) == pytest.approx(schedule(s), rel=1e-6)
        g = _grads(rng)
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        port.step([torch.from_numpy(g[n]) for n in port.names])
        adam = state[1][0]
        assert port.count == int(port.count_t) == int(adam.count) == s + 1
        for i, n in enumerate(port.names):
            np.testing.assert_allclose(port.params[i].detach().numpy(), jparams[n], rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {s} {n}")
            np.testing.assert_allclose(port.mu[i].numpy(), adam.mu[n], rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(port.nu[i].numpy(), adam.nu[n], rtol=1e-6)
    assert float(schedule.at(torch.tensor(7), port._factors)) == pytest.approx(1.4e-2 * 0.25)
    np.testing.assert_array_equal(model.frozen.detach().numpy(), params["frozen"])


def test_adamax_state_round_trip_and_an_earlier_state_npz(tmp_path):
    """state_dict writes an int count; a flat state saved as earlier
    checkpoints saved it (count a 0-d int64 array) loads into both counts,
    and the next step equals the saving optimizer's."""
    rng = np.random.RandomState(2)
    model = _Three(SHAPES)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in _params(3).items()})
    opt = Adamax(model, MASK, make_lr_schedule(1e-2, 2, 0.5, 2), 0.25)
    for _ in range(3):
        opt.step([torch.from_numpy(g) for g in _grads(rng).values()])
    st = opt.state_dict()
    assert type(st["count"]) is int and st["count"] == 3
    flat = {k: v.numpy() for k, v in state_tensors(model, opt).items()}
    assert flat["opt/count"].dtype == np.int64 and flat["opt/count"].shape == ()
    path = str(tmp_path / "state.npz")
    np.savez(path, **flat)
    model2 = _Three(SHAPES)
    opt2 = Adamax(model2, MASK, make_lr_schedule(1e-2, 2, 0.5, 2), 0.25)
    with np.load(path) as z:
        load_state_arrays(model2, opt2, {k: z[k] for k in z.files})
    assert opt2.count == int(opt2.count_t) == 3
    g = [torch.from_numpy(v) for v in _grads(rng).values()]
    opt.step(g)
    opt2.step(g)
    for a, b in zip(opt.params + opt.mu + opt.nu, opt2.params + opt2.mu + opt2.nu):
        assert torch.equal(a, b)
    assert opt2.count == int(opt2.count_t) == 4
    # snapshot/restore leaves the tensors where they were, with their values
    ptrs = [t.data_ptr() for t in opt2.params + opt2.mu + [opt2.count_t]]
    before = [t.clone() for t in opt2.params + opt2.mu]
    restore = opt2.snapshot()
    opt2.step(g)
    restore()
    assert opt2.count == int(opt2.count_t) == 4
    assert ptrs == [t.data_ptr() for t in opt2.params + opt2.mu + [opt2.count_t]]
    assert all(torch.equal(a, b) for a, b in zip(before, opt2.params + opt2.mu))
