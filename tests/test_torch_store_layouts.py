"""The port's data layouts and roi buckets against the JAX package, on the
CPU:

(a) the synthetic fixed-36 split (`synthetic_dataset(adaptive=False)`)
    equals the JAX fixture's array for array, semantic table included;
(b) for f32, bf16 and int8 feature tables, adaptive and fixed-36, the
    port's `gather_batch` equals JAX's `device_store.gather_batch` over its
    `build_arrays` bit for bit: features (widened, zeroed past the box
    count, int8 dequantized), boxes, questions, targets, padded slots and
    the semantic `adj_label`; `quantize_rows` equals JAX's;
(c) `epoch_indices_bucketed` yields JAX's (R, idx) sequence exactly for
    epochs 0-2, shuffled and not, with images over the largest bucket
    clamped to it; the per-bucket counts and the steps per epoch are
    equal;
(d) a tiny-width training run of one epoch under `--roi_buckets 36,64,100`,
    and one on the fixed-36 layout with int8 tables, against JAX's
    `run_training` under `--train_block 1 --use_pallas --data_mode device`
    from the same initial parameters at `--dropout 0` (the two packages'
    dropout streams differ);
(e) a run preempted mid-epoch under roi buckets and resumed equals the
    uninterrupted run;
and configs/butd_vqa_fixed36.json through the entry point (train, eval,
predict, serve) with int8 tables.

Tolerances. (b), (c): exact. (d): the per-epoch train and eval losses rel
1e-6, as tests/test_torch_train.py holds a loss, and the final parameters
atol 1e-5, as tests/test_torch_checkpoint.py holds the parameters after a
step taken in each package; measured here, on the CPU: the losses at most
1.4e-7 apart (relative), the parameters at most 6.9e-6 after 6 bucketed
steps (5 fixed-36 steps) at lr 1e-3. (e): rtol 1e-6
/ atol 1e-7, the resume tolerance of tests/test_torch_checkpoint.py (the
CPU run is deterministic, so they are in fact bit-equal).
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
from tf_vqa_regat_tpu.data import device_store as jds
from tf_vqa_regat_tpu.data.fixtures import synthetic_dataset as jax_synthetic_dataset
from tf_vqa_regat_tpu.data.ordering import batch_shuffle_rng as jax_batch_shuffle_rng
from tf_vqa_regat_tpu.models.regat import init_regat
from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.ordering import batch_shuffle_rng
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch, quantize_rows
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.params import flatten_tree, load_jax_arrays, to_jax_arrays
from tf_vqa_regat_tpu_torch.train import checkpoint as ckpt
from tf_vqa_regat_tpu_torch.train.loop import Preempted, run_training

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
V_DIM, NUM_ANS = 24, 7
FEATURE_DTYPES = ("float32", "bfloat16", "int8")


def _pair(adaptive, semantic=False, **kw):
    """(port split, JAX split) of one seed."""
    base = dict(num_images=9, num_questions=37, v_dim=V_DIM, num_ans=NUM_ANS, seed=6)
    base.update(kw)
    return (synthetic_dataset(adaptive=adaptive, semantic=semantic, **base),
            jax_synthetic_dataset(adaptive=adaptive, semantic=semantic, **base))


@pytest.mark.parametrize("semantic", [False, True])
def test_fixed36_split_equals_the_jax_fixture(semantic):
    ours, ref = _pair(False, semantic)
    assert ours.store.features.shape == (9, 36, V_DIM) and ours.store.pos_boxes is None
    assert not ours.store.adaptive and not ref.store.adaptive
    for a, b in [(ours.store.features, ref.store.features),
                 (ours.store.normalized_bb, ref.store.normalized_bb), (ours.store.bb, ref.store.bb)]:
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if semantic:
        np.testing.assert_array_equal(ours.store.semantic_adj, ref.store.semantic_adj)
    for field in [f.name for f in dataclasses.fields(ours.entries)]:
        a, b = np.asarray(getattr(ours.entries, field)), np.asarray(getattr(ref.entries, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_quantize_rows_equals_jax():
    rng = np.random.RandomState(0)
    chunk = (rng.randn(50, 33) * rng.rand(50, 1) * 4).astype(np.float32)
    chunk[3] = 0.0  # an all-zero row: the 1e-12 floor
    q, s = quantize_rows(chunk)
    jq, js = jds.quantize_rows(chunk)
    assert q.dtype == jq.dtype == np.int8 and s.dtype == js.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)


@pytest.mark.parametrize("feature_dtype", FEATURE_DTYPES)
@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "fixed36"])
def test_gather_batch_equals_jax_bit_for_bit(adaptive, feature_dtype):
    ours, ref = _pair(adaptive, semantic=True)
    port = DeviceStore(ours, CPU, feature_dtype=feature_dtype)
    jstore = jds.DeviceStore(ref, include_adj=True, feature_dtype=feature_dtype)
    assert port.images.features.dtype == {
        "float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[feature_dtype]
    assert (port.images.feat_scale is not None) == (feature_dtype == "int8")
    np.testing.assert_array_equal(port.entry_nbox, jstore.entry_nbox)
    want_tab = np.asarray(jstore.arrays["features"]).astype(np.float32)
    np.testing.assert_array_equal(port.images.features.float().numpy(), want_tab)
    idx = list(port.epoch_indices(1, 16, True, seed=7))[-1]  # 11 padded slots
    assert (idx < 0).sum() == 11
    for num_rois in (24, 36, 100):
        got = gather_batch(port, torch.from_numpy(idx).long(), num_rois)
        want = jds.gather_batch(jstore.arrays, jnp.asarray(idx), num_rois, NUM_ANS,
                                ref.padding_idx)
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            g = got[k].numpy()
            assert g.shape == w.shape, k
            if w.dtype == np.float32:  # bit for bit, the signs of zeros too
                assert g.dtype == np.float32, k
                np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32), err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
        assert not got["features"][~got["valid"]].any()
        assert got["adj_label"].max() == 15 and not got["adj_label"][~got["valid"]].any()


@pytest.mark.parametrize("seed", [0, 5])
def test_batch_shuffle_stream_equals_jax(seed):
    for epoch in range(3):
        np.testing.assert_array_equal(batch_shuffle_rng(seed, epoch).permutation(40),
                                      jax_batch_shuffle_rng(seed, epoch).permutation(40))


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("buckets", [[36, 64, 100], [64, 20, 40]], ids=["bench", "clamped"])
def test_bucketed_stream_equals_jax(buckets, shuffle):
    """[20, 40, 64] leaves images of 65-100 boxes over the largest bucket:
    they clamp to it, as JAX clamps them."""
    ours, ref = _pair(True, num_images=24, num_questions=97)
    port, jstore = DeviceStore(ours, CPU), jds.DeviceStore(ref)
    assert port.entry_nbox.max() > max(buckets) or buckets == [36, 64, 100]
    for batch_size in (8, 16):
        counts = port.bucketed_batch_counts(batch_size, buckets)
        assert counts == jstore.bucketed_batch_counts(batch_size, buckets)
        steps = port.bucketed_steps_per_epoch(batch_size, buckets)
        assert steps == jstore.bucketed_steps_per_epoch(batch_size, buckets) == sum(counts)
        for epoch in range(3):
            got = list(port.epoch_indices_bucketed(epoch, batch_size, buckets, shuffle, 42))
            want = list(jstore.epoch_indices_bucketed(epoch, batch_size, buckets, shuffle, 42))
            assert len(got) == len(want) == steps
            for (R, idx), (jR, jidx) in zip(got, want):
                assert R == jR and idx.dtype == jidx.dtype
                np.testing.assert_array_equal(idx, jidx)
            seen = np.concatenate([idx[idx >= 0] for _, idx in got])
            assert sorted(seen) == list(range(97))  # each entry once per epoch
            for R, idx in got:  # each batch within its bucket (or clamped to the last)
                nbox = port.entry_nbox[idx[idx >= 0]]
                assert (nbox <= R).all() or R == max(buckets)


# --------------------------------------------------------------- (d) and (e)
def _cfg(out, **kw):
    base = dict(
        num_hid=32, relation_dim=48, num_heads=4, nongt_dim=6, imp_pos_emb_dim=16,
        fusion="butd", relation_type="implicit", residual_connection=True, adaptive=True,
        epochs=1, batch_size=16, eval_batch=8, print_freq=100, base_lr=1e-3, dropout=0.0,
        save_every_epoch=False, output=str(out) + "/",
    )
    base.update(kw)
    return Config(**base)


def _splits(adaptive):
    kw = dict(v_dim=V_DIM, num_ans=NUM_ANS, adaptive=adaptive)
    train = dict(num_images=16, num_questions=80, **kw)
    val = dict(num_images=8, num_questions=24, seed=1, name="val", **kw)
    return ((synthetic_dataset(**train), synthetic_dataset(**val)),
            (jax_synthetic_dataset(**train), jax_synthetic_dataset(**val)))


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


@pytest.mark.parametrize("layout", [
    dict(roi_buckets="36,64,100"),
    dict(adaptive=False, feature_dtype="int8"),
], ids=["buckets", "fixed36_int8"])
def test_training_run_equals_jax_run_training(tmp_path, layout):
    from tf_vqa_regat_tpu.train.loop import run_training as jax_run_training

    cfg = _cfg(tmp_path / "port", train_block=1, **layout)
    jcfg = JaxConfig(**{**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(Config)},
                        "data_mode": "device"}, use_pallas=True)
    jcfg = dataclasses.replace(jcfg, output=str(tmp_path / "jax") + "/")
    (train, val), (jtrain, jval) = _splits(cfg.adaptive)
    params = init_regat(jax.random.PRNGKey(0), jcfg, train.ntoken, V_DIM, NUM_ANS)
    init = flatten_tree(jax.tree.map(np.array, params))  # the JAX run donates `params`
    model = ReGAT(cfg, train.ntoken, V_DIM, NUM_ANS)
    load_jax_arrays(model, init)
    model, _ = run_training(cfg, train, val, model, CPU)
    jparams, _ = jax_run_training(jcfg, jtrain, jval, init_params=params)

    ours, ref = _metrics(cfg.output), _metrics(jcfg.output)
    assert len(ours) == len(ref) == 1
    for key in ("train_loss", "eval_loss", "train_score", "eval_score", "lr"):
        np.testing.assert_allclose(ours[0][key], ref[0][key], rtol=1e-6, err_msg=key)
    lines = []
    for out in (cfg.output, jcfg.output):
        with open(os.path.join(out, "log.txt")) as fh:
            lines.append([ln for ln in fh.read().splitlines() if "number of steps" in ln])
    assert lines[0] == lines[1] and len(lines[0]) == 1
    want = flatten_tree(jax.device_get(jparams))
    got = to_jax_arrays(model.state_dict())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
    # the run moved the parameters by far more than the tolerance
    assert max(float(np.abs(want[k] - init[k]).max()) for k in want) > 1e-3


def test_bucketed_preempt_and_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """Two epochs of 6 bucketed steps, one step per block; the fault hook at
    global step 8 = epoch 1, step 2: the resumed run skips 2 batches of the
    bucketed stream and equals the uninterrupted run."""
    (train, val), _ = _splits(True)
    kw = dict(epochs=2, roi_buckets="100,36,64", base_lr=5e-3, dropout=0.2,
              save_every_epoch=True, train_block=1)

    def run(cfg):
        model = ReGAT(cfg, train.ntoken, V_DIM, NUM_ANS)
        model, _ = run_training(cfg, train, val, model, CPU)
        return {k: v.clone() for k, v in model.state_dict().items()}

    full = run(_cfg(tmp_path / "a", **kw))
    cfg = _cfg(tmp_path / "b", resume=True, **kw)
    monkeypatch.setenv("REGAT_FAULT_PREEMPT_STEP", "8")
    with pytest.raises(Preempted):
        run(cfg)
    meta = ckpt.restore_meta_full(cfg.output)
    assert meta["epoch"] == 1 and meta["step_in_epoch"] == 2
    assert meta["run"]["roi_buckets"] == [36, 64, 100] and meta["run"]["steps_per_epoch"] == 6
    monkeypatch.delenv("REGAT_FAULT_PREEMPT_STEP")
    resumed = run(cfg)
    for k in full:
        np.testing.assert_allclose(resumed[k].numpy(), full[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    ma, mb = _metrics(tmp_path / "a"), _metrics(cfg.output)
    for key in ("train_loss", "train_score", "eval_score", "eval_loss", "lr"):
        np.testing.assert_allclose(mb[-1][key], ma[-1][key], rtol=1e-6, err_msg=key)
    # a different bucket list changes the epoch order: the mid-epoch resume refuses it
    monkeypatch.setenv("REGAT_FAULT_PREEMPT_STEP", "8")
    cfg_c = _cfg(tmp_path / "c", resume=True, **kw)
    with pytest.raises(Preempted):
        run(cfg_c)
    monkeypatch.delenv("REGAT_FAULT_PREEMPT_STEP")
    with pytest.raises(ValueError, match="roi_buckets"):
        run(dataclasses.replace(cfg_c, roi_buckets="36,100"))


def test_fixed36_config_through_the_entry_point(tmp_path):
    """configs/butd_vqa_fixed36.json on the CPU at small widths, int8
    tables: train writes the model, eval reproduces its last eval loss,
    predict answers every question, serve gathers at R = 36."""
    from tf_vqa_regat_tpu_torch.main import build_server, main

    argv = ["--config", os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                                     "butd_vqa_fixed36.json"),
            "--num_hid", "64", "--relation_dim", "96", "--num_heads", "4", "--nongt_dim", "10",
            "--synthetic", "--synthetic_train_size", "64", "--synthetic_val_size", "32",
            "--batch_size", "16", "--feature_dtype", "int8", "--device", "cpu",
            "--output", str(tmp_path)]
    path = main(argv + ["--mode", "train", "--epochs", "1"])
    last = _metrics(tmp_path)[-1]
    score, loss = main(argv + ["--mode", "eval", "--checkpoint", path])
    assert loss == last["eval_loss"] and score == last["eval_score"]
    with open(main(argv + ["--mode", "predict", "--checkpoint", path])) as fh:
        assert sorted(d["question_id"] for d in json.load(fh)) == list(range(32))
    server, batcher, engine = build_server(
        argv + ["--mode", "serve", "--checkpoint", path, "--serve_port", "0"])
    try:
        assert engine.num_rois == 36 and engine.store.features.dtype == torch.int8
        assert engine.infer(["what color is the car ?"], [3])[0]["answer"] in engine.ds.label2ans
    finally:
        batcher.close()
        server.server_close()
