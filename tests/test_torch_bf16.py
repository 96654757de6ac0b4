"""`--compute_dtype bfloat16` in the port (BUTD fusion) against the JAX
package, on the CPU, with the JAX parameters carried across (params.py) and
the same batch (the port's store gather, handed to both), dropout off:

(f) spatial + BUTD: the port's bf16 logits against JAX's jitted bf16
    forward (`apply_regat(impl="pallas")`, B2 in interpret mode), within
    BF16_LOGITS_RTOL of the largest |logit|. Measured here: 1.5e-8 (the two
    round the same values at the same points; the last bits of f32 sums
    differ).
(g) implicit + BUTD: JAX's bf16 forward of the implicit path is not a
    dependable reference on XLA:CPU (its bf16 x bf16 -> f32 dots have
    failed there), so the port's bf16 logits are held to JAX's f32 forward
    within twice the bf16-vs-f32 gap JAX itself shows on the spatial case
    of (f). Measured here: 8.6e-3 of the largest |logit| against a spatial
    gap of 7.8e-3. Then, module by module, the dtype of every activation
    leaving a module equals the one JAX gives it, read from the JAX modules
    that run at bf16 on the CPU (language, the explicit encoder, BUTD, the
    classifier): bf16 word embeddings and joint embedding, f32 GRU states,
    question vector, relation output and answer logits.

Also: the bf16 pieces (nn.dot_f32's unrounded f32 product, the dropout
scale rounded to bf16 as JAX rounds it), a bf16 train step that keeps the
parameters, their gradients and the Adamax state in f32, no torch.autocast
in the port, and the entry point on the CPU at the JAX bench's settings
(bf16 tables and compute, roi buckets 36,64,100) for all three relation
families: train, eval (reproducing the last eval loss), predict, serve and
the ensemble.
"""

import dataclasses
import glob
import json
import os
import re
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.config import Config
from tf_vqa_regat_tpu.models import classifier as jclassifier
from tf_vqa_regat_tpu.models import fusion as jfusion
from tf_vqa_regat_tpu.models import language as jlanguage
from tf_vqa_regat_tpu.models import relation as jrelation
from tf_vqa_regat_tpu.models.regat import apply_regat, init_regat
from tf_vqa_regat_tpu.ops.spatial_graph import broadcast_adj_labels, build_spatial_graph
from tf_vqa_regat_tpu_torch import config as tconfig
from tf_vqa_regat_tpu_torch import nn as tnn
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.main import build_server, main
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.params import flatten_tree, load_jax_arrays
from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
from tf_vqa_regat_tpu_torch.train.step import train_step

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V_DIM, NUM_ANS, R = 32, 9, 16
BF16_LOGITS_RTOL = 2e-2


def _cfg(relation_type, compute_dtype):
    return Config(
        num_hid=64, relation_dim=96, num_heads=4, nongt_dim=10, fusion="butd",
        relation_type=relation_type, adaptive=True, num_rois=R, label_bias=True,
        residual_connection=True, dropout=0.0, batch_size=8, compute_dtype=compute_dtype,
        use_pallas=True,
    )


def _port_cfg(cfg):
    return tconfig.Config(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(tconfig.Config)}
    )


@pytest.fixture(scope="module")
def setup():
    """(ntoken, the port's batch, the JAX batch, JAX params per family)."""
    ds = synthetic_dataset(num_images=8, num_questions=13, v_dim=V_DIM, num_ans=NUM_ANS, seed=3)
    store = DeviceStore(ds, torch.device("cpu"))
    idx = next(store.epoch_indices(0, 8, False, 0))
    batch = gather_batch(store, torch.from_numpy(idx).long(), R)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jb["question"] = jb["question"].astype(jnp.int32)
    jb["num_boxes"] = jb["num_boxes"].astype(jnp.int32)
    params = {rt: init_regat(jax.random.PRNGKey(0), _cfg(rt, "float32"), ds.ntoken, V_DIM,
                             NUM_ANS) for rt in ("spatial", "implicit")}
    return ds.ntoken, batch, jb, params


def _jax_logits(setup, relation_type, compute_dtype):
    ntoken, _, jb, params = setup
    cfg = _cfg(relation_type, compute_dtype)
    fwd = jax.jit(lambda p, b: apply_regat(p, cfg, b, ntoken, train=False, impl="pallas"))
    return np.asarray(fwd(params[relation_type], jb))


def _port(setup, relation_type, compute_dtype):
    ntoken, _, _, params = setup
    model = ReGAT(_port_cfg(_cfg(relation_type, compute_dtype)), ntoken, V_DIM, NUM_ANS)
    load_jax_arrays(model, flatten_tree(jax.tree.map(np.asarray, params[relation_type])))
    return model.eval()


def _port_logits(setup, relation_type, compute_dtype):
    with torch.inference_mode():
        return _port(setup, relation_type, compute_dtype)(setup[1]).numpy()


def _gap(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_spatial_bf16_logits_match_jax_bf16(setup):
    want = _jax_logits(setup, "spatial", "bfloat16")
    got = _port_logits(setup, "spatial", "bfloat16")
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _gap(got, want) <= BF16_LOGITS_RTOL
    # and bf16 is not f32: the gap to JAX's f32 forward is bf16-sized
    assert _gap(got, _jax_logits(setup, "spatial", "float32")) > 1e-4


def test_implicit_bf16_logits_within_twice_the_jax_bf16_gap(setup):
    jax_gap = _gap(_jax_logits(setup, "spatial", "bfloat16"),
                   _jax_logits(setup, "spatial", "float32"))
    got = _port_logits(setup, "implicit", "bfloat16")
    assert got.dtype == np.float32 and np.isfinite(got).all()
    gap = _gap(got, _jax_logits(setup, "implicit", "float32"))
    assert 1e-4 < gap <= 2 * jax_gap, (gap, jax_gap)


def _jax_dtypes(setup):
    """The output dtypes of the JAX modules at bf16 (spatial + BUTD), read
    from their trace (jax.eval_shape) in the order apply_regat calls them."""
    ntoken, _, jb, params = setup
    p = params["spatial"]
    cfg = _cfg("spatial", "bfloat16")
    bf16 = jnp.bfloat16
    roi_mask = jnp.arange(R)[None, :] < jb["num_boxes"][:, None]

    def forward(p, jb):
        w_emb = jlanguage.word_embedding_apply(p["w_emb"], jb["question"], ntoken, cfg.op,
                                               0.0, False, None, bf16)
        q_seq, q_last = jlanguage.question_embedding_apply(p["q_emb"], w_emb, bf16)
        q_vec = jlanguage.question_self_attention_apply(p["q_att"], q_seq, 0.0, False, None,
                                                        bf16)
        adj = broadcast_adj_labels(jax.vmap(build_spatial_graph)(jb["bb"], jb["norm_bb"]),
                                   cfg.spa_label_num)
        v_emb = jrelation.explicit_encoder_apply(
            p["v_relation"], jb["features"], adj, q_vec, roi_mask, cfg.nongt_dim,
            cfg.num_heads, cfg.num_steps, cfg.residual_connection, 0.0, False, None, bf16,
            impl="pallas")
        joint, _ = jfusion.butd_apply(p["joint_emb"], v_emb, q_last, roi_mask, 0.0, False,
                                      None, bf16)
        logits = jclassifier.classifier_apply(p["classifier"], joint, 0.0, False, None, bf16)
        return {"w_emb": w_emb, "q_emb": (q_seq, q_last), "q_att": q_vec,
                "v_relation": v_emb, "joint_emb": joint, "classifier": logits}

    out = jax.eval_shape(forward, p, jb)
    return {k: tuple(str(t.dtype) for t in (v if isinstance(v, tuple) else (v,)))
            for k, v in out.items()}


@pytest.mark.parametrize("relation_type", ["spatial", "implicit"])
def test_module_output_dtypes_match_jax(setup, relation_type):
    want = _jax_dtypes(setup)
    assert want["w_emb"] == ("bfloat16",) and want["v_relation"] == ("float32",)
    model = _port(setup, relation_type, "bfloat16")
    got = {}

    def hook(name):
        def record(_, __, out):
            got[name] = tuple(str(t.dtype).replace("torch.", "")
                              for t in (out if isinstance(out, tuple) else (out,)))
        return record

    for name in want:
        getattr(model, name).register_forward_hook(hook(name))
    with torch.inference_mode():
        model(setup[1])
    assert got == want


def test_dot_f32_is_the_unrounded_product_of_rounded_operands():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(7, 96, generator=g), torch.randn(96, 5, generator=g)
    got = tnn.dot_f32(x, w, torch.bfloat16)
    exact = (x.bfloat16().double() @ w.bfloat16().double()).float()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, exact, rtol=1e-6, atol=1e-6)
    rounded = (x.bfloat16() @ w.bfloat16()).float()  # a bf16 matmul rounds its output
    assert (rounded - exact).abs().max() > 10 * (got - exact).abs().max()
    assert torch.equal(tnn.dot_f32(x, w, torch.float32), x @ w)


def test_bf16_dropout_scale_is_rounded_as_jax_rounds_it():
    x = torch.randn(64, 33).bfloat16()
    out = tnn.dropout(x, 0.2, True, torch.Generator().manual_seed(1))
    scale = float(jnp.asarray(256.0 / (256 - 51), jnp.bfloat16))
    assert scale == 1.25 and out.dtype == torch.bfloat16
    kept = out != 0
    assert torch.equal(out[kept], (x[kept].float() * scale).bfloat16())


def test_bf16_train_step_keeps_parameters_and_state_f32(setup):
    ntoken, batch, _, _ = setup
    model = _port(setup, "implicit", "bfloat16")
    opt = Adamax(model, trainable_mask(model, False), make_lr_schedule(1e-3, 4, 0.25, 2), 0.25)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m = train_step(model, opt, batch, 0, 0)
    assert m["loss"].dtype == torch.float32 and torch.isfinite(m["loss"])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(t.dtype == torch.float32 for t in opt.mu + opt.nu)
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert len(moved) > 40


def test_no_autocast_in_the_port():
    """The casts are explicit: nothing of torch's automatic mixed precision
    is called or imported."""
    pattern = re.compile(r"autocast\s*\(|torch\.amp|cuda\.amp|import autocast")
    for path in glob.glob(os.path.join(REPO, "tf_vqa_regat_tpu_torch", "**", "*.py"),
                          recursive=True):
        with open(path) as fh:
            assert not pattern.search(fh.read()), path


WIDTHS = [
    "--num_hid", "64", "--relation_dim", "96", "--num_heads", "4", "--nongt_dim", "10",
    "--synthetic", "--synthetic_val_size", "32", "--synthetic_train_size", "64",
    "--batch_size", "16", "--print_freq", "2", "--device", "cpu",
    "--feature_dtype", "bfloat16", "--compute_dtype", "bfloat16", "--roi_buckets", "36,64,100",
]
CONFIGS = {"implicit": "butd_vqa.json", "spatial": "spatial_vqa.json",
           "semantic": "semantic_vqa.json"}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Per relation family: (argv, output dir, written .npz), one epoch at
    the bench's settings."""
    runs = {}
    for rt, config in CONFIGS.items():
        out = str(tmp_path_factory.mktemp(rt))
        argv = ["--config", os.path.join(REPO, "configs", config), *WIDTHS, "--output", out]
        runs[rt] = argv, out, main(argv + ["--mode", "train", "--epochs", "1"])
    return runs


@pytest.mark.parametrize("relation_type", list(CONFIGS))
def test_entry_point_at_the_bench_settings(trained, relation_type, capsys):
    argv, out, path = trained[relation_type]
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        last = [json.loads(line) for line in fh][-1]
    assert np.isfinite(last["train_loss"])
    with open(os.path.join(out, "log.txt")) as fh:
        log = fh.read()
    # 64 questions over 8 images of 24-96 boxes: 8, 8 and 48 entries in the
    # three buckets, so 1 + 1 + 3 steps of 16 (4 without buckets)
    assert "[DEBUG] epoch 0, number of steps: 5" in log
    # 3 + 2 + 3 batches of 4, one block per bucket at --eval_block 8 (JAX's count)
    assert "[DEBUG] eval data loader len: 3" in log
    score, loss = main(argv + ["--mode", "eval", "--checkpoint", path])
    assert loss == last["eval_loss"] and score == last["eval_score"]
    pred = main(argv + ["--mode", "predict", "--checkpoint", path])
    with open(pred) as fh:
        assert sorted(d["question_id"] for d in json.load(fh)) == list(range(32))
    server, batcher, engine = build_server(
        argv + ["--mode", "serve", "--checkpoint", path, "--serve_port", "0",
                "--serve_batch_sizes", "1"])
    assert engine.store.features.dtype == torch.bfloat16
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/predict",
            data=json.dumps({"question": "what color is the cat ?", "image_id": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = json.loads(r.read())
        assert answer["answer"] in engine.ds.label2ans
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(timeout=10)


def test_ensemble_at_the_bench_settings(trained, tmp_path, capsys):
    spec = ",".join(f"{rt}:{trained[rt][2]}" for rt in CONFIGS)
    argv = ["--config", os.path.join(REPO, "configs", "semantic_vqa.json"), *WIDTHS,
            "--output", str(tmp_path), "--mode", "ensemble_eval", "--ensemble_checkpoints", spec]
    score = main(argv)
    assert 0.0 <= score <= 100.0
    assert "members=['implicit', 'spatial', 'semantic'] data=device" in capsys.readouterr().out
