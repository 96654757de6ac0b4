"""The reference-quirk switches of the port (--ref_compat_q_att,
--ref_compat_pos) against the JAX package on the CPU, with the JAX
parameters carried across (params.py) and the same batches (the port's
gather, handed to both; impl "jnp", dropout off):

- `position_matrix_ref_compat` against JAX's at (R, nongt_dim) = (36, 6),
  (100, 20) and (8, 20), and equal to the corrected matrix at R = nongt_dim;
- q_att's batch-axis softmax against `question_self_attention_apply(
  ref_compat=True)`;
- the whole model with both flags on (implicit relations through B1's plain
  version, R = 12 against nongt_dim 6; semantic relations through B2's):
  logits and every leaf's gradient against `apply_regat`; the implicit
  model's flags-off output differs by more than 1e-3, as JAX's trajectory
  test holds it;
- --grad_accum 2 with the flags on: the gradient against JAX's
  `_accum_grads` (strided microbatches; the softmax spans a microbatch);
- dp = 2 over gloo ranks (tests/torch_tp_ranks.py), the model built with
  the data axis: the ranks' gradient sums, added and divided by the global
  count, against JAX's one-device gradient of the global batch, at
  --grad_accum 1 and 2 (each rank's rows of a microbatch gathered in rank
  order are JAX's global microbatch);
- padded rows take part in the softmax as in JAX: an eval pass whose last
  batch is partial and whose last block is padded with an all -1 batch
  against JAX's run_evaluation (the padded rows' gathered inputs equal to
  JAX's gather), and one serve request batch padded to the compiled size
  against the JAX engine (answers, and logits against JAX's serve step).

Tolerances: logits and per-leaf gradients atol/rtol 1e-4; losses rtol 1e-5;
position matrices rtol 1e-6.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.config import Config as JaxConfig
from tf_vqa_regat_tpu.data.device_store import gather_batch as jax_gather_batch
from tf_vqa_regat_tpu.data.device_store import gather_image_features as jax_gather_images
from tf_vqa_regat_tpu.data.fixtures import synthetic_dataset as jax_synthetic_dataset
from tf_vqa_regat_tpu.models.language import question_self_attention_apply
from tf_vqa_regat_tpu.models.regat import apply_regat, init_regat
from tf_vqa_regat_tpu.ops.position import position_matrix_ref_compat as jax_pos_ref
from tf_vqa_regat_tpu.serve import InferenceEngine as JaxInferenceEngine
from tf_vqa_regat_tpu.train.logging import Logger as JaxLogger
from tf_vqa_regat_tpu.train.loop import run_evaluation as jax_run_evaluation
from tf_vqa_regat_tpu.train.loss import bce_with_logits_sum as jax_bce
from tf_vqa_regat_tpu.train.step import _accum_grads
from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.ops.position import position_matrix, position_matrix_ref_compat
from tf_vqa_regat_tpu_torch.params import flatten_tree, load_jax_arrays
from tf_vqa_regat_tpu_torch.serve import InferenceEngine
from tf_vqa_regat_tpu_torch.train.logging import Logger
from tf_vqa_regat_tpu_torch.train.loop import run_evaluation
from tf_vqa_regat_tpu_torch.train.step import grad_sums, train_forward
from torch_tp_ranks import run_tp_ranks

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
V_DIM, NUM_ANS, R, B = 32, 9, 12, 16
CFG = JaxConfig(
    num_hid=32, relation_dim=48, num_heads=4, nongt_dim=6, imp_pos_emb_dim=16,
    fusion="butd", relation_type="implicit", adaptive=True, num_rois=R,
    residual_connection=True, base_lr=1e-3, dropout=0.0, batch_size=B, seed=5,
    ref_compat_q_att=True, ref_compat_pos=True,
)
FAMILIES = {"implicit": CFG, "semantic": CFG.replace(relation_type="semantic")}
TOL = dict(atol=1e-4, rtol=1e-4)


def _port_cfg(cfg, **kw):
    return Config(**{**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(Config)}, **kw})


def _jax_batch(batch):
    out = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    for k in ("question", "num_boxes", "adj_label"):
        if k in out:
            out[k] = out[k].astype(jnp.int32)
    return out


def _port_model(cfg, flat, ntoken, data=None):
    model = ReGAT(cfg, ntoken, V_DIM, NUM_ANS, data=data)
    load_jax_arrays(model, flat)
    return model


def _jax_init(cfg, ntoken, seed):
    return jax.jit(lambda k: init_regat(k, cfg, ntoken, V_DIM, NUM_ANS))(
        jax.random.PRNGKey(seed))


def _split(family):
    ds = synthetic_dataset(num_images=8, num_questions=40, v_dim=V_DIM, num_ans=NUM_ANS, seed=3,
                           semantic=family == "semantic")
    return dataclasses.replace(ds, relation_type=family)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per family: the JAX tree and flat parameters, ntoken, the first
    batch, JAX's (loss, logits, grads) of it at --grad_accum 1 and (implicit)
    2; the dp = 2 ranks' records at --grad_accum 1 and 2 (run while JAX
    computes)."""
    out = str(tmp_path_factory.mktemp("ref_compat"))
    inputs, jobs = {}, []
    for family, cfg in FAMILIES.items():
        ds = _split(family)
        store = DeviceStore(ds, CPU, include_adj=family == "semantic")
        idx = next(iter(store.epoch_indices(0, B, True, cfg.seed)))
        batch = gather_batch(store, torch.from_numpy(idx).long(), R)
        tree = _jax_init(cfg, ds.ntoken, 0)
        flat = flatten_tree(jax.tree.map(np.asarray, tree))
        inputs[family] = (cfg, tree, flat, ds.ntoken, batch)
        if family == "implicit":
            data = {"p/" + k: v for k, v in flat.items()}
            data.update({f"b0/{k}": v.numpy() for k, v in batch.items()})
            np.savez(f"{out}/data.npz", **data)
            for k in (1, 2):
                port_cfg = dataclasses.asdict(_port_cfg(cfg, grad_accum=k))
                jobs.append({"kind": "step", "name": f"accum{k}", "cfg": port_cfg,
                             "data": f"{out}/data.npz", "grad_sums": True,
                             "dims": {"ntoken": ds.ntoken, "v_dim": V_DIM, "num_ans": NUM_ANS}})
    with ThreadPoolExecutor(max_workers=1) as pool:
        launched = pool.submit(run_tp_ranks, 2, 2, 1, jobs, f"{out}/dp2")
        jax_runs = {}
        for family, (cfg, tree, flat, ntoken, batch) in inputs.items():
            jb = _jax_batch(batch)

            def loss_fn(p, cfg=cfg, ntoken=ntoken, jb=jb):
                logits = apply_regat(p, cfg, jb, ntoken, train=True,
                                     rng=jax.random.PRNGKey(0), impl="jnp")
                return jax_bce(logits, jb["target"], jb["valid"]), logits

            (loss, logits), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
            jax_runs[(family, 1)] = (float(loss), np.asarray(logits),
                                     flatten_tree(jax.tree.map(np.asarray, g)))
            if family == "implicit":
                acc = jax.jit(lambda p, b, cfg=cfg, ntoken=ntoken: _accum_grads(
                    p, b, jax.random.PRNGKey(0), cfg.replace(grad_accum=2), ntoken, "jnp",
                    None, 2))
                g2, m2 = acc(tree, jb)
                jax_runs[(family, 2)] = (float(m2["loss"]), None,
                                         flatten_tree(jax.tree.map(np.asarray, g2)))
        launched.result()
    ranks = {k: [dict(np.load(f"{out}/dp2/accum{k}-rank{r}.npz")) for r in (0, 1)]
             for k in (1, 2)}
    return inputs, jax_runs, ranks


def _assert_grads(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, err_msg=key, **TOL)


@pytest.mark.parametrize("R_, nongt", [(36, 6), (100, 20), (8, 20)])
def test_position_matrix_ref_compat_matches_jax(R_, nongt):
    rng = np.random.default_rng(R_ + nongt)
    xy = rng.uniform(0, 400, (3, R_, 2)).astype(np.float32)
    wh = rng.uniform(1, 200, (3, R_, 2)).astype(np.float32)
    bb = np.concatenate([xy, xy + wh], axis=-1)
    got = position_matrix_ref_compat(torch.from_numpy(bb), nongt).numpy()
    want = np.asarray(jax_pos_ref(jnp.asarray(bb), nongt))
    n = min(nongt, R_)
    assert got.shape == want.shape == (3, R_, n, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # at R = nongt_dim the row slice is the whole matrix: the corrected one
    sq = torch.from_numpy(bb[:, :n])
    assert torch.equal(position_matrix_ref_compat(sq, n), position_matrix(sq, n))


def test_q_att_batch_axis_softmax_matches_jax(runs):
    cfg, tree, flat, ntoken, _ = runs[0]["implicit"]
    q_seq = np.random.default_rng(0).standard_normal((6, 14, cfg.num_hid)).astype(np.float32)
    want = question_self_attention_apply(tree["q_att"], jnp.asarray(q_seq), 0.0, False, None,
                                         ref_compat=True)
    model = _port_model(_port_cfg(cfg), flat, ntoken).eval()
    with torch.no_grad():
        got = model.q_att(torch.from_numpy(q_seq))
        fixed = ReGAT(_port_cfg(cfg, ref_compat_q_att=False), ntoken, V_DIM, NUM_ANS)
        load_jax_arrays(fixed, flat)
        per_example = fixed.eval().q_att(torch.from_numpy(q_seq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float((got - per_example).abs().max()) > 1e-3


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_and_gradients_match_jax_with_flags_on(runs, family):
    inputs, jax_runs, _ = runs
    cfg, _, flat, ntoken, batch = inputs[family]
    loss_want, logits_want, grads_want = jax_runs[(family, 1)]
    model = _port_model(_port_cfg(cfg), flat, ntoken)
    loss, logits = train_forward(model, batch, 0, cfg.seed)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(logits.detach().numpy(), logits_want, **TOL)
    np.testing.assert_allclose(float(loss.detach()), loss_want, rtol=1e-5)
    _assert_grads({n.replace(".", "/"): g.numpy()
                   for (n, _), g in zip(model.named_parameters(), grads)}, grads_want)
    # the switches change the model: the flags-off output differs (by more
    # than 1e-3 with both on; semantic takes q_att's alone, which moves its
    # small logits at init by ~1e-4)
    off = _port_model(_port_cfg(cfg, ref_compat_q_att=False, ref_compat_pos=False), flat, ntoken)
    with torch.no_grad():
        off_logits = train_forward(off, batch, 0, cfg.seed)[1]
    gap = float((off_logits - logits.detach()).abs().max())
    assert gap > (1e-3 if family == "implicit" else 1e-5)


def test_grad_accum_2_matches_jax_accum_grads(runs):
    inputs, jax_runs, _ = runs
    cfg, _, flat, ntoken, batch = inputs["implicit"]
    loss_want, _, grads_want = jax_runs[("implicit", 2)]
    model = _port_model(_port_cfg(cfg, grad_accum=2), flat, ntoken)
    g, loss_sum, _, n = grad_sums(model, list(model.parameters()), batch, 0, cfg.seed, 2)
    np.testing.assert_allclose(float(loss_sum / n), loss_want, rtol=1e-5)
    _assert_grads({name.replace(".", "/"): (v / n).numpy()
                   for (name, _), v in zip(model.named_parameters(), g)}, grads_want)
    # a microbatch's softmax spans that microbatch only: not the k = 1 gradient
    one = jax_runs[("implicit", 1)][2]
    assert max(float(np.abs(grads_want[k] - one[k]).max()) for k in one) > 1e-4


@pytest.mark.parametrize("k", [1, 2])
def test_dp2_over_gloo_matches_jax_global_batch(runs, k):
    _, jax_runs, ranks = runs
    loss_want, _, grads_want = jax_runs[("implicit", k)]
    recs = ranks[k]
    n = sum(float(r["gsum_n"]) for r in recs)
    assert n == B
    np.testing.assert_allclose(sum(float(r["gsum_loss"]) for r in recs) / n, loss_want,
                               rtol=1e-5)
    names = [key[len("gsum/"):] for key in recs[0] if key.startswith("gsum/")]
    _assert_grads({name.replace(".", "/"): sum(r["gsum/" + name] for r in recs) / n
                   for name in names}, grads_want)


@pytest.fixture(scope="module")
def val():
    """(the port's val split, JAX's, the JAX init, as flat arrays): 37
    questions over 8 images."""
    kw = dict(num_images=8, num_questions=37, v_dim=V_DIM, num_ans=NUM_ANS, seed=CFG.seed + 1,
              name="val")
    ours, ref = synthetic_dataset(**kw), jax_synthetic_dataset(**kw)
    tree = _jax_init(CFG, ref.dictionary.ntoken, 1)
    return ours, ref, tree, flatten_tree(jax.tree.map(np.asarray, tree))


def test_eval_with_padded_batch_and_block_matches_jax(val, tmp_path):
    """37 questions in batches of 8 (the last 5 real, 3 padded), blocks of
    2 (the last block's second batch all -1)."""
    cfg = CFG.replace(eval_batch=8, eval_block=2, output=str(tmp_path) + "/")
    ours, ref, tree, flat = val
    want_score, want_loss, _ = jax_run_evaluation(cfg, ref, tree,
                                                  JaxLogger(str(tmp_path / "jax.txt")))
    model = _port_model(_port_cfg(cfg), flat, ours.ntoken)
    score, loss, _ = run_evaluation(_port_cfg(cfg), ours, model, CPU,
                                    Logger(str(tmp_path / "log.txt")))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert abs(score - want_score) < 1e-6
    # the padded rows that enter the softmax are JAX's: no boxes, zero
    # features and boxes, a question of padding tokens
    from tf_vqa_regat_tpu.data.device_store import DeviceStore as JaxDeviceStore

    idx = np.array([32, 33, 34, 35, 36, -1, -1, -1])
    got = gather_batch(DeviceStore(ours, CPU), torch.from_numpy(idx), R)
    jstore = JaxDeviceStore(ref)
    want = jax_gather_batch(jstore.arrays, jnp.asarray(idx), R, NUM_ANS, jstore.padding_idx)
    for key in ("features", "bb", "question", "num_boxes", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def test_serve_batch_padded_to_compiled_size_matches_jax_engine(val):
    """Three requests in a compiled batch of 4: the padded slot (padding
    tokens, image 0, no boxes) enters the batch-axis softmax."""
    cfg = CFG
    ours, ref, tree, flat = val
    jax_engine = JaxInferenceEngine(cfg, ref, tree, batch_sizes=(4,))
    engine = InferenceEngine(_port_cfg(cfg), ours, _port_model(_port_cfg(cfg), flat, ours.ntoken),
                             CPU, batch_sizes=(4,))
    questions = ["what color is the cat ?", "how many people are on the left ?",
                 "is the car red ?"]
    ids = sorted(engine.img_index)[:3]
    got, want = engine.infer(questions, ids), jax_engine.infer(questions, ids)
    assert [g["answer"] for g in got] == [w["answer"] for w in want]
    for g, w in zip(got, want):
        assert abs(g["confidence"] - w["confidence"]) <= 1e-4
    # the logits of the padded batch, against JAX's serve step's
    toks = np.full((4, engine.max_q_len), ours.padding_idx, np.int64)
    img, valid = np.zeros(4, np.int64), np.zeros(4, bool)
    for j, (q, i) in enumerate(zip(questions, ids)):
        toks[j], img[j], valid[j] = engine._encode(q), engine.img_index[i], True
    logits = engine.logits(torch.from_numpy(toks), torch.from_numpy(img),
                           torch.from_numpy(valid)).numpy()
    arrays = jax_engine.store.arrays
    n_box = jnp.where(jnp.asarray(valid), jnp.minimum(arrays["img_len"][img], R), 0)
    features, norm_bb, bb = jax_gather_images(arrays, jnp.asarray(img), n_box, R)
    jb = {"features": features, "norm_bb": norm_bb, "bb": bb, "num_boxes": n_box,
          "question": jnp.asarray(toks, jnp.int32), "valid": jnp.asarray(valid)}
    want_logits = jax.jit(lambda t, b: apply_regat(t, cfg, b, ref.ntoken, train=False,
                                                   impl="jnp"))(tree, jb)
    np.testing.assert_allclose(logits, np.asarray(want_logits), **TOL)
