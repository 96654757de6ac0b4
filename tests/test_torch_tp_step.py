"""Tensor parallelism of the port's train step on the CPU (parallel/tensor.py,
the split layers of ops/graph_attention.py and models/classifier.py,
train/step.py over the data group), for implicit-butd, semantic-butd, BAN
and MuTAN at small widths and --dropout 0:

- from the same JAX parameters (params.py) and the same two batches (the
  port's device-store gather, handed to both), two train steps at tp = 2
  (two gloo processes) and at dp = 2 x tp = 2 (four; each data group takes
  its 8 of the 16 rows) against JAX's `build_train_step` on one device and
  on a dp = 2 x tp = 2 mesh of the virtual CPU devices (impl "jnp", whose
  softmax agrees with the kernels' all-head-max one on these inputs): the
  per-step loss and score, and the parameters after the steps, each split
  leaf put together from its parts;
- the ranks' replicated leaves bit-identical, and the parts of a split leaf
  bit-identical across the data groups;
- at tp = 2, each leaf's gradient (split leaves gathered) against the
  gradient of the one-device port model in the same process, and the eval
  metrics and predicted answers of a batch against the one-device model's;
- the loss's gradient: JAX's away from 0, and at a logit of exactly 0 the
  true derivative sigmoid(0) - target (the TF reference's
  `sigmoid_cross_entropy_with_logits` gradient), where JAX's formula gives
  -target: a split sum can round a logit to exactly 0 where one device
  gives 3e-10, and a jump there moved every leaf's gradient by percents.

Tolerances: JAX's own (tests/test_parallel.py:168-175): loss and score
rtol 1e-5, parameters rtol 2e-3 and atol 1e-4 (MuTAN 3e-3); gradients rtol
1e-5 with atol 1e-6 of the largest gradient (the split sums add in another
order); eval loss and score rtol 1e-6, answers and counts equal.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.config import Config as JaxConfig
from tf_vqa_regat_tpu.models.regat import init_regat
from tf_vqa_regat_tpu.models.regat import trainable_mask as jax_trainable_mask
from tf_vqa_regat_tpu.parallel.mesh import batch_sharding, make_mesh
from tf_vqa_regat_tpu.train.loss import bce_with_logits_sum as jax_bce
from tf_vqa_regat_tpu.train.optim import make_optimizer
from tf_vqa_regat_tpu.train.step import build_train_step, init_train_state
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.parallel.mesh import shard_axis
from tf_vqa_regat_tpu_torch.params import flatten_tree
from tf_vqa_regat_tpu_torch.train.loss import bce_with_logits_sum
from torch_tp_ranks import run_tp_ranks

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

V_DIM, NUM_ANS, R, B, STEPS = 32, 9, 12, 16, 2
CFG = JaxConfig(
    num_hid=32, relation_dim=48, num_heads=4, nongt_dim=6, imp_pos_emb_dim=16,
    fusion="butd", relation_type="implicit", adaptive=True, num_rois=R,
    residual_connection=True, base_lr=5e-3, dropout=0.0, batch_size=B, seed=5, mutan_rank=3,
)
FAMILIES = {
    "implicit": CFG,
    "semantic": CFG.replace(relation_type="semantic", label_bias=True),
    "ban": CFG.replace(fusion="ban"),
    "mutan": CFG.replace(fusion="mutan"),
}
PARAM_ATOL = {"mutan": 3e-3}
MESHES = {"tp2": (1, 2), "dp2xtp2": (2, 2)}


def _jax_batch(batch):
    out = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    for k in ("question", "num_boxes", "adj_label"):
        if k in out:
            out[k] = out[k].astype(jnp.int32)
    return out


def _jax_run(cfg, flat_tree, ntoken, batches, mesh):
    opt = make_optimizer(cfg.base_lr, cfg.grad_clip, STEPS, cfg.lr_decay_rate,
                         cfg.lr_decay_step, jax_trainable_mask(flat_tree, False))
    state = init_train_state(flat_tree, opt, mesh)
    step = build_train_step(cfg, ntoken, opt, mesh, "jnp", flat_tree)
    metrics = []
    for batch in batches:
        state, m = step(state, jax.device_put(_jax_batch(batch), batch_sharding(mesh)),
                        jax.random.PRNGKey(cfg.seed + 1))
        metrics.append([float(m["loss"]), float(m["score"]), float(m["n"])])
    return np.asarray(metrics), flatten_tree(jax.tree.map(np.asarray, state["params"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per family: the JAX parameters, JAX's one-device and dp2 x tp2 runs;
    per mesh the ranks' records. The ranks run while JAX does."""
    out = str(tmp_path_factory.mktemp("tp_step"))
    inputs, jobs = {}, []
    for name, cfg in FAMILIES.items():
        ds = synthetic_dataset(num_images=8, num_questions=40, v_dim=V_DIM, num_ans=NUM_ANS,
                               seed=3, semantic=cfg.relation_type == "semantic")
        ds = dataclasses.replace(ds, relation_type=cfg.relation_type)
        store = DeviceStore(ds, torch.device("cpu"),
                            include_adj=cfg.relation_type == "semantic")
        batches = [gather_batch(store, torch.from_numpy(idx).long(), R) for idx in
                   list(store.epoch_indices(0, B, True, cfg.seed))[:STEPS]]
        tree = jax.jit(lambda k, c=cfg, n=ds.ntoken: init_regat(k, c, n, V_DIM, NUM_ANS))(
            jax.random.PRNGKey(0))
        flat = flatten_tree(jax.tree.map(np.asarray, tree))
        inputs[name] = (cfg, tree, flat, ds.ntoken, batches)
        data = {"p/" + k: v for k, v in flat.items()}
        for i, b in enumerate(batches):
            data.update({f"b{i}/{k}": v.numpy() for k, v in b.items()})
        path = f"{out}/{name}.npz"
        np.savez(path, **data)
        port_cfg = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                    if f.name in _port_fields()}
        jobs.append({"kind": "step", "name": name, "cfg": port_cfg, "data": path,
                     "dims": {"ntoken": ds.ntoken, "v_dim": V_DIM, "num_ans": NUM_ANS}})
    with ThreadPoolExecutor(max_workers=len(MESHES)) as pool:
        launched = [pool.submit(run_tp_ranks, dp * tp, dp, tp, jobs, f"{out}/{mesh}")
                    for mesh, (dp, tp) in MESHES.items()]
        jax_runs = {}
        for name, (cfg, tree, flat, ntoken, batches) in inputs.items():
            one = _jax_run(cfg, tree, ntoken, batches, make_mesh(1, 1, jax.devices()[:1]))
            four = _jax_run(cfg, tree, ntoken, batches, make_mesh(2, 2, jax.devices()[:4]))
            jax_runs[name] = (flat, one, four)
        for f in launched:
            f.result()
    ranks = {mesh: {name: [dict(np.load(f"{out}/{mesh}/{name}-rank{r}.npz"))
                           for r in range(dp * tp)] for name in FAMILIES}
             for mesh, (dp, tp) in MESHES.items()}
    return jax_runs, ranks


@functools.lru_cache(maxsize=None)
def _port_fields():
    from tf_vqa_regat_tpu_torch.config import Config

    return frozenset(f.name for f in dataclasses.fields(Config))


def _assembled(recs, tp):
    """Full parameters from the ranks' parts: model index m is rank m (data
    index 0); a split leaf's parts concatenated along its axis."""
    out = {}
    for key in recs[0]:
        if not key.startswith("param/"):
            continue
        name = key[len("param/"):]
        axis = shard_axis(name)
        out[name.replace(".", "/")] = (
            recs[0][key] if axis is None
            else np.concatenate([recs[m][key] for m in range(tp)], axis=axis))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_tp_steps_match_jax_one_device_and_dp_tp(runs, family, mesh):
    jax_runs, ranks = runs
    flat, (m_one, p_one), (m_four, p_four) = jax_runs[family]
    dp, tp = MESHES[mesh]
    recs = ranks[mesh][family]
    for r, rec in enumerate(recs):
        assert np.array_equal(rec["metrics"], recs[0]["metrics"]), r
        for key, v in rec.items():
            if not key.startswith("param/"):
                continue
            if shard_axis(key[len("param/"):]) is None:  # replicated: bit-identical
                assert np.array_equal(v, recs[0][key]), (r, key)
            else:  # the same part on every data group
                assert np.array_equal(v, recs[r % tp][key]), (r, key)
    got = recs[0]["metrics"]
    for want in (m_one, m_four):
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[:, 2], want[:, 2])
    params = _assembled(recs, tp)
    assert set(params) == set(p_one)
    atol = PARAM_ATOL.get(family, 1e-4)
    moved = 0.0
    for key, w in p_one.items():
        assert params[key].shape == w.shape, key
        np.testing.assert_allclose(params[key], w, rtol=2e-3, atol=atol, err_msg=key)
        np.testing.assert_allclose(params[key], p_four[key], rtol=2e-3, atol=atol, err_msg=key)
        moved = max(moved, float(np.abs(w - flat[key]).max()))
    assert moved > 1e-3  # the parameters did move


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tp_gradients_eval_and_answers_match_one_device(runs, family):
    for rec in runs[1]["tp2"][family]:
        grads = {k[len("grad/"):]: v for k, v in rec.items() if k.startswith("grad/")}
        scale = max(float(np.abs(rec["grad1/" + k]).max()) for k in grads)
        assert scale > 0.0
        for k, g in grads.items():
            want = rec["grad1/" + k]
            assert g.shape == want.shape, k
            np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-6 * scale, err_msg=k)
        for k in ("loss", "score"):
            np.testing.assert_allclose(rec[f"eval/{k}"], rec[f"eval1/{k}"], rtol=1e-6)
        assert rec["eval/n"] == rec["eval1/n"] == B
        np.testing.assert_array_equal(rec["answers"], rec["answers1"])


def test_loss_gradient_at_a_zero_logit_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 6)).astype(np.float32)
    logits[:, ::2] = 0.0
    targets = rng.uniform(size=(4, 6)).astype(np.float32)
    valid = np.array([True, True, False, True])
    want = jax.grad(jax_bce)(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(valid))
    x = torch.from_numpy(logits).requires_grad_()
    bce_with_logits_sum(x, torch.from_numpy(targets), torch.from_numpy(valid)).backward()
    got, want, zero = x.grad.numpy(), np.asarray(want), logits == 0.0
    np.testing.assert_allclose(got[~zero], want[~zero], rtol=1e-6, atol=1e-7)
    true = np.where(valid[:, None], (0.5 - targets) / valid.sum(), 0.0)
    np.testing.assert_allclose(got[zero], true[zero], rtol=1e-6, atol=1e-7)
    # JAX's jnp.maximum splits the tie and its |x| takes gradient 1 at 0
    np.testing.assert_allclose(want[zero], (true - 0.5 * valid[:, None] / valid.sum())[zero],
                               rtol=1e-6, atol=1e-7)
