"""Serving over the sharded store (serve.py::serve_store_mode, the engine
on a process group, data/sharded_store.py::gather_images) on the CPU, at
small widths, over 2 gloo processes (tests/torch_tp_ranks.py):

- the lookup by global image id over 2 ranks equals JAX's
  `build_sharded_image_gather` on a dp = 2 mesh of the virtual CPU
  devices, bit for bit, for f32, bf16 and int8 tables with the semantic
  labels, for ids owned by both shards and invalid slots;
- the engine under a budget that only one shard's tables fit takes the
  sharded store on both ranks; rank 0 answers what the replicated engine
  in this process answers (the other rank follows its calls until its
  stop), and both ranks' logits match the replicated engine's;
- at --tp_size 2 (2 ranks, the replicated store, the forward pass split
  over them and run eagerly) the engine answers what the one-device
  engine answers, with its logits;
- the policy: replicated when the split fits, sharded when a shard does,
  else the refusal with JAX's message and numbers (JAX prints them at one
  decimal, the port at two).

Tolerances: the gather exact; logits atol 1e-5 (the same model on the
same rows, gathered another way), answers equal, confidences 1e-5.
"""

import dataclasses
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.config import Config as JaxConfig
from tf_vqa_regat_tpu.data import entries as jax_entries
from tf_vqa_regat_tpu.data import features as jax_features
from tf_vqa_regat_tpu.data.sharded_store import ShardedDeviceStore as JaxShardedStore
from tf_vqa_regat_tpu.data.sharded_store import build_sharded_image_gather
from tf_vqa_regat_tpu.parallel.mesh import make_mesh
from tf_vqa_regat_tpu.serve import InferenceEngine as JaxEngine
from tf_vqa_regat_tpu_torch.config import parse_with_config
from tf_vqa_regat_tpu_torch.data.sharded_store import estimate_sharded_nbytes
from tf_vqa_regat_tpu_torch.data.store import estimate_nbytes
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.main import build_dataset, load_model, parse
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.params import save_npz
from tf_vqa_regat_tpu_torch.serve import InferenceEngine, serve_store_mode
from torch_mp_util import REPO
from torch_tp_ranks import run_tp_ranks

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

R = 16
DATASET = dict(num_images=9, num_questions=30, v_dim=24, num_ans=7, seed=4, semantic=True)
DTYPES = ("float32", "bfloat16", "int8")
WIDTHS = ["--num_hid", "32", "--relation_dim", "48", "--num_heads", "4", "--nongt_dim", "6",
          "--imp_pos_emb_dim", "16", "--num_rois", str(R)]
QUESTIONS = ["what color is the cat ?", "is there a dog ?", "how many cats ?",
             "what is on the table ?", "is it red ?"]


def jax_split(ds):
    s = ds.store
    store = jax_features.FeatureStore(
        adaptive=s.adaptive, features=s.features, normalized_bb=s.normalized_bb, bb=s.bb,
        pos_boxes=s.pos_boxes, semantic_adj=s.semantic_adj, spatial_adj=s.spatial_adj)
    ent = jax_entries.EntryTable(**{f.name: getattr(ds.entries, f.name)
                                    for f in dataclasses.fields(ds.entries)})
    return jax_features.VQADataset(
        name=ds.name, entries=ent, store=store, num_ans=ds.num_ans, label2ans=ds.label2ans,
        dictionary=ds.dictionary, relation_type=ds.relation_type, ntoken=ds.ntoken)


def _argv(config, *extra):
    return ["--config", os.path.join(REPO, "configs", config), *WIDTHS, "--synthetic",
            "--synthetic_val_size", "40", "--device", "cpu", "--mode", "serve", *extra]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' records: the gathers, and the sharded engine of each
    config; with the requests and the budgets."""
    out = str(tmp_path_factory.mktemp("sharded_serve"))
    ds = dataclasses.replace(synthetic_dataset(**DATASET), relation_type="semantic")
    n_img = ds.store.num_images
    img = np.array([0, 8, 3, 5, 0, 7, 1, 2, 6, 4, 0], np.int64)
    valid = np.array([1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0], bool)
    assert set(img[valid]) == set(range(n_img))
    img_len = np.asarray([int(n) for n in _img_len(ds)], np.int64)
    n_box = np.where(valid, np.minimum(img_len[img], R), 0)
    np.savez(f"{out}/gather.npz", img=img, n_box=n_box)
    jobs = [{"kind": "gather", "name": "gather", "dataset": DATASET, "relation_type": "semantic",
             "data": f"{out}/gather.npz", "dtypes": list(DTYPES), "num_rois": R}]
    budgets = {}
    for config in ("butd_vqa.json", "semantic_vqa.json"):
        cfg = parse(_argv(config))[0]
        vds = build_dataset(cfg)
        path = f"{out}/{config}.npz"
        save_npz(path, ReGAT(cfg, vds.ntoken, vds.v_dim, vds.num_ans))
        include_adj = cfg.relation_type != "implicit"
        need = estimate_nbytes(vds, include_adj, cfg.feature_dtype)
        shard = estimate_sharded_nbytes(vds, cfg.relation_type == "semantic", cfg.feature_dtype,
                                        2)
        assert shard < need
        budgets[config] = (shard + need) / 2 / 1e9
        ids = sorted({int(i) for i in vds.entries.image_ids})
        image_ids = [ids[j % len(ids)] for j in range(7)] + [-5]  # an unknown id last
        toks = np.full((4, vds.entries.q_tokens.shape[1]), vds.padding_idx, np.int64)
        req_img = np.array([0, 3, 1, 0], np.int64)
        req_valid = np.array([True, True, True, False])
        for j in range(3):
            toks[j, :3] = vds.entries.q_tokens[j, :3]
        np.savez(f"{out}/{config}-req.npz", question=toks, img=req_img, valid=req_valid)
        jobs.append({"kind": "serve", "name": config, "data": f"{out}/{config}-req.npz",
                     "argv": _argv(config, "--checkpoint", path, "--device_store_budget_gb",
                                   repr(budgets[config])),
                     "questions": [QUESTIONS[j % len(QUESTIONS)] for j in range(8)],
                     "image_ids": image_ids})
    # the butd engine at tp = 2 over the replicated store
    tp_job = dict(jobs[1], name="tp2", argv=_argv("butd_vqa.json", "--checkpoint",
                                                   f"{out}/butd_vqa.json.npz", "--tp_size", "2"))
    with ThreadPoolExecutor(max_workers=2) as pool:
        done = [pool.submit(run_tp_ranks, 2, 2, 1, jobs, out),
                pool.submit(run_tp_ranks, 2, 1, 2, [tp_job], out + "/tp2")]
        for f in done:
            f.result()
    recs = {job["name"]: [dict(np.load(f"{out}/{job['name']}-rank{r}.npz")) for r in (0, 1)]
            for job in jobs}
    recs["tp2"] = [dict(np.load(f"{out}/tp2/tp2-rank{r}.npz")) for r in (0, 1)]
    return ds, img, n_box, jobs + [tp_job], recs


def _img_len(ds):
    from tf_vqa_regat_tpu_torch.data.store import image_rows

    return image_rows(ds)[1]


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_image_gather_equals_jax_bit_for_bit(ranks, dtype):
    ds, img, n_box, _, recs = ranks
    mesh = make_mesh(2, 1, devices=jax.devices()[:2])
    store = JaxShardedStore(jax_split(ds), mesh, True, dtype)
    gather = build_sharded_image_gather(mesh, R)
    want = gather(store.arrays, store.image_meta_arrays(), jnp.asarray(img, jnp.int32),
                  jnp.asarray(n_box, jnp.int32))
    for r in (0, 1):
        for name, w in zip(("features", "norm_bb", "bb", "adj"), want):
            got = recs["gather"][r][f"{dtype}/{name}"]
            w = np.asarray(w)
            assert got.shape == w.shape, name
            np.testing.assert_array_equal(got, w.astype(got.dtype), err_msg=f"{dtype} {name}")
            assert got.dtype == (np.int32 if name == "adj" else np.float32)
    # both shards own requested images, and the invalid slots are zero
    owners = {int(s) for s in store.img_shard[img[n_box > 0]]}
    assert owners == {0, 1}
    assert not recs["gather"][0][f"{dtype}/features"][n_box == 0].any()


@pytest.mark.parametrize("config", ["butd_vqa.json", "semantic_vqa.json", "tp2"])
def test_the_sharded_engine_answers_what_the_replicated_engine_answers(ranks, config):
    """butd_vqa.json and semantic_vqa.json: the sharded store at dp = 2; tp2:
    butd at tp = 2 over the replicated store."""
    *_, jobs, recs = ranks
    job = next(j for j in jobs if j["name"] == config)
    cfg = parse(job["argv"])[0].replace(tp_size=1)
    ds = build_dataset(cfg)
    engine = InferenceEngine(cfg.replace(device_store_budget_gb=70.0), ds, load_model(cfg, ds),
                             torch.device("cpu"), batch_sizes=(1, 4))
    assert engine.store_mode == "replicated"
    req = dict(np.load(job["data"]))
    want = engine.logits(*(torch.from_numpy(req[k]) for k in ("question", "img", "valid")))
    for r in (0, 1):
        mode = "replicated" if config == "tp2" else "sharded"
        assert str(recs[config][r]["store_mode"]) == mode
        np.testing.assert_allclose(recs[config][r]["logits"], want.numpy(), rtol=0, atol=1e-5)
    got = json.loads(str(recs[config][0]["answers"]))
    expected = engine.infer(job["questions"], job["image_ids"])
    assert len(got) == len(expected) == 8 and "error" in got[-1]
    for g, w in zip(got, expected):
        assert g.keys() == w.keys()
        if "answer" in w:
            assert g["answer"] == w["answer"]
            assert g["confidence"] == pytest.approx(w["confidence"], abs=1e-5)


def test_the_store_policy_and_the_refusal_keep_jax_s(ranks):
    ds = ranks[0]
    cfg = parse_with_config(["--relation_type", "semantic", "--num_rois", str(R)])
    need = estimate_nbytes(ds, True, "float32")
    shard = estimate_sharded_nbytes(ds, True, "float32", 2)
    assert serve_store_mode(cfg.replace(device_store_budget_gb=need / 1e9), ds, True, 2) \
        == "replicated"
    assert serve_store_mode(cfg.replace(device_store_budget_gb=shard / 1e9), ds, True, 2) \
        == "sharded"
    jds = jax_split(ds)
    for dtype, budget in (("float32", shard / 2), ("int8", 1.0)):
        small = cfg.replace(device_store_budget_gb=budget / 1e9, feature_dtype=dtype)
        with pytest.raises(ValueError) as port:
            serve_store_mode(small, ds, True, 2)
        jcfg = JaxConfig(relation_type="semantic", num_rois=R, dp_size=2,
                         device_store_budget_gb=budget / 1e9, feature_dtype=dtype)
        with pytest.raises(ValueError) as want:
            _jax_engine(jcfg, jds)
        assert _numbers_cut(port.value) == _numbers_cut(want.value), (port.value, want.value)
        assert "replicated" in str(port.value) and "GB/shard sharded over dp=2" in str(port.value)


def _numbers_cut(err):
    return re.sub(r"\d+\.\d+", "N", str(err))


def _jax_engine(jcfg, jds):
    """JAX's engine up to its capacity policy (it refuses before it reads
    the parameters), over 2 of the virtual devices."""
    import tf_vqa_regat_tpu.serve as jserve

    real = jserve.make_mesh
    jserve.make_mesh = lambda dp, tp: make_mesh(2, 1, devices=jax.devices()[:2])
    try:
        return JaxEngine(jcfg, jds, params=None)
    finally:
        jserve.make_mesh = real
