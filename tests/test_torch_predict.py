"""The port's `--mode predict` (train/loop.py::run_prediction, main.py) on
the CPU against the JAX package's run_prediction (device data path, impl
"jnp": no Pallas call) on the same parameters and the same
synthetic split: the submission JSON holds every question once with the
answer JAX writes, also on an answerless split, whose targets the port
never reads. Then the entry point: a params-only checkpoint directory in,
`{relation_type}-{fusion}-val-predictions.json` out.

Ties: the two packages' logits differ by ~1e-6 of their scale (f32 sums in
another order), so an example whose top two logits lie within TIE_RTOL of
the largest |logit| may take either answer; those are counted and printed,
and every other answer must be equal.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.config import Config as JaxConfig
from tf_vqa_regat_tpu.data.fixtures import synthetic_dataset as jax_synthetic_dataset
from tf_vqa_regat_tpu.models.regat import init_regat
from tf_vqa_regat_tpu.train.logging import Logger as JaxLogger
from tf_vqa_regat_tpu.train.loop import run_prediction as jax_run_prediction
from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.main import main, parse
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.params import flatten_tree, load_jax_arrays, state_tensors
from tf_vqa_regat_tpu_torch.train import checkpoint as ckpt
from tf_vqa_regat_tpu_torch.train.logging import Logger
from tf_vqa_regat_tpu_torch.train.loop import run_prediction

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V_DIM, NUM_ANS = 16, 7
SPLIT = dict(num_images=8, num_questions=37, v_dim=V_DIM, num_ans=NUM_ANS, seed=4, name="val")
TIE_RTOL = 1e-5


def _cfg(out, **kw):
    base = dict(
        num_hid=32, relation_dim=48, num_heads=4, nongt_dim=6, imp_pos_emb_dim=16,
        fusion="butd", relation_type="implicit", residual_connection=True, adaptive=True,
        num_rois=40, batch_size=64, output=str(out),
    )
    base.update(kw)
    return Config(**base)


def _jax_cfg(cfg):
    return JaxConfig(**{**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(Config)},
                        "data_mode": "device"})


def _answerless(ds):
    """The split without targets: predicting must not read them."""
    ds.entries.label_offsets = ds.entries.labels = ds.entries.scores = None
    return ds


def _port_logits(cfg, model, ds):
    store = DeviceStore(ds, torch.device("cpu"), targets=False)
    with torch.no_grad():
        return torch.cat([
            model.eval()(gather_batch(store, torch.from_numpy(idx).long(),
                                      cfg.resolved_num_rois()))[idx >= 0]
            for idx in store.epoch_indices(0, 16, False, cfg.seed)
        ])


@pytest.mark.parametrize("relation_type, answers", [
    ("implicit", True), ("implicit", False), ("semantic", True)])
def test_predictions_equal_jax_run_prediction(tmp_path, relation_type, answers):
    cfg = _cfg(tmp_path, relation_type=relation_type)
    semantic = relation_type == "semantic"
    jds = jax_synthetic_dataset(adaptive=True, semantic=semantic, **SPLIT)
    ds = synthetic_dataset(semantic=semantic, **SPLIT)
    if not answers:
        jds.entries.has_answers = False
        ds = _answerless(ds)
    params = init_regat(jax.random.PRNGKey(1), _jax_cfg(cfg), ds.ntoken, V_DIM, NUM_ANS)
    (tmp_path / "jax").mkdir()
    want_path = jax_run_prediction(
        _jax_cfg(cfg).replace(output=str(tmp_path / "jax")), jds, params,
        JaxLogger(str(tmp_path / "jax_log.txt")),
    )
    model = ReGAT(cfg, ds.ntoken, V_DIM, NUM_ANS)
    load_jax_arrays(model, flatten_tree(jax.tree.map(np.asarray, params)))
    path = run_prediction(cfg, ds, model, torch.device("cpu"), Logger(str(tmp_path / "log.txt")))
    assert os.path.basename(path) == os.path.basename(want_path) == (
        f"{relation_type}-butd-val-predictions.json")
    got, want = json.load(open(path)), json.load(open(want_path))
    assert [d["question_id"] for d in got] == [d["question_id"] for d in want] == list(range(37))

    logits = _port_logits(cfg, model, ds)
    top2 = logits.topk(2, dim=-1)
    tie = (top2.values[:, 0] - top2.values[:, 1]) <= TIE_RTOL * logits.abs().max()
    print(f"{int(tie.sum())} of {len(tie)} examples tied within {TIE_RTOL} of the scale")
    assert tie.float().mean() < 0.5  # the comparison holds most of the split
    for i, (g, w) in enumerate(zip(got, want)):
        if tie[i]:
            assert {g["answer"], w["answer"]} <= {ds.label2ans[int(j)] for j in top2.indices[i]}
        else:
            assert g["answer"] == w["answer"] == ds.label2ans[int(top2.indices[i, 0])], i


def test_predict_entry_point_on_a_checkpoint_directory(tmp_path, capsys):
    """`--mode predict --checkpoint DIR` with a params-only directory of
    train/checkpoint.py; `--mode export_h5` alone is still not ported."""
    argv = ["--config", os.path.join(REPO, "configs", "butd_vqa.json"), "--num_hid", "32",
            "--relation_dim", "48", "--num_heads", "4", "--nongt_dim", "6", "--num_rois", "24",
            "--synthetic", "--synthetic_val_size", "20", "--batch_size", "32",
            "--device", "cpu", "--output", str(tmp_path)]
    cfg, _ = parse(argv)
    model = ReGAT(cfg, 24, 2048, 3129)
    ckpt.save_checkpoint(str(tmp_path / "run"), state_tensors(model), 0, 0.0, False)
    path = main(argv + ["--mode", "predict", "--checkpoint", str(tmp_path / "run" / "checkpoints"
                                                                    / "epoch_0000")])
    assert path == os.path.join(str(tmp_path), "implicit-butd-val-predictions.json")
    assert f"predictions: {path}" in capsys.readouterr().out
    got = json.load(open(path))
    assert sorted(d["question_id"] for d in got) == list(range(20))
    assert all(d["answer"].startswith("ans") for d in got)
    with pytest.raises(NotImplementedError, match="export_h5"):
        parse(argv + ["--mode", "export_h5"])
