"""Checkpoints of a tensor-parallel run of the port on the CPU, through the
entry point (`--tp_size 2` as 2 gloo processes, tests/torch_mp_util.py;
`--tp_size 1` in this process), configs/butd_vqa.json at small widths,
--dropout 0.2, --train_block 1, a step checkpoint every 2 steps, preempted
by REGAT_FAULT_PREEMPT_STEP=4 (epoch 1, step 1):

- `state.npz` holds full leaves at any tp: its keys, shapes and dtypes at
  tp = 2 equal tp = 1's, and the final .npz too;
- saved at tp = 2 and resumed at tp = 2: the final parameters and every
  epoch's metrics equal the uninterrupted tp = 2 run's;
- saved at tp = 2 and resumed at tp = 1, and saved at tp = 1 and resumed
  at tp = 2: both equal the uninterrupted runs at tp = 1 and tp = 2 within
  JAX's data- and tensor-parallel tolerances (the split sums add in
  another order). The tp ranks of a data group draw the dropout masks of
  one rank (seeded by the data index, drawn at full shapes), so the runs
  at tp = 1 and tp = 2 take the same steps;
- `--mode eval`, `predict` and `ensemble_eval` of the final .npz at tp = 2
  against tp = 1 in this process: the eval loss and score, every answer,
  the ensemble's score; rank 0 alone writes the predictions, and every
  tp = 2 log says that the steps run eagerly.

Tolerances: the resume one, rtol 1e-6 / atol 1e-7; across tp, JAX's
(tests/test_parallel.py:168-175): parameters rtol 2e-3 and atol 1e-4,
metrics rtol 1e-5.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from torch_mp_util import REPO, record, run_ranks
from tf_vqa_regat_tpu_torch.main import main

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

SMALL = ["--config", os.path.join(REPO, "configs", "butd_vqa.json"), "--num_hid", "32",
         "--relation_dim", "48", "--num_heads", "4", "--nongt_dim", "6",
         "--imp_pos_emb_dim", "16", "--num_rois", "16", "--synthetic",
         "--synthetic_train_size", "40", "--synthetic_val_size", "20", "--batch_size", "16",
         "--print_freq", "0", "--device", "cpu", "--epochs", "2", "--train_block", "1",
         "--checkpoint_every_steps", "2", "--mode", "train", "--dropout", "0.2",
         "--no-async_checkpoint"]
FINAL = "implicit-butd-pretrained_model.npz"
PREEMPT = {"REGAT_FAULT_PREEMPT_STEP": "4"}
RESUME_TOL = dict(rtol=1e-6, atol=1e-7)
TP_TOL = dict(rtol=2e-3, atol=1e-4)


def _train(out, tp, *extra):
    return SMALL + ["--output", str(out) + "/", "--tp_size", str(tp), *extra]


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in ("train_time_s", "eval_time_s", "train_qps", "ts")} for line in fh]


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _state(out):
    with open(os.path.join(out, "checkpoints", "meta.json")) as fh:
        name = json.load(fh)["dir"]
    return _npz(os.path.join(out, "checkpoints", name, "state.npz"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    root = tmp_path_factory.mktemp("tp_ckpt")
    out = {k: str(root / k) for k in ("u1", "p1", "u2", "p2", "p2_for1", "p1_for2", "inf1",
                                       "inf2")}
    # tp = 1 in this process: uninterrupted, and preempted (resumed at tp = 2)
    assert main(_train(out["u1"], 1)) is not None
    monkeypatch_module.setenv("REGAT_FAULT_PREEMPT_STEP", "4")
    assert main(_train(out["p1"], 1)) is None
    monkeypatch_module.delenv("REGAT_FAULT_PREEMPT_STEP")
    states = {"p1": _state(out["p1"])}
    shutil.copytree(out["p1"], out["p1_for2"])
    # tp = 2 on two ranks: uninterrupted; preempted twice (one resumed at
    # tp = 2, one at tp = 1); resumed; the tp = 1 save resumed
    run_ranks(2, [
        {"argv": _train(out["u2"], 2)},
        {"argv": _train(out["p2"], 2), "env": PREEMPT},
        {"argv": _train(out["p2_for1"], 2), "env": PREEMPT},
        {"argv": _train(out["p2"], 2, "--resume")},
        {"argv": _train(out["p1_for2"], 2, "--resume")},
        *({"argv": argv} for argv in _inference(out, 2)),
    ], str(root / "ranks"))
    states["p2"] = _state(out["p2_for1"])
    assert main(_train(out["p2_for1"], 1, "--resume")) is not None
    return out, states, str(root / "ranks")


def _inference(out, tp):
    """eval, predict and ensemble_eval of the tp = 1 run's final model."""
    final = os.path.join(out["u1"], FINAL)
    base = [a for a in _train(out[f"inf{tp}"], tp) if a != "train"]
    base = [*base[:base.index("--mode") + 1], "eval", *base[base.index("--mode") + 1:]]
    return [base + ["--checkpoint", final],
            [a if a != "eval" else "predict" for a in base] + ["--checkpoint", final],
            [a if a != "eval" else "ensemble_eval" for a in base]
            + ["--ensemble_checkpoints", f"implicit:{final}"]]


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_state_npz_holds_full_leaves_at_any_tp(runs):
    out, states, _ = runs
    one, two = states["p1"], states["p2"]
    assert sorted(one) == sorted(two)
    for k in one:
        assert (one[k].shape, one[k].dtype) == (two[k].shape, two[k].dtype), k
    final1, final2 = _npz(os.path.join(out["u1"], FINAL)), _npz(os.path.join(out["u2"], FINAL))
    assert {k: v.shape for k, v in final1.items()} == {k: v.shape for k, v in final2.items()}
    # the split leaves are whole: [H, D, o] and the classifier's [in, out]
    assert final2["v_relation/gatt/neighbor/0/out/v"].shape[0] == 4
    assert final2["classifier/fc1/v"].shape == (32, 64)


def test_saved_at_tp2_resumed_at_tp2_equals_the_uninterrupted_run(runs):
    out, *_ = runs
    want, got = _npz(os.path.join(out["u2"], FINAL)), _npz(os.path.join(out["p2"], FINAL))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, **RESUME_TOL, err_msg=k)
    for a, b in zip(_metrics(out["p2"]), _metrics(out["u2"]), strict=True):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **RESUME_TOL, err_msg=k)


@pytest.mark.parametrize("resumed", ["p2_for1", "p1_for2"])
def test_a_save_resumed_at_the_other_tp_equals_the_uninterrupted_runs(runs, resumed):
    """p2_for1: saved at tp = 2, resumed at tp = 1; p1_for2: the reverse."""
    out, *_ = runs
    got = _npz(os.path.join(out[resumed], FINAL))
    for ref in ("u1", "u2"):
        want = _npz(os.path.join(out[ref], FINAL))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, **TP_TOL, err_msg=f"{ref} {k}")
        for a, b in zip(_metrics(out[resumed]), _metrics(out[ref]), strict=True):
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=f"{ref} {k}")


def test_eval_predict_and_the_ensemble_at_tp2_equal_tp1(runs):
    out, _, ranks = runs
    score, loss = main(_inference(out, 1)[0])
    predictions = main(_inference(out, 1)[1])
    ensemble_score = main(_inference(out, 1)[2])
    got = [record(ranks, i, 0)["result"] for i in (5, 6, 7)]
    assert got[0][0] == pytest.approx(score, rel=1e-6)
    assert got[0][1] == pytest.approx(loss, rel=1e-6)
    assert got[2] == pytest.approx(ensemble_score, rel=1e-6)
    with open(predictions) as fh, open(got[1]) as gh:
        assert json.load(fh) == json.load(gh)
    assert record(ranks, 6, 1)["writes"] == []  # rank 0 alone writes
    for name in ("eval_log.txt", "predict_log.txt"):
        with open(os.path.join(out["inf2"], name)) as fh:
            assert "[tp] tp=2: each step runs eagerly" in fh.read(), name
