"""Whole runs on the CPU at small widths (the harness's look for a card
skipped), once sound and once with the timed path broken underneath, for
each fault the cell can have: `correct` has to come out true, then false."""

import numpy as np
import pytest

from regat_bench import run
from regat_bench.tests import small
from tf_vqa_regat_tpu_torch import serve as serve_mod
from tf_vqa_regat_tpu_torch.train import optim as optim_mod
from tf_vqa_regat_tpu_torch.train import step as step_mod

TRAIN = ["butd.train", "spatial.train"]


def _run(workload, seconds=1.0):
    ctx, args = small.context(workload, seconds=seconds)
    return run.execute(ctx, args)


@pytest.mark.parametrize("workload", TRAIN)
def test_sound_train_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert {"train_qps", "eval_qps", "setup_s"} <= set(res["metrics"])
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", TRAIN)
def test_step_that_leaves_the_state_unchanged(workload, monkeypatch):
    def no_update(self, grads):
        self.count += 1  # the step counts, and nothing moves

    monkeypatch.setattr(optim_mod.Adamax, "step", no_update)
    res = _run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_batch_left_out(workload, monkeypatch):
    real = step_mod.train_step

    def half(model, opt, batch, *a, **k):
        B = batch["features"].shape[0]
        return real(model, opt, {key: v[: B // 2] for key, v in batch.items()}, *a, **k)

    monkeypatch.setattr(step_mod, "train_step", half)
    res = _run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_eval_batch_left_out(workload, monkeypatch):
    real = step_mod.eval_step

    def half(model, batch):
        B = batch["features"].shape[0]
        return real(model, {key: v[: B // 2] for key, v in batch.items()})

    monkeypatch.setattr(step_mod, "eval_step", half)
    res = _run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_block_that_replays_its_first_batch(workload, monkeypatch):
    real = step_mod.TrainSteps.block

    def first_only(self, R, blk, nreal):
        return real(self, R, np.repeat(blk[:1], len(blk), axis=0), nreal)

    monkeypatch.setattr(step_mod.TrainSteps, "block", first_only)
    res = _run(workload)
    assert not res["correct"], res["checks"]


def test_sound_serve_run_is_correct():
    res = _run("butd.serve")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and {"serve_p95_ms", "setup_s"} <= set(res["metrics"])


def test_answer_altered_where_it_is_produced(monkeypatch):
    real = serve_mod.InferenceEngine.step

    def altered(self, question, img, valid):
        best, conf = real(self, question, img, valid)
        best = np.where(np.arange(len(best)) == 0, (best + 1) % 3129, best)
        return best, conf

    monkeypatch.setattr(serve_mod.InferenceEngine, "step", altered)
    res = _run("butd.serve")
    assert not res["correct"], res["checks"]
