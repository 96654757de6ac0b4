"""Checkpoints and preemption of a data-parallel run of the port on the CPU
(the counterpart of tests/test_mp_checkpoint.py), through the entry point
as 2 gloo processes (tests/torch_mp_util.py), configs/butd_vqa.json at small
widths, --dropout 0.2 (each rank's masks from its own generator),
--train_block 1, a step checkpoint every 2 steps:

- a run preempted by REGAT_FAULT_PREEMPT_STEP at epoch 1, step 1 exits 0 on
  both ranks with meta at that step, rank 0 alone writing checkpoints and
  meta.json; resumed with --resume it equals the uninterrupted run bit for
  bit (final parameters of both ranks, every epoch's metrics);
- SIGTERM to rank 1 alone, inside its second step: both ranks save at
  step 2 (the flag's MAX all-reduce at the boundary) and exit 0 without the
  final .npz;
- that step checkpoint resumed by one process (dp 1) is refused, naming
  the dp of the signature.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_mp_util import REPO, record, run_ranks

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

SMALL = ["--config", os.path.join(REPO, "configs", "butd_vqa.json"), "--num_hid", "32",
         "--relation_dim", "48", "--num_heads", "4", "--nongt_dim", "6",
         "--imp_pos_emb_dim", "16", "--num_rois", "16", "--synthetic",
         "--synthetic_train_size", "40", "--synthetic_val_size", "20", "--batch_size", "16",
         "--print_freq", "0", "--device", "cpu", "--epochs", "2", "--train_block", "1",
         "--checkpoint_every_steps", "2", "--mode", "train"]
FINAL = "implicit-butd-pretrained_model.npz"


def _train(out, *extra):
    return SMALL + ["--output", str(out) + "/", *extra]


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in ("train_time_s", "eval_time_s", "train_qps", "ts")} for line in fh]


def _params(out, command, rank):
    with np.load(os.path.join(out, f"params-{command}-rank{rank}.npz")) as z:
        return dict(z)


def _meta(out):
    with open(os.path.join(out, "checkpoints", "meta.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("full"))
    run_ranks(2, [{"argv": _train(out)}], out)
    return out


def test_a_preempted_run_resumes_to_the_uninterrupted_one(uninterrupted, tmp_path):
    out = str(tmp_path)
    # 3 steps an epoch: global step 4 is epoch 1, step 1
    run_ranks(2, [{"argv": _train(out), "env": {"REGAT_FAULT_PREEMPT_STEP": "4"}},
                  {"argv": _train(out, "--resume")}], out)
    for r in (0, 1):
        assert record(out, 0, r)["preempted"] and not record(out, 1, r)["preempted"]
    writes = [tuple(w) for w in record(out, 0, 0)["writes"]]
    assert ("meta", "epoch_0001_step_00000001") in writes
    assert record(out, 0, 1)["writes"] == []
    assert all(w[0] not in ("meta", "dir") for w in record(out, 1, 1)["writes"])
    got = [_params(out, 1, r) for r in (0, 1)]
    want = [_params(uninterrupted, 0, r) for r in (0, 1)]
    for key, v in want[0].items():
        for r in (0, 1):
            np.testing.assert_array_equal(got[r][key], v, err_msg=key)
            np.testing.assert_array_equal(want[r][key], v, err_msg=key)
    assert _metrics(out) == _metrics(uninterrupted)


def test_sigterm_to_one_rank_saves_on_both_at_one_step(tmp_path):
    out = str(tmp_path)
    results = run_ranks(2, [{"argv": _train(out), "sigterm_at_step": 2, "rank": 1}], out)
    for r in (0, 1):
        assert record(out, 0, r)["preempted"]
        assert "preempted at epoch 0 step 2" in results[r][1], results[r][1][-2000:]
    meta = _meta(out)
    assert (meta["epoch"], meta["step_in_epoch"], meta["run"]["dp"]) == (0, 2, 2), meta
    assert not os.path.exists(os.path.join(out, FINAL))
    # the step checkpoint of 2 ranks resumed by one process: refused
    env = {k: v for k, v in os.environ.items() if not k.startswith("REGAT_")}
    proc = subprocess.run([sys.executable, "-m", "tf_vqa_regat_tpu_torch.main",
                           *_train(out, "--resume")], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(env, OMP_NUM_THREADS="1"))
    assert proc.returncode != 0
    assert "'dp': (2, 1)" in proc.stderr, proc.stderr[-3000:]
