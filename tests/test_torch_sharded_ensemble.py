"""The ensemble over the sharded store (train/ensemble.py::_sharded_passes)
on the CPU: an implicit + spatial + semantic ensemble of small members
over 2 gloo processes (`--data_mode sharded`, tests/torch_tp_ranks.py),
the members sharing one sharded base store and each explicit member's edge
labels partitioned with its image assignment, against the replicated
(`--data_mode device`) ensemble in this process:

- every entry of the split is scored by exactly one data group, and its
  averaged probabilities equal the replicated ensemble's;
- the score of the sharded run (its loss and count summed over the ranks)
  equals the replicated score on both ranks, and rank 0's log line names
  data=sharded.

Tolerances: probabilities atol 1e-5 (the same members on the same rows,
gathered another way), the score rel 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu_torch.data.store import DeviceStore, pack_soft_targets
from tf_vqa_regat_tpu_torch.main import build_dataset, parse
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.params import save_npz
from tf_vqa_regat_tpu_torch.train import ensemble
from tf_vqa_regat_tpu_torch.train.logging import Logger
from torch_mp_util import REPO
from torch_tp_ranks import run_tp_ranks

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
SMALL = ["--num_hid", "32", "--relation_dim", "48", "--num_heads", "4", "--nongt_dim", "6",
         "--imp_pos_emb_dim", "16", "--num_rois", "16", "--synthetic",
         "--synthetic_val_size", "40", "--device", "cpu", "--mode", "ensemble_eval",
         "--eval_batch", "8"]
MEMBERS = ("implicit", "spatial", "semantic")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded_ensemble"))
    spec = ",".join(f"{rt}:{out}/{rt}.npz" for rt in MEMBERS)
    argv = ["--config", os.path.join(REPO, "configs", "semantic_vqa.json"), *SMALL,
            "--ensemble_checkpoints", spec, "--output", out + "/"]
    cfg = parse(argv)[0]
    ds = build_dataset(cfg)
    # random members answer nothing right: each is pushed towards the
    # split's most credited answer, so that the score is not 0
    labels, scores = pack_soft_targets(ds.entries, ds.num_ans)
    credit = np.bincount(labels[labels >= 0], scores[labels >= 0], minlength=ds.num_ans)
    for rt in MEMBERS:
        member = ReGAT(cfg.replace(relation_type=rt), ds.ntoken, ds.v_dim, ds.num_ans)
        with torch.no_grad():
            member.classifier.fc2.b[int(credit.argmax())] = 2.0
        save_npz(f"{out}/{rt}.npz", member)
    run_tp_ranks(2, 2, 1, [{"kind": "ensemble", "name": "sharded",
                            "argv": argv + ["--data_mode", "sharded"]}], out)
    ranks = [dict(np.load(f"{out}/sharded-rank{r}.npz")) for r in (0, 1)]
    with open(f"{out}/sharded-log-rank0.txt") as fh:  # rank 0 alone writes logs
        log = fh.read()
    assert not os.path.exists(f"{out}/sharded-log-rank1.txt")
    # the replicated ensemble in this process
    dcfg = cfg.replace(data_mode="device")
    logger = Logger(os.path.join(out, "replicated-log.txt"))
    try:
        members = ensemble.load_members(dcfg, ds, CPU, logger)
        tables = ensemble.member_adj_tables(members, ds, CPU)
        store = DeviceStore(ds, CPU)
        probs = np.zeros((len(ds.entries.question_ids), ds.num_ans), np.float32)
        for idx in store.epoch_indices(0, dcfg.resolved_eval_batch(), False, dcfg.seed):
            p, _ = ensemble.averaged_probs(members, store, torch.from_numpy(idx), 16, tables)
            probs[idx[idx >= 0]] = p.numpy()[idx >= 0]
        score = ensemble.run_ensemble_eval(dcfg, ds, CPU, logger)
    finally:
        logger.close()
    return ranks, log, probs, score


def test_each_entry_is_scored_once_with_the_replicated_probabilities(runs):
    ranks, _, want, _ = runs
    seen = np.zeros(len(want), int)
    for rec in ranks:
        entries, probs = rec["entries"], rec["probs"]
        ok = entries >= 0
        seen[entries[ok]] += 1
        np.testing.assert_allclose(probs[ok], want[entries[ok]], rtol=0, atol=1e-5)
    assert (seen == 1).all(), seen


def test_the_sharded_score_equals_the_replicated_score(runs):
    ranks, log, _, score = runs
    assert score > 0.0
    for rec in ranks:
        assert float(rec["score"]) == pytest.approx(score, rel=1e-6)
    assert "data=sharded" in log
