"""Data parallelism through the port's entry point on the CPU:
`python -m tf_vqa_regat_tpu_torch.main --device cpu` as 1 and as 2 gloo
processes (the REGAT_* environment, tests/torch_mp_util.py), at small
widths with --dropout 0:

- `--data_mode device`: train (2 epochs) then predict; the per-epoch
  metrics.jsonl rows of 1 and 2 processes equal at rtol 1e-5 (the gradient
  sums added in another order), the predictions JSON equal, the two ranks'
  final parameters bit-identical, and every file (log.txt, metrics.jsonl,
  each checkpoint directory, meta.json, the final .npz, predict_log.txt, the
  predictions) written once, by rank 0;
- `--data_mode sharded` (configs/butd_vqa.json, B1's plain version) at 2
  processes: train, then eval and predict: the final parameters and every
  epoch's metrics against the same two ranks run in this process
  (ShardedDeviceStore per rank, `grad_sums`, the sums added, `apply_sums`),
  which tests/test_torch_dp_step.py holds to JAX's dp = 2 step; the eval
  loss equal to the run's last; every question answered once;
- `--data_mode sharded` under configs/semantic_vqa.json (B2's plain
  version, the sharded semantic adjacency), and under butd with
  `--roi_buckets 12,16 --train_block 2`, at 2 processes: as above;
- `--data_mode host` at 2 processes (each rank packing its rows) equals the
  device path at 2 processes bit for bit.

Tolerances: 1 vs 2 processes rtol 1e-5 (metrics; their parameters are not
compared: Adamax moves a leaf whose true gradient is zero, a bias before a
softmax, by about lr times the sign of its rounding noise, which the order
of the sums sets), the sharded runs and the
in-process ranks rtol 1e-6 / atol 1e-7 (the same operations on the same
rows), the ranks of one run exactly equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from torch_mp_util import record, run_ranks
from tf_vqa_regat_tpu_torch.data.sharded_store import ShardedDeviceStore
from tf_vqa_regat_tpu_torch.data.store import gather_batch
from tf_vqa_regat_tpu_torch.main import build_dataset, parse
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.parallel.mesh import batch_slice
from tf_vqa_regat_tpu_torch.train import step as tstep
from tf_vqa_regat_tpu_torch.train.loop import (
    _block_batches_counted,
    resolve_train_block,
    train_batch_stream,
)
from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
WIDTHS = ["--num_hid", "32", "--relation_dim", "48", "--num_heads", "4", "--nongt_dim", "6",
          "--imp_pos_emb_dim", "16"]
SMALL = [*WIDTHS, "--num_rois", "16", "--synthetic", "--synthetic_train_size", "40",
         "--synthetic_val_size", "20", "--batch_size", "16", "--print_freq", "0",
         "--device", "cpu", "--no-async_checkpoint", "--dropout", "0", "--epochs", "2"]
METRICS = ("epoch", "lr", "train_loss", "train_score", "eval_score", "eval_loss")


def argv(config, out, *extra):
    return ["--config", os.path.join(REPO, "configs", config), *SMALL, "--output",
            str(out) + "/", *extra]


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        return [{k: json.loads(line)[k] for k in METRICS} for line in fh]


def _rank_params(out, command, rank):
    with np.load(os.path.join(out, f"params-{command}-rank{rank}.npz")) as z:
        return dict(z)


def _commands(config, out, mode_flags, npz):
    train = argv(config, out, "--mode", "train", *mode_flags)
    after = argv(config, out, *mode_flags, "--checkpoint", os.path.join(out, npz))
    return [{"argv": train}, {"argv": after + ["--mode", "eval"]},
            {"argv": after + ["--mode", "predict"]}]


@pytest.fixture(scope="module")
def device_runs(tmp_path_factory):
    runs = {}
    for nproc in (1, 2):
        out = str(tmp_path_factory.mktemp(f"device{nproc}"))
        run_ranks(nproc, _commands("butd_vqa.json", out, ["--data_mode", "device"],
                                   "implicit-butd-pretrained_model.npz"), out)
        runs[nproc] = out
    return runs


def _predictions(out, name="implicit-butd"):
    with open(os.path.join(out, f"{name}-val-predictions.json")) as fh:
        return json.load(fh)


def test_one_and_two_processes_agree(device_runs):
    one, two = (_metrics(device_runs[n]) for n in (1, 2))
    assert len(one) == len(two) == 2
    for a, b in zip(one, two):
        for k in METRICS:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    assert _predictions(device_runs[2]) == _predictions(device_runs[1])
    ranks = [_rank_params(device_runs[2], 0, r) for r in (0, 1)]
    for key, v in ranks[0].items():
        np.testing.assert_array_equal(v, ranks[1][key], err_msg=key)


def test_the_host_path_at_two_processes_equals_the_device_path(device_runs, tmp_path):
    """Each rank packs its rows of every global batch on the host: the run
    equals the device path's at 2 processes bit for bit."""
    out = str(tmp_path)
    run_ranks(2, _commands("butd_vqa.json", out, ["--data_mode", "host"],
                           "implicit-butd-pretrained_model.npz"), out)
    assert _metrics(out) == _metrics(device_runs[2])
    assert _predictions(out) == _predictions(device_runs[2])
    for r in (0, 1):
        host, device = _rank_params(out, 0, r), _rank_params(device_runs[2], 0, r)
        for key, v in device.items():
            np.testing.assert_array_equal(host[key], v, err_msg=key)
    with open(os.path.join(out, "log.txt")) as fh:
        assert "[data] data=host (--data_mode host)" in fh.read()


def test_rank_zero_writes_each_file_once(device_runs):
    out = device_runs[2]
    for command, want in ((0, {("open", "log.txt"), ("open", "metrics.jsonl"),
                               ("dir", "epoch_0000"), ("dir", "epoch_0001"),
                               ("meta", "epoch_0000"), ("meta", "epoch_0001"),
                               ("final", "implicit-butd-pretrained_model.npz")}),
                          (1, {("open", "eval_log.txt")}),
                          (2, {("open", "predict_log.txt"),
                               ("open", "implicit-butd-val-predictions.json")})):
        writes = [tuple(w) for w in record(out, command, 0)["writes"]]
        assert want <= set(writes) and len(writes) == len(set(writes)), writes
        assert all(k == "dir" and n == "best" for k, n in set(writes) - want), writes
        assert record(out, command, 1)["writes"] == []
    # eval on both ranks reads the run's last eval loss
    eval_loss = _metrics(out)[-1]["eval_loss"]
    assert [record(out, 1, r)["result"][1] for r in (0, 1)] == [eval_loss] * 2


def _in_process_ranks(config, out, extra=()):
    """The sharded run's two ranks in this process -> (final parameters of
    each rank, per-epoch (train loss, train score)), through the functions
    the entry point's step runs, over its blocked stream (under roi buckets
    the optimizer meets a block's same-R batches in a row)."""
    cfg = parse(argv(config, out, "--mode", "train", "--data_mode", "sharded", *extra))[0]
    K = resolve_train_block(cfg, "sharded")
    train = build_dataset(cfg, "train")
    ranks = []
    for r in range(2):
        store = ShardedDeviceStore(train, CPU, r, 2,
                                   include_adj=cfg.relation_type == "semantic")
        model = ReGAT(cfg, train.ntoken, train.v_dim, train.num_ans)
        N = store.steps_per_epoch(cfg.batch_size)
        sched = make_lr_schedule(cfg.base_lr, N, cfg.lr_decay_rate, cfg.lr_decay_step)
        opt = Adamax(model, trainable_mask(model, False), sched, cfg.grad_clip)
        ranks.append((store, model, opt, tstep.FlatSums(opt.params, CPU)))
    epochs = []
    for epoch in range(cfg.epochs):
        loss_sum = score = n = 0.0
        stream = _block_batches_counted(train_batch_stream(cfg, ranks[0][0], epoch), K,
                                        cfg.batch_size)
        for R, idx in ((R, blk[j]) for R, blk, nreal in stream for j in range(nreal)):
            for r, (store, model, opt, sums) in enumerate(ranks):
                batch = gather_batch(store, torch.from_numpy(batch_slice(idx, r, 2)).long(), R)
                sums.write(*tstep.grad_sums(model, opt.params, batch, opt.count, cfg.seed,
                                            cfg.grad_accum, rank=r))
            total = ranks[0][3].flat + ranks[1][3].flat
            for store, model, opt, sums in ranks:
                sums.flat.copy_(total)
                m = tstep.apply_sums(opt, sums)
            loss_sum += float(m["loss"] * m["n"])
            score += float(m["score"])
            n += float(m["n"])
        epochs.append((loss_sum / n, 100.0 * score / n))
    params = [{n: p.detach().numpy() for n, p in model.named_parameters()}
              for _, model, _, _ in ranks]
    return params, epochs


@pytest.mark.parametrize("config,name,extra", [
    ("butd_vqa.json", "implicit-butd", []),
    ("semantic_vqa.json", "semantic-butd", []),
    ("butd_vqa.json", "implicit-butd", ["--roi_buckets", "12,16", "--train_block", "2"]),
], ids=["butd", "semantic", "butd-roi_buckets"])
def test_a_sharded_run_equals_its_ranks_in_one_process(tmp_path, config, name, extra):
    out = str(tmp_path)
    run_ranks(2, _commands(config, out, ["--data_mode", "sharded", *extra],
                           f"{name}-pretrained_model.npz"), out)
    want_params, want_epochs = _in_process_ranks(config, out, extra)
    got = [_rank_params(out, 0, r) for r in (0, 1)]
    for key, v in want_params[0].items():
        np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
        np.testing.assert_allclose(got[0][key], v, rtol=1e-6, atol=1e-7, err_msg=key)
    metrics = _metrics(out)
    for row, (loss, score) in zip(metrics, want_epochs):
        np.testing.assert_allclose(row["train_loss"], loss, rtol=1e-6)
        np.testing.assert_allclose(row["train_score"], score, rtol=1e-6, atol=1e-9)
    with open(os.path.join(out, "log.txt")) as fh:
        assert "[data] data=sharded (--data_mode sharded)" in fh.read()
    assert [record(out, 1, r)["result"][1] for r in (0, 1)] == [metrics[-1]["eval_loss"]] * 2
    preds = _predictions(out, name)
    assert sorted(p["question_id"] for p in preds) == list(range(20))
