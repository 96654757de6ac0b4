"""The port's entry point on the CPU (`--device cpu`), at small widths, for
configs/butd_vqa.json, ban_vqa.json and mutan_vqa_cp.json (MuTAN at rank 3,
with and without `--mutan_shared_qdrop`): `--mode train` writes the log, one
metrics line per epoch and the final `.npz`; `--mode eval` on that file
reproduces the last eval loss exactly; `--mode serve` loads it and answers a
/predict over HTTP; flags of unported features are refused;
`--no-fold_dual_attention` parses and changes nothing. (bf16 with BAN and
MuTAN: tests/test_torch_bf16_fusions.py.)"""

import json
import os
import threading
import urllib.request

import pytest
import torch

from tf_vqa_regat_tpu_torch.main import build_server, final_model_path, main, parse

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = [
    "--num_hid", "64", "--relation_dim", "96", "--num_heads", "4", "--nongt_dim", "10",
    "--num_rois", "24", "--synthetic", "--synthetic_val_size", "32", "--batch_size", "16",
    "--print_freq", "2", "--device", "cpu",
]
SMALL = ["--config", os.path.join(REPO, "configs", "butd_vqa.json")] + WIDTHS
RUNS = {
    "butd": SMALL,
    "ban": ["--config", os.path.join(REPO, "configs", "ban_vqa.json"), *WIDTHS],
    "mutan": ["--config", os.path.join(REPO, "configs", "mutan_vqa_cp.json"), *WIDTHS,
              "--mutan_rank", "3"],
    "mutan_shared_qdrop": ["--config", os.path.join(REPO, "configs", "mutan_vqa_cp.json"),
                           *WIDTHS, "--mutan_rank", "3", "--mutan_shared_qdrop"],
}


@pytest.fixture(scope="module", params=list(RUNS))
def trained(request, tmp_path_factory):
    """(argv of the run's widths, output dir, written .npz)."""
    small = RUNS[request.param]
    out = str(tmp_path_factory.mktemp("train"))
    argv = small + ["--mode", "train", "--epochs", "2", "--synthetic_train_size", "64",
                    "--output", out]
    path = main(argv)
    return small, out, path


def test_train_writes_log_metrics_and_model(trained):
    small, out, path = trained
    cfg = parse(small + ["--output", out])[0]
    assert path == final_model_path(cfg)
    assert path.endswith(f"implicit-{cfg.fusion}-pretrained_model.npz")
    with open(f"{out}/metrics.jsonl") as fh:
        lines = [json.loads(line) for line in fh]
    assert [m["epoch"] for m in lines] == [0, 1]
    assert lines[1]["train_loss"] < lines[0]["train_loss"]
    with open(f"{out}/log.txt") as fh:
        log = fh.read()
    assert "optim: adamax lr=0.0009" in log
    assert log.count("[DEBUG] train_score:") == 2 and "Epoch [2][3/4]" in log


def test_eval_reproduces_the_last_eval_loss(trained, capsys):
    small, out, path = trained
    score, loss = main(small + ["--mode", "eval", "--checkpoint", path, "--output", out])
    with open(f"{out}/metrics.jsonl") as fh:
        last = [json.loads(line) for line in fh][-1]
    assert loss == last["eval_loss"] and score == last["eval_score"]
    assert f"(eval loss {last['eval_loss']!r})" in capsys.readouterr().out


def test_serve_loads_the_trained_model(trained):
    small, out, path = trained
    server, batcher, engine = build_server(
        small + ["--mode", "serve", "--checkpoint", path, "--serve_port", "0",
                 "--serve_batch_sizes", "1"]
    )
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        image_id = sorted(engine.img_index)[3]
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/predict",
            data=json.dumps({"question": "what color is the cat ?", "image_id": image_id}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            answer = json.loads(r.read())
        assert answer["answer"] in engine.ds.label2ans
        assert 0.0 < answer["confidence"] < 1.0
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.mark.parametrize("flag,error", [(["--dp_size", "2"], SystemExit),
                                        (["--data_mode", "sharded"], ValueError)])
def test_unported_training_flags_are_refused(flag, error):
    """A flag of a feature not ported is refused by the parser; the
    data-parallel value of a ported flag by the config."""
    with pytest.raises(error):
        parse(SMALL + ["--mode", "train"] + flag)


def test_no_fold_dual_attention_changes_nothing(trained, capsys):
    """A valid JAX flag that has no effect in the port (config.py): the eval
    of the trained model gives the same loss and score bit for bit."""
    small, out, path = trained
    assert parse(small + ["--no-fold_dual_attention"])[0].fold_dual_attention is False
    argv = small + ["--mode", "eval", "--checkpoint", path, "--output", out]
    assert main(argv + ["--no-fold_dual_attention"]) == main(argv)
