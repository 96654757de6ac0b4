"""The port's entry point on the CPU (`--device cpu`), at small widths:
`--mode train` writes the log, one metrics line per epoch and the final
`.npz`; `--mode eval` on that file reproduces the last eval loss exactly;
`--mode serve` loads it; flags of unported features are refused."""

import json
import os

import pytest

from tf_vqa_regat_tpu_torch.main import build_server, final_model_path, main, parse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = [
    "--config", os.path.join(REPO, "configs", "butd_vqa.json"), "--num_hid", "64", "--relation_dim", "96",
    "--num_heads", "4", "--nongt_dim", "10", "--num_rois", "24", "--synthetic",
    "--synthetic_val_size", "32", "--batch_size", "16", "--print_freq", "2",
    "--device", "cpu",
]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("train"))
    argv = SMALL + ["--mode", "train", "--epochs", "2", "--synthetic_train_size", "64",
                    "--output", out]
    path = main(argv)
    return out, path


def test_train_writes_log_metrics_and_model(trained):
    out, path = trained
    assert path == final_model_path(parse(SMALL + ["--output", out])[0])
    assert path.endswith("implicit-butd-pretrained_model.npz")
    with open(f"{out}/metrics.jsonl") as fh:
        lines = [json.loads(line) for line in fh]
    assert [m["epoch"] for m in lines] == [0, 1]
    assert lines[1]["train_loss"] < lines[0]["train_loss"]
    with open(f"{out}/log.txt") as fh:
        log = fh.read()
    assert "optim: adamax lr=0.0009" in log
    assert log.count("[DEBUG] train_score:") == 2 and "Epoch [2][3/4]" in log


def test_eval_reproduces_the_last_eval_loss(trained, capsys):
    out, path = trained
    score, loss = main(SMALL + ["--mode", "eval", "--checkpoint", path, "--output", out])
    with open(f"{out}/metrics.jsonl") as fh:
        last = [json.loads(line) for line in fh][-1]
    assert loss == last["eval_loss"] and score == last["eval_score"]
    assert f"(eval loss {last['eval_loss']!r})" in capsys.readouterr().out


def test_serve_loads_the_trained_model(trained):
    out, path = trained
    server, batcher, engine = build_server(
        SMALL + ["--mode", "serve", "--checkpoint", path, "--serve_port", "0",
                 "--serve_batch_sizes", "1"]
    )
    try:
        answer = engine.infer(["what color is the cat ?"], [3])[0]
        assert answer["answer"] in engine.ds.label2ans
        assert 0.0 < answer["confidence"] < 1.0
    finally:
        batcher.close()
        server.server_close()


@pytest.mark.parametrize("flag", [["--grad_accum", "2"], ["--resume"]])
def test_unported_training_flags_are_refused(flag):
    with pytest.raises(SystemExit):
        parse(SMALL + ["--mode", "train"] + flag)
