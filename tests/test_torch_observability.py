"""The port's observability flags on the CPU (counterpart of JAX's
tests/test_observability.py): profiling traces (train/profiling.py) and NaN
debugging (train/debug_nans.py), through `run_training` at tiny widths:

- `trace_epoch` writes a non-empty Chrome trace under `epoch_0003/` holding
  an `annotate` span;
- --profile_dir traces the training epoch to `epoch_0000/`, with the loop's
  `data` and `step` spans;
- --profile_port answers `GET /capture?duration_ms=N` with the path of a
  trace that exists and holds `step` spans; a port in use fails the run,
  naming --profile_port;
- --debug_nans with every feature poisoned raises FloatingPointError naming
  a module, and an async checkpoint write issued before the raise is
  complete on disk; a clean --debug_nans run gives the per-epoch metrics of
  a run without the flag exactly (both eager on the CPU), and logs why its
  steps run eagerly.
"""

import json
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.params import load_npz
from tf_vqa_regat_tpu_torch.train import checkpoint as ckpt
from tf_vqa_regat_tpu_torch.train import profiling
from tf_vqa_regat_tpu_torch.train.loop import run_training
from tf_vqa_regat_tpu_torch.train.profiling import annotate, trace_epoch
from tf_vqa_regat_tpu_torch.train.step import TrainSteps

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
V_DIM, NUM_ANS = 24, 7


def _tiny_cfg(tmp_path, **kw):
    base = dict(
        num_hid=32, relation_dim=48, num_heads=4, nongt_dim=6, imp_pos_emb_dim=16,
        fusion="butd", relation_type="implicit", residual_connection=True, adaptive=True,
        num_rois=12, epochs=1, batch_size=16, print_freq=100, train_block=1,
        output=str(tmp_path) + "/", save_every_epoch=False,
    )
    base.update(kw)
    return Config(**base)


def _splits():
    train = synthetic_dataset(num_images=8, num_questions=64, v_dim=V_DIM, num_ans=NUM_ANS)
    val = synthetic_dataset(num_images=4, num_questions=16, v_dim=V_DIM, num_ans=NUM_ANS,
                            seed=1)
    return train, val


def _train(cfg, train=None, val=None):
    if train is None:
        train, val = _splits()
    model = ReGAT(cfg, train.ntoken, V_DIM, NUM_ANS)
    return run_training(cfg, train, val, model, CPU)


def _events(path):
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def _tree_files(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]


def test_trace_epoch_writes_nonempty_trace(tmp_path):
    with trace_epoch(str(tmp_path), 3):
        with annotate("smoke"):
            x = torch.ones(8, 8)
            (x @ x).sum().item()
    files = _tree_files(str(tmp_path / "epoch_0003"))
    assert files and all(os.path.getsize(f) > 0 for f in files)
    assert "smoke" in {e.get("name") for e in _events(files[0])}
    with trace_epoch("", 0):  # off: nothing written
        pass


def test_profile_dir_flag_traces_training_epoch(tmp_path):
    cfg = _tiny_cfg(tmp_path, profile_dir=str(tmp_path / "traces"))
    _, best = _train(cfg)
    assert np.isfinite(best)
    files = _tree_files(str(tmp_path / "traces" / "epoch_0000"))
    assert files and all(os.path.getsize(f) > 0 for f in files)
    names = [e.get("name") for e in _events(files[0])]
    assert names.count("step") == 4 and names.count("data") >= 4


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_profile_port_capture_answers_with_a_trace(tmp_path, monkeypatch):
    """A capture requested during the first step: the loop starts the
    profiler at the next boundary and stops it at the one after."""
    servers, replies = [], []
    real_server, real_step = profiling.maybe_start_server, TrainSteps.step

    def server(*a, **k):
        servers.append(real_server(*a, **k))
        return servers[-1]

    def get(url):
        with urllib.request.urlopen(url, timeout=60) as r:
            replies.append((r.status, json.loads(r.read())))

    def step(self, R, inputs):
        if not replies and not any(t.name == "capture" for t in threading.enumerate()):
            url = f"http://127.0.0.1:{servers[0].port}/capture?duration_ms=1"
            threading.Thread(target=get, args=(url,), name="capture", daemon=True).start()
            deadline = time.time() + 30
            while servers[0].requests.empty() and time.time() < deadline:
                time.sleep(0.01)
        return real_step(self, R, inputs)

    monkeypatch.setattr(profiling, "maybe_start_server", server)
    monkeypatch.setattr(TrainSteps, "step", step)
    port = _free_port()
    _train(_tiny_cfg(tmp_path, profile_port=port))
    for t in threading.enumerate():
        if t.name == "capture":
            t.join(timeout=30)
    assert len(replies) == 1
    status, body = replies[0]
    assert status == 200 and body["steps"] >= 1
    assert body["trace"].startswith(str(tmp_path / "profile"))
    assert os.path.getsize(body["trace"]) > 0
    assert "step" in {e.get("name") for e in _events(body["trace"])}
    # the endpoint is gone with the run; a port in use fails the next one
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen(1)
        with pytest.raises(RuntimeError, match="--profile_port"):
            _train(_tiny_cfg(tmp_path, profile_port=busy.getsockname()[1]))


def test_debug_nans_flag_raises_on_injected_nan(tmp_path):
    """Poisoned region features raise instead of training on NaNs."""
    train, val = _splits()
    train.store.features[:] = np.nan
    with pytest.raises(FloatingPointError, match="module"):
        _train(_tiny_cfg(tmp_path, debug_nans=True), train, val)


def test_debug_nans_keeps_an_issued_async_checkpoint(tmp_path, monkeypatch):
    """A step checkpoint written in the background when the second step
    meets poisoned features: the write completes before the error leaves
    run_training."""
    train, val = _splits()
    real_step, real_write = TrainSteps.step, ckpt._write_dir
    calls = []

    def step(self, R, inputs):
        calls.append(R)
        if len(calls) == 2:  # the store is on the CPU: poison it in place
            self.store.images.features.fill_(float("nan"))
        return real_step(self, R, inputs)

    def slow_write(*a, **k):
        time.sleep(0.5)
        real_write(*a, **k)

    monkeypatch.setattr(TrainSteps, "step", step)
    monkeypatch.setattr(ckpt, "_write_dir", slow_write)
    cfg = _tiny_cfg(tmp_path, debug_nans=True, checkpoint_every_steps=1)
    with pytest.raises(FloatingPointError):
        _train(cfg, train, val)
    latest = ckpt.latest_checkpoint(cfg.output)
    assert latest is not None and latest.endswith("epoch_0000_step_00000001")
    assert load_npz(os.path.join(latest, ckpt.STATE_FILE))
    assert ckpt.restore_meta_full(cfg.output)["step_in_epoch"] == 1


def test_debug_nans_clean_run_equals_plain_run(tmp_path):
    metrics = {}
    for flag in (False, True):
        out = tmp_path / str(flag)
        _train(_tiny_cfg(out, debug_nans=flag, epochs=2))
        with open(out / "metrics.jsonl") as fh:
            metrics[flag] = [json.loads(line) for line in fh]
        log = (out / "log.txt").read_text()
        assert ("[eager] --debug_nans" in log) == flag
    for a, b in zip(metrics[False], metrics[True]):
        for k in ("train_loss", "train_score", "eval_loss", "eval_score"):
            assert a[k] == b[k], k
