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
  steps run eagerly;
- the phase marks (ops/kernels/marks.py::mark) of an eager train step, in
  order, for B1 (butd), B2 (spatial) and --grad_accum 2; none in an eval
  step; csrc/marks.cu's kernels are the module's marks, none named like B1
  or B2;
- the set-up totals (`init`, `upload`) and the `[setup]` log line, the
  `upload` span in an epoch trace;
- the benchmark's phase and set-up readers (regat_bench/phases.py) on a
  synthetic trace against hand-computed values, and the program's own
  `phase_ns` (profile_step's) against the same.
"""

import json
import os
import re
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from regat_bench import kernels, manifest, tracing
from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.store import DeviceStore
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.ops.kernels import build, marks
from tf_vqa_regat_tpu_torch.params import load_npz
from tf_vqa_regat_tpu_torch.train import checkpoint as ckpt
from tf_vqa_regat_tpu_torch.train import profiling
from tf_vqa_regat_tpu_torch.train.loop import run_training
from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
from tf_vqa_regat_tpu_torch.train.profiling import annotate, trace_epoch
from tf_vqa_regat_tpu_torch.train.step import EvalSteps, TrainSteps

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


# ---- phase marks, set-up counters and their readers -------------------------

def _steps_on(cfg, train):
    """A model, its optimizer and its eager TrainSteps over a CPU store."""
    model = ReGAT(cfg, train.ntoken, V_DIM, NUM_ANS)
    opt = Adamax(model, trainable_mask(model, False),
                 make_lr_schedule(cfg.base_lr, 4, cfg.lr_decay_rate, cfg.lr_decay_step),
                 cfg.grad_clip)
    store = DeviceStore(train, CPU, include_adj=cfg.relation_type != "implicit")
    return model, store, TrainSteps(model, opt, cfg, CPU, store)


@pytest.mark.parametrize("relation_type,grad_accum", [
    ("implicit", 1), ("spatial", 1), ("implicit", 2)])
def test_train_step_marks_its_phases_in_order(tmp_path, relation_type, grad_accum):
    """One eager train step marks gather, then per microbatch forward and
    backward with one B1 (implicit) or B2 (spatial) backward pair per
    direction inside, then optimizer and end."""
    cfg = _tiny_cfg(tmp_path, relation_type=relation_type, grad_accum=grad_accum, dir_num=2)
    train, _ = _splits()
    model, store, steps = _steps_on(cfg, train)
    assert len(model.v_relation.gatt.neighbor) == 2
    idx = next(store.epoch_indices(0, cfg.batch_size, True, cfg.seed))
    with marks.recording() as names:
        m = steps.block(cfg.num_rois, idx[None, :], 1)
    kernel = "b1" if relation_type == "implicit" else "b2"
    pair = [f"{kernel}_backward_begin", f"{kernel}_backward_end"]
    assert names == (["gather"] + (["forward", "backward"] + pair * 2) * grad_accum
                     + ["optimizer", "end"])
    assert float(m["n"]) == cfg.batch_size


def test_eval_steps_and_no_recording_mark_nothing(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    train, val = _splits()
    model = ReGAT(cfg, train.ntoken, V_DIM, NUM_ANS)
    store = DeviceStore(val, CPU, include_adj=False)
    blk = next(store.epoch_indices(0, 8, False, cfg.seed))[None, :]
    with marks.recording() as names:
        EvalSteps(model, CPU, store).block(cfg.num_rois, blk)
    assert names == []
    marks.mark("gather", CPU)  # outside a recording: nothing, no error
    with pytest.raises(ValueError, match="no phase mark"):
        marks.mark("gahter", CPU)


def test_mark_kernels_are_the_modules_marks():
    """csrc/marks.cu declares one kernel per mark, in the module's order,
    and no mark's kernel matches the benchmark's B1 or B2 kernel tests."""
    source = (build.CSRC_DIR / "marks.cu").read_text()
    declared = re.findall(r"__global__ void (regat_mark_\w+)\(\)", source)
    assert declared == [marks.MARK_PREFIX + n for n in marks.MARKS]
    listed = re.search(r"kNames\[\] = \{(.*?)\};", source, re.S).group(1)
    assert re.findall(r'"(\w+)"', listed) == list(marks.KERNELS)
    assert marks.KERNELS[:len(declared)] == tuple(declared)
    for name in declared:
        assert not (kernels.is_b1_train(name) or kernels.is_b1_eval(name)
                    or kernels.is_b2(name))


def test_setup_totals_count_init_and_upload(tmp_path):
    before_s, before_n = profiling.setup_seconds(), profiling.setup_calls()
    cfg = _tiny_cfg(tmp_path)
    train, _ = _splits()
    ReGAT(cfg, train.ntoken, V_DIM, NUM_ANS)
    DeviceStore(train, CPU, include_adj=False)
    after_s, after_n = profiling.setup_seconds(), profiling.setup_calls()
    for name in ("init", "upload"):
        assert after_s[name] > before_s.get(name, 0.0)
        assert after_n[name] == before_n.get(name, 0) + 1
    assert manifest.reader("init_s.setup").read(None) == after_s["init"]
    assert manifest.reader("upload_s.setup").read(None) == after_s["upload"]
    assert manifest.reader("capture_s.setup").read(None) == after_s.get("capture")


def test_setup_line_and_upload_span_in_a_run(tmp_path):
    cfg = _tiny_cfg(tmp_path, profile_dir=str(tmp_path / "traces"))
    _train(cfg)
    log = (tmp_path / "log.txt").read_text()
    line = next(ln for ln in log.splitlines() if ln.startswith("[setup]"))
    assert re.fullmatch(r"\[setup\] model init \d+\.\d{3} s, tables upload \d+\.\d{3} s, "
                        r"warm-up and capture 0\.000 s \(0 graphs\)", line), line
    assert log.count("[setup]") == 1
    names = [e.get("name") for e in _events(_tree_files(str(tmp_path / "traces"))[0])]
    assert names.count("upload") == 4 and names.count("step") == 4


P = marks.MARK_PREFIX
# two marked steps in one train pass [0, 1000): (name, start, end) in ns. In
# step 1 two kernels of `forward` overlap ([12, 30) and [20, 40): 28 ns busy);
# step 2 has a B1 pair in each direction and an idle gap inside `backward`
STEP_1 = [(P + "gather", 0, 2), ("gather_kernel", 2, 10), (P + "forward", 10, 12),
          ("gemm", 12, 30), ("gemm", 20, 40), (P + "backward", 40, 42), ("gemm", 42, 50),
          (P + "b1_backward_begin", 50, 52), ("einsum", 52, 60), (P + "b1_backward_end", 60, 62),
          ("add", 62, 70), (P + "optimizer", 70, 72), ("adamax", 72, 80), (P + "end", 80, 82)]
STEP_2 = [(P + "gather", 100, 102), ("gather_kernel", 102, 106), (P + "forward", 106, 108),
          ("gemm", 108, 148), (P + "backward", 148, 150),
          (P + "b1_backward_begin", 150, 152), ("einsum", 152, 170), (P + "b1_backward_end", 170, 172),
          (P + "b1_backward_begin", 200, 202), ("einsum", 202, 212), (P + "b1_backward_end", 212, 214),
          (P + "optimizer", 214, 216), ("adamax", 216, 236), (P + "end", 236, 238)]
# ms per step: ((step 1 + step 2) ns) / 2 / 1e6; backward counts the B1 marks
# inside it (busy device time) and not step 2's gap [172, 200)
WANT = {"gather_ms.train": (8 + 4) / 2e6, "forward_ms.train": (28 + 40) / 2e6,
        "backward_ms.train": (28 + (2 + 18 + 2) + (2 + 10 + 2)) / 2e6,
        "optimizer_ms.train": (8 + 20) / 2e6, "b1_backward_ms.train": (8 + 18 + 10) / 2e6}


def _record(ops):
    trace = tracing.Trace(CPU)
    trace.spans = [("train_pass", 0, 230), ("eval_pass", 300, 400)]
    # the pass's last mark lies past its host span: the card's clock runs a
    # few microseconds late against the host's, and every mark counts
    trace.device_ops = list(ops) + [("eval_kernel", 300, 390)]
    return tracing.Record({"name": "butd.train"}, {}, {}, 1,
                          counters={"traced_train_steps": 2}, trace=trace)


@pytest.mark.parametrize("metric", sorted(WANT) + ["b2_backward_ms.train"])
def test_phase_readers_on_a_synthetic_trace(metric):
    read = manifest.reader(metric).read
    got = read(_record(STEP_2[::-1] + STEP_1))  # any order: the readers sort by start
    if metric == "b2_backward_ms.train":
        assert got is None  # no B2 pair in the trace
    else:
        assert got == pytest.approx(WANT[metric], rel=1e-12)
    # a record the profiler lost (a step's end, a pair's end, a forward):
    # the marks make no whole steps, nothing is read
    for lost in ((P + "end", 236, 238), (P + "b1_backward_end", 60, 62), (P + "forward", 10, 12)):
        assert read(_record([op for op in STEP_1 + STEP_2 if op != lost])) is None
    # a program without marks, or no trace, reads None
    assert read(_record([op for op in STEP_1 + STEP_2 if not op[0].startswith(P)])) is None
    assert read(tracing.Record({}, {}, {}, 1)) is None


def test_program_phase_ns_agrees_with_the_readers():
    steps, ns = profiling.phase_ns(STEP_1 + STEP_2)
    assert steps == 2
    for metric, want in WANT.items():
        assert ns[metric.split("_ms")[0]] / steps / 1e6 == pytest.approx(want, rel=1e-12)
    assert ns["b2_backward"] == 0 and ns["reduce"] == 0
    assert profiling.union_ns([(0, 10), (5, 20), (30, 31), (30, 30)]) == 21
