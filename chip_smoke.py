#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py        # from the root of a checkout

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA kernel of the serve path from csrc/ (timed);
  3. each kernel against its plain PyTorch version on the card, at the serve
     shapes (b = 1, 8, 32; R=100, H=16, dh=o=64, n=20, P=64), with key masks
     from random box counts in 10-100, one fully masked example and one row
     whose other heads underflow; max abs difference, and per-call times
     (CUDA events around 10 back-to-back calls, median of 25 rounds taken
     in turns with the plain version);
  4. `--mode serve` at the full widths of configs/butd_vqa.json (random
     weights from a seed, written as .npz), built by `main.build_server` as
     the entry point builds it, serving HTTP in a thread: /healthz, single
     and batch /predict, an unknown image (404); the kernel's launches over
     those requests must be 2 per forward pass (one per direction), and one
     batch's logits must match the same model run with the plain versions.
Then it prints {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
It imports nothing of JAX and nothing of the JAX package (tf_vqa_regat_tpu).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
# Stated tolerances (f32 throughout; TF32 is switched off below):
# - kernel vs plain: the two sum the pos-FC dot (64 terms) in different
#   orders, and log(max(relu(x), 1e-6)) turns that ulp-level difference in a
#   small positive x into a relative one: on an H100 the largest difference
#   at b=32 (3.8e-4) sat in a head whose only positive pos-FC outputs were
#   1.2e-4 and 4.6e-3. Away from such heads the two agree to ~1e-5.
KERNEL_ATOL = 1e-3
# - logits, kernel path vs plain path through the whole model, relative to
#   the largest |logit| (a random model's logits are ~1e-4): the attention
#   difference passes through the BUTD and classifier matmuls.
LOGITS_RTOL = 1e-3
SERVE_SHAPES = dict(R=100, H=16, dh=64, o=64, n=20, P=64)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def median_ms_interleaved(fns, reps=25, calls=10, warmup=3):
    """Per-call time of each function: CUDA events around `calls`
    back-to-back calls, median over `reps` rounds, the functions taking
    turns round by round."""
    import torch

    for _ in range(warmup):
        for f in fns:
            f()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for i, f in enumerate(fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                f()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / calls)
    return [statistics.median(t) for t in times]


def kernel_inputs(b, device, seed):
    """Serve-shaped inputs for one direction of the implicit attention."""
    import torch

    from tf_vqa_regat_tpu_torch.ops.position import position_matrix

    s = SERVE_SHAPES
    R, H, dh, o, n, P = s["R"], s["H"], s["dh"], s["o"], s["n"], s["P"]
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=device)

    xy = torch.rand(b, R, 2, generator=g, device=device) * 450
    wh = torch.rand(b, R, 2, generator=g, device=device) * 190 + 4
    num_boxes = torch.randint(10, 101, (b,), generator=g, device=device)
    if b > 1:
        num_boxes[-1] = 0  # a padded serve slot: every key masked
    q = randn(b, R, H, dh)
    k = randn(b, n, H, dh)
    # one row whose head 0 outscores every other head by ~500: those heads
    # underflow against the row max and must get all-zero weights
    k[0, :, 0, :] = 8.0
    q[0, 7, 0, :] = 8.0
    return dict(
        q=q, k=k, vw=randn(b, n, H, o),
        pos_mat=position_matrix(torch.cat([xy, xy + wh], -1), n).contiguous(),
        w_pos=randn(P, H, scale=0.2), b_pos=randn(H, scale=0.5),
        key_mask=torch.arange(n, device=device)[None, :] < num_boxes[:, None],
    )


def check_kernels(device):
    """Kernel vs plain at b = 1, 8, 32. Returns per-b rows."""
    import torch

    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

    rows = []
    for b in (1, 8, 32):
        x = kernel_inputs(b, device, seed=b)
        args = [x[k] for k in ("q", "k", "vw", "pos_mat", "w_pos", "b_pos", "key_mask")]
        got = ia.fused_implicit_graph_attention(*args)
        want = ia.implicit_attention_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"kernel output not finite at b={b}")
        err = (got - want).abs().max().item()
        zero_heads = got[0, 7, 1:].abs().max().item()
        masked_err = (
            (got[-1] - x["vw"][-1].mean(0)[None]).abs().max().item() if b > 1 else 0.0
        )
        ms, plain_ms = median_ms_interleaved(
            [lambda: ia.fused_implicit_graph_attention(*args),
             lambda: ia.implicit_attention_plain(*args)]
        )
        row = dict(b=b, max_abs_err=err, underflow_heads_max=zero_heads,
                   fully_masked_err=masked_err, ms=ms, plain_ms=plain_ms)
        print("kernel implicit_attention", json.dumps(row), flush=True)
        if err > KERNEL_ATOL:
            fail(f"kernel vs plain max abs diff {err} > {KERNEL_ATOL} at b={b}")
        if zero_heads != 0.0:
            fail(f"underflowing heads are not zero at b={b}: {zero_heads}")
        if masked_err > KERNEL_ATOL:
            fail(f"fully masked example is not uniform at b={b}: {masked_err}")
        rows.append(row)
    return rows


def http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def check_serve(tmp):
    """--mode serve at the butd_vqa.json widths. Returns (launches,
    forward passes, logits max abs diff)."""
    import torch

    from tf_vqa_regat_tpu_torch.config import parse_with_config
    from tf_vqa_regat_tpu_torch.main import build_dataset, build_server
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT
    from tf_vqa_regat_tpu_torch.ops import graph_attention
    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia
    from tf_vqa_regat_tpu_torch.params import save_npz

    argv = ["--config", os.path.join(REPO, "configs", "butd_vqa.json"), "--mode",
            "serve", "--synthetic", "--serve_port", "0"]
    cfg = parse_with_config(argv)
    ds = build_dataset(cfg)
    ckpt = os.path.join(tmp, "implicit-butd.npz")
    t0 = time.perf_counter()
    save_npz(ckpt, ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans,
                         torch.Generator().manual_seed(cfg.seed)))
    print(f"random full-width model written in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    server, batcher, engine = build_server(argv + ["--checkpoint", ckpt, "--device", "cuda"])
    print(f"server built and warmed in {time.perf_counter() - t0:.1f} s "
          f"(batch sizes {list(engine.batch_sizes)})", flush=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    forwards = [0]
    hook = engine.model.register_forward_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1)
    )
    try:
        ids = sorted(engine.img_index)[:12]
        questions = ["what color is the car ?", "how many people are on the left ?",
                     "is the man on the dog ?", "what is the woman in ?"]
        ia.KERNEL.launches = 0  # count only the main path's launches
        code, health = http(url + "/healthz")
        if code != 200 or health.get("status") != "ok":
            fail(f"/healthz: {code} {health}")
        answers = []
        for i, q in enumerate(questions):
            code, body = http(url + "/predict", {"question": q, "image_id": ids[i]})
            if code != 200:
                fail(f"/predict single: {code} {body}")
            answers.append(body)
        code, body = http(url + "/predict", [
            {"question": questions[i % 4], "image_id": ids[i]} for i in range(8)])
        if code != 200 or len(body) != 8:
            fail(f"/predict batch: {code} {body}")
        answers += body
        code, missing = http(url + "/predict", {"question": "what ?", "image_id": 10**9})
        launches, passes = ia.KERNEL.launches, forwards[0]
        print(f"/healthz {json.dumps(health)}", flush=True)
        print(f"/predict answers {json.dumps(answers)}", flush=True)
        print(f"/predict unknown image: {code} {json.dumps(missing)}", flush=True)
        if code != 404:
            fail(f"unknown image_id gave {code}, expected 404")
        for a in answers:
            if a.get("answer") not in ds.label2ans or not 0.0 < a["confidence"] < 1.0:
                fail(f"bad answer {a}")
        print(f"kernel launches {launches} over {passes} forward passes", flush=True)
        if passes == 0 or launches != 2 * passes:
            fail(f"expected 2 launches per forward pass, got {launches} for {passes}")

        # One batch of 8 through the whole model: kernel path vs plain path.
        dev = engine.device
        toks = torch.tensor([engine._encode(questions[i % 4]) for i in range(8)], device=dev)
        img = torch.tensor([engine.img_index[i] for i in ids[:8]], device=dev)
        valid = torch.ones(8, dtype=torch.bool, device=dev)
        got = engine.logits(toks, img, valid)
        graph_attention.fused_implicit_graph_attention = ia.implicit_attention_plain
        try:
            want = engine.logits(toks, img, valid)
        finally:
            graph_attention.fused_implicit_graph_attention = ia.fused_implicit_graph_attention
        torch.cuda.synchronize()
        if got.shape != (8, ds.num_ans) or not torch.isfinite(got).all():
            fail(f"logits {tuple(got.shape)} not finite or not [8, {ds.num_ans}]")
        logits_err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        same_argmax = bool((got.argmax(-1) == want.argmax(-1)).all())
        print(f"logits kernel vs plain: max abs diff {logits_err}, largest |logit| "
              f"{scale} (tol {LOGITS_RTOL} of it), argmax equal {same_argmax}", flush=True)
        if not logits_err <= LOGITS_RTOL * scale or not same_argmax:
            fail("served logits disagree with the plain path")

        # Host-clock latency of one engine call per fixed batch size.
        latency = {}
        for B in engine.batch_sizes:
            qs = [questions[i % 4] for i in range(B)]
            im = [ids[i % len(ids)] for i in range(B)]
            runs = []
            for _ in range(23):
                t0 = time.perf_counter()
                engine.infer(qs, im)
                runs.append((time.perf_counter() - t0) * 1e3)
            latency[B] = statistics.median(runs[3:])
        print(f"engine.infer median ms by batch size {json.dumps(latency)}", flush=True)
    finally:
        hook.remove()
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(timeout=10)
    return launches, passes, logits_err


def main() -> None:
    if not os.path.isdir(os.path.join(REPO, "tf_vqa_regat_tpu_torch")):
        fail("run from the root of a checkout: tf_vqa_regat_tpu_torch/ is missing")
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from tf_vqa_regat_tpu_torch.ops.kernels import build
    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

    t0 = time.perf_counter()
    so = build.build(ia.SOURCE)
    ia.KERNEL.lib()
    print(f"built {os.path.relpath(so, REPO)} in {time.perf_counter() - t0:.1f} s", flush=True)
    log = so.with_suffix(".log")
    if log.exists():
        print(log.read_text().strip(), flush=True)

    rows = check_kernels(torch.device("cuda", 0))
    with tempfile.TemporaryDirectory() as tmp:
        launches, _, _ = check_serve(tmp)

    if any(m.split(".")[0] in ("jax", "jaxlib", "tf_vqa_regat_tpu") for m in sys.modules):
        fail("JAX or the JAX package was imported")
    big = rows[-1]
    print(json.dumps({"kernels": [{
        "name": "implicit_attention",
        "route": "cuda",
        "source": "tf_vqa_regat_tpu_torch/csrc/implicit_attention.cu",
        "replaces": "tf_vqa_regat_tpu/ops/pallas/implicit_attention.py:99",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
