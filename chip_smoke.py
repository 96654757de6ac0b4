#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py        # from the root of a checkout

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA kernel of the serve and train paths from csrc/ (timed);
  3. B1's eval variant against its plain PyTorch version on the card, at the
     serve shapes (b = 1, 8, 32; R=100, H=16, dh=o=64, n=20, P=64), with key
     masks from random box counts in 10-100, one fully masked example and
     one row whose other heads underflow; max abs difference, and per-call
     times (CUDA events around 10 back-to-back calls, median of 25 rounds
     taken in turns with the plain version);
  4. B1's train variant at b = 32 and 256 with a uint8 keep-mask: `out` and
     the post-relu pos weights `pwr` against the plain version, then the
     gradients of (out * G).sum() w.r.t. q, k, vw, w_pos and b_pos through
     the `ImplicitAttention` Function (kernel forward, transcribed backward)
     against torch autograd of the plain version; forward and
     forward+backward times, timed as in 3;
  5. one train step at the full widths of configs/butd_vqa.json and b=256:
     loss and per-leaf gradients of the kernel path against the plain path
     (same parameters, batch and dropout masks), 2 train-variant launches
     per forward; then the step's split into forward, backward and
     optimizer (CUDA events, median of 10 steps);
  6. the entry point: `--mode train --synthetic --epochs 1` at the config's
     widths and batch size 256 (16 steps of the 4,096-question synthetic
     split, then an eval pass): finite, falling loss, median step time;
     train- and eval-variant launches over the run, 2 per forward pass;
  7. `--mode eval` on the written .npz: its loss equals the training run's
     last `eval_loss` (metrics.jsonl) to rel 1e-6;
  8. `--mode serve` of that .npz, built by `main.build_server` as the entry
     point builds it, serving HTTP in a thread: /healthz, single and batch
     /predict, an unknown image (404); the eval variant's launches over
     those requests must be 2 per forward pass (one per direction), and one
     batch's logits must match the same model run with the plain versions.
Counts of launches are set to 0 just before each path of 6-8 runs and read
just after it; the comparison launches of 3-5 do not count.
Then it prints {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
It imports nothing of JAX and nothing of the JAX package (tf_vqa_regat_tpu).
"""

from __future__ import annotations

import json
import math
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
# - train variant's `pwr` against the plain version's: the same 64-term
#   pos-FC dot summed in another order, values O(1).
PWR_ATOL = 1e-4
# - gradients of B1, Function (kernel forward + transcribed backward) vs
#   autograd of the plain version, relative to each tensor's largest
#   magnitude: dq, dk, dvw follow the weights (KERNEL_ATOL above); dW_pos and
#   db_pos divide by pwr, which magnifies the forward's difference wherever
#   pwr sits just above its 1e-6 floor.
GRAD_RTOL = 1e-3
POS_GRAD_RTOL = 1e-2
# - one full-width train step, kernel path vs plain path: the loss, and each
#   trainable leaf's gradient relative to that leaf's largest magnitude. The
#   leaves trainable_mask freezes (biases feeding a softmax) have a true
#   gradient of zero, so both paths give rounding noise there: they are held
#   to the largest gradient of all leaves instead. On an H100 the worst
#   trainable leaf was a pos-FC scale `g` at 6.3e-3 (the 1/pwr magnification
#   of the forward's difference, as for dW_pos above).
LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 2e-2
# - --mode eval on the trained .npz against the training run's last eval.
EVAL_LOSS_RTOL = 1e-6
SERVE_SHAPES = dict(R=100, H=16, dh=64, o=64, n=20, P=64)
GRAD_ARGS = ("q", "k", "vw", "w_pos", "b_pos")
KERNEL_ARGS = ("q", "k", "vw", "pos_mat", "w_pos", "b_pos", "key_mask")


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


def max_rel(got, want):
    """Largest |got - want| over the largest |want|."""
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def check_train_kernel(device):
    """B1's train variant and the Function's gradients vs the plain version
    at b = 32 and 256, drop rate 0.2. Returns per-b rows."""
    import torch

    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

    s = SERVE_SHAPES
    rows = []
    for b in (32, 256):
        x = kernel_inputs(b, device, seed=100 + b)
        g = torch.Generator(device=device).manual_seed(b)
        bits = torch.randint(0, 256, (b, s["R"], s["n"], s["P"]), generator=g,
                             device=device, dtype=torch.uint8)
        dropmask = (bits >= 51).view(torch.uint8)  # keep-mask at rate 51/256
        G = torch.randn(b, s["R"], s["H"], s["o"], generator=g, device=device)

        def fwd_bwd(fn):
            leaves = {k: x[k].clone().requires_grad_() for k in GRAD_ARGS}
            out = fn(*(leaves.get(k, x[k]) for k in KERNEL_ARGS), 0.2, dropmask)
            grads = torch.autograd.grad((out * G).sum(), [leaves[k] for k in GRAD_ARGS])
            return out.detach(), dict(zip(GRAD_ARGS, grads))

        args = [x[k] for k in KERNEL_ARGS] + [0.2, dropmask]
        with torch.no_grad():
            out_k, pwr_k = ia.KERNEL(*args, save_pwr=True)
            out_p, pwr_p = ia.implicit_attention_plain(*args, save_pwr=True)
        fout_k, grads_k = fwd_bwd(ia.fused_implicit_graph_attention)  # the Function
        fout_p, grads_p = fwd_bwd(ia.implicit_attention_plain)
        torch.cuda.synchronize()
        for name, t in [("out", out_k), ("pwr", pwr_k), *grads_k.items()]:
            if not torch.isfinite(t).all():
                fail(f"train variant: {name} not finite at b={b}")
        err = {
            "out": (out_k - out_p).abs().max().item(),
            "pwr": (pwr_k - pwr_p).abs().max().item(),
            "function_out": (fout_k - out_k).abs().max().item(),
            **{f"d{k}": max_rel(grads_k[k], grads_p[k]) for k in GRAD_ARGS},
        }
        db = (grads_k["b_pos"] - grads_p["b_pos"]).abs()
        err["db_pos_worst_head"] = int(db.argmax())
        with torch.no_grad():
            fwd_ms, fwd_plain_ms = median_ms_interleaved(
                [lambda: ia.KERNEL(*args, save_pwr=True),
                 lambda: ia.implicit_attention_plain(*args, save_pwr=True)]
            )
        bwd_ms, bwd_plain_ms = median_ms_interleaved(
            [lambda: fwd_bwd(ia.fused_implicit_graph_attention),
             lambda: fwd_bwd(ia.implicit_attention_plain)], reps=21, calls=3,
        )
        row = dict(b=b, **err, fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms,
                   fwd_bwd_ms=bwd_ms, fwd_bwd_plain_ms=bwd_plain_ms)
        print("kernel implicit_attention train", json.dumps(row), flush=True)
        limits = [("out", KERNEL_ATOL), ("pwr", PWR_ATOL), ("function_out", 0.0),
                  ("dq", GRAD_RTOL), ("dk", GRAD_RTOL), ("dvw", GRAD_RTOL),
                  ("dw_pos", POS_GRAD_RTOL), ("db_pos", POS_GRAD_RTOL)]
        for name, tol in limits:
            if not err[name] <= tol:
                fail(f"train variant: {name} differs by {err[name]} > {tol} at b={b}")
        rows.append(row)
    return rows


def full_width_config(extra=()):
    from tf_vqa_regat_tpu_torch.config import parse_with_config

    return parse_with_config(
        ["--config", os.path.join(REPO, "configs", "butd_vqa.json"), "--synthetic",
         *extra]
    )


def check_train_step(device):
    """One train step at the full widths, b=256: kernel path vs plain path,
    then the step's forward / backward / optimizer split. Returns the split
    (median ms)."""
    import torch

    from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
    from tf_vqa_regat_tpu_torch.main import build_dataset
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
    from tf_vqa_regat_tpu_torch.ops import graph_attention
    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia
    from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
    from tf_vqa_regat_tpu_torch.train.step import train_forward

    cfg = full_width_config(["--mode", "train"])
    ds = build_dataset(cfg, "train")
    store = DeviceStore(ds, device)
    idx = next(store.epoch_indices(0, cfg.batch_size, True, cfg.seed))
    batch = gather_batch(store, torch.from_numpy(idx).to(device), cfg.resolved_num_rois())
    model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans).to(device)
    params = list(model.parameters())

    def loss_and_grads():
        loss, _ = train_forward(model, batch, 0, cfg.seed)
        return loss.detach(), torch.autograd.grad(loss, params)

    ia.KERNEL.train_launches = 0
    loss_k, grads_k = loss_and_grads()
    launches = ia.KERNEL.train_launches
    graph_attention.fused_implicit_graph_attention = ia.implicit_attention_plain
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        graph_attention.fused_implicit_graph_attention = ia.fused_implicit_graph_attention
    torch.cuda.synchronize()
    trainable = trainable_mask(model, False)
    top = max(g.abs().max() for g in grads_p)
    errs = {
        n: max_rel(a, b) if trainable[n] else ((a - b).abs().max() / top).item()
        for (n, _), a, b in zip(model.named_parameters(), grads_k, grads_p)
    }
    worst = max(errs, key=errs.get)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    print(f"train step b={cfg.batch_size} kernel vs plain: loss {loss_k.item()} vs "
          f"{loss_p.item()} (rel {loss_err}), worst leaf {worst} rel {errs[worst]}, "
          f"train-variant launches per forward {launches}", flush=True)
    if not all(torch.isfinite(g).all() for g in grads_k):
        fail("train step: a gradient is not finite")
    if launches != 2:
        fail(f"train step: {launches} train-variant launches per forward, expected 2")
    if not loss_err <= LOSS_RTOL:
        fail(f"train step: loss differs by rel {loss_err} > {LOSS_RTOL}")
    if not errs[worst] <= STEP_GRAD_RTOL:
        fail(f"train step: {worst} gradient differs by rel {errs[worst]} > {STEP_GRAD_RTOL}")

    opt = Adamax(model, trainable, make_lr_schedule(
        cfg.base_lr, 16, cfg.lr_decay_rate, cfg.lr_decay_step), cfg.grad_clip)
    split = {"forward": [], "backward": [], "optimizer": []}
    for step in range(12):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _ = train_forward(model, batch, step, cfg.seed)
        ev[1].record()
        grads = torch.autograd.grad(loss, params)
        ev[2].record()
        opt.step(grads)
        ev[3].record()
        ev[3].synchronize()
        if step >= 2:  # warm-up
            for i, k in enumerate(split):
                split[k].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: statistics.median(v) for k, v in split.items()}


def check_entry_point(tmp, smi):
    """`--mode train` then `--mode eval` through `main.main`, at the config's
    widths. Returns (npz path, {variant: launches} of the train run, median
    step ms)."""
    import torch

    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia
    from tf_vqa_regat_tpu_torch.train import loop

    argv = ["--config", os.path.join(REPO, "configs", "butd_vqa.json"), "--synthetic",
            "--output", tmp, "--device", "cuda", "--print_freq", "4"]
    real_step, records = loop.train_step, []

    def timed_step(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        m = real_step(*args, **kw)
        ev[1].record()
        records.append((ev, m["loss"]))
        return m

    loop.train_step = timed_step
    ia.KERNEL.launches = ia.KERNEL.train_launches = 0  # the train path starts here
    t0 = time.perf_counter()
    try:
        path = port_main.main(argv + ["--mode", "train", "--epochs", "1"])
    finally:
        loop.train_step = real_step
    wall = time.perf_counter() - t0
    launches = {"train": ia.KERNEL.train_launches, "eval": ia.KERNEL.launches}
    torch.cuda.synchronize()
    step_ms = [ev[0].elapsed_time(ev[1]) for ev, _ in records]
    losses = [float(loss) for _, loss in records]
    with open(os.path.join(tmp, "metrics.jsonl")) as fh:
        last = [json.loads(line) for line in fh][-1]
    print(f"--mode train: {len(losses)} steps in {wall:.1f} s (run, set-up included); "
          f"median step {statistics.median(step_ms)} ms (CUDA events) on {smi}, "
          f"TF32 off; losses {losses}; launches {launches}; last metrics "
          f"{json.dumps(last)}", flush=True)
    cfg = full_width_config()
    if len(losses) != -(-cfg.synthetic_train_size // cfg.batch_size):
        fail(f"--mode train took {len(losses)} steps")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"--mode train: loss not finite or not falling: {losses}")
    eval_passes = -(-cfg.synthetic_val_size // cfg.resolved_eval_batch())
    if launches != {"train": 2 * len(losses), "eval": 2 * eval_passes}:
        fail(f"--mode train: launches {launches} for {len(losses)} train and "
             f"{eval_passes} eval forward passes")

    ia.KERNEL.launches = ia.KERNEL.train_launches = 0  # the eval path starts here
    score, loss = port_main.main(argv + ["--mode", "eval", "--checkpoint", path])
    eval_launches = (ia.KERNEL.launches, ia.KERNEL.train_launches)
    rel = abs(loss - last["eval_loss"]) / abs(last["eval_loss"])
    print(f"--mode eval on {os.path.basename(path)}: score {score} loss {loss} vs the "
          f"training run's {last['eval_loss']} (rel {rel}); launches (eval, train) "
          f"{eval_launches}", flush=True)
    if not rel <= EVAL_LOSS_RTOL:
        fail(f"--mode eval loss differs from the training run's by rel {rel}")
    if eval_launches != (2 * eval_passes, 0):
        fail(f"--mode eval: launches (eval, train) {eval_launches}")
    return path, launches, statistics.median(step_ms)


def http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def check_serve(ckpt):
    """--mode serve of `ckpt` at the butd_vqa.json widths. Returns (launches,
    forward passes, logits max abs diff)."""
    import torch

    from tf_vqa_regat_tpu_torch.config import parse_with_config
    from tf_vqa_regat_tpu_torch.main import build_dataset, build_server
    from tf_vqa_regat_tpu_torch.ops import graph_attention
    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

    argv = ["--config", os.path.join(REPO, "configs", "butd_vqa.json"), "--mode",
            "serve", "--synthetic", "--serve_port", "0"]
    cfg = parse_with_config(argv)
    ds = build_dataset(cfg)
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
        ia.KERNEL.launches = ia.KERNEL.train_launches = 0  # the serve path starts here
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
        if ia.KERNEL.train_launches:
            fail(f"serving launched the train variant {ia.KERNEL.train_launches} times")
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

    device = torch.device("cuda", 0)
    smi_line = smi.stdout.strip().splitlines()[0]
    rows = check_kernels(device)
    train_rows = check_train_kernel(device)
    split = check_train_step(device)
    print(f"train step split at b=256, median ms (CUDA events, TF32 off) on {smi_line}: "
          f"{json.dumps(split)}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, train_launches, step_ms = check_entry_point(tmp, smi_line)
        serve_launches, _, _ = check_serve(ckpt)

    if any(m.split(".")[0] in ("jax", "jaxlib", "tf_vqa_regat_tpu") for m in sys.modules):
        fail("JAX or the JAX package was imported")
    source = "tf_vqa_regat_tpu_torch/csrc/implicit_attention.cu"
    big, train_big = rows[-1], train_rows[-1]
    print(json.dumps({"kernels": [{
        "name": "implicit_attention",
        "route": "cuda",
        "source": source,
        "replaces": "tf_vqa_regat_tpu/ops/pallas/implicit_attention.py:99",
        "launches": serve_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
    }, {
        "name": "implicit_attention_train",
        "route": "cuda",
        "source": source,
        "replaces": "tf_vqa_regat_tpu/ops/pallas/implicit_attention.py:208",
        "launches": train_launches["train"],
        "max_abs_err": max(max(r["out"], r["pwr"]) for r in train_rows),
        "ms": train_big["fwd_ms"],
        "plain_ms": train_big["fwd_plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
