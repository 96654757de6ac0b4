"""Where a train step's time goes on the card: the full-width model of a
config (default configs/butd_vqa.json) at its batch size (256), one batch of
the synthetic train split, traced with torch.profiler, run as a CUDA graph
replay (as the entry points run it, train/graphs.py) and eagerly, in one
process.

    python -m tf_vqa_regat_tpu_torch.profile_step [--config configs/spatial_vqa.json]
        [--steps 5] [--trace out.json] [config flags, e.g.
        --mutan_shared_qdrop, --compute_dtype bfloat16, --num_rois 36,
        --grad_accum 2, --data_mode host --prefetch 2]

With `--data_mode host` each step takes the next batch of the host path
(data/loader.py: packed on the host, copied by the prefetch thread
`--prefetch` batches ahead, or in the step's thread at 0) and copies it into
the graph's static inputs, so the step time and idle share include what the
host stream costs; otherwise every step gathers the same batch from the
device store on the card, inside the step.

Prints, per mode (graphed, eager): the capture's seconds (graphed), the
step time on the host clock with and without the profiler, the device's
busy time (the union of the device operations' intervals, so overlapping
kernels count once) and idle share, the step's phases from its marks
(ops/kernels/marks.py: gather, forward, backward with B1's and B2's
backward inside it, optimizer; device ms per step), kernels launched per
step, the shares of B1 (both variants), B2 and the GEMMs, the peak device
memory, and the kernels that took the most time. Flags it does not know go
to the config parser after the JSON's values (e.g. `--compute_dtype
bfloat16 --num_rois 36`). Needs a CUDA device; TF32 is off, as in
chip_smoke.py.
"""

from __future__ import annotations

import argparse
import itertools
import os
import re
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tf_vqa_regat_tpu_torch.config import parse_with_config
from tf_vqa_regat_tpu_torch.data.loader import prefetch_to_device
from tf_vqa_regat_tpu_torch.data.store import DeviceStore
from tf_vqa_regat_tpu_torch.main import build_dataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.ops.kernels.marks import PAIRS, PHASES
from tf_vqa_regat_tpu_torch.train.loop import check_grad_accum, host_loader
from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
from tf_vqa_regat_tpu_torch.train.profiling import phase_ns, union_ns
from tf_vqa_regat_tpu_torch.train.step import TrainSteps

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "butd_vqa.json")
# cuBLAS names its Hopper bf16 GEMMs nvjet_*, its f32 ones *xmma_gemm* / cutlass
GEMM = re.compile(r"gemm|xmma|cutlass|gemv|nvjet", re.IGNORECASE)


def profile_mode(cfg, ds, device, graphed: bool, steps: int, trace: str) -> None:
    """Build the model and its TrainSteps, warm up, time `steps` steps
    without and with the profiler, print the mode's lines."""
    host = cfg.data_mode == "host"
    store = None
    if host:
        loader = host_loader(cfg, ds, cfg.batch_size, True)
        stream = itertools.chain.from_iterable(
            prefetch_to_device(loader, device, epoch, 0, cfg.prefetch)
            for epoch in itertools.count())
    else:
        store = DeviceStore(ds, device, feature_dtype=cfg.feature_dtype)
        idx = next(store.epoch_indices(0, cfg.batch_size, True, cfg.seed))
        blk = idx[None, :]
    model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans).to(device)
    opt = Adamax(model, trainable_mask(model, False), make_lr_schedule(
        cfg.base_lr, 16, cfg.lr_decay_rate, cfg.lr_decay_step), cfg.grad_clip)
    train = TrainSteps(model, opt, cfg, device, store, graphed)
    R = cfg.resolved_num_rois()

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            if host:
                train.batch(next(stream))
            else:
                train.block(R, blk, 1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    torch.cuda.reset_peak_memory_stats(device)
    run(3)  # warm-up: builds the kernels, captures the graph, fills the caches
    plain_ms = run(steps)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = run(steps)
    if trace:
        root, ext = os.path.splitext(trace)
        prof.export_chrome_trace(f"{root}-{'graphed' if graphed else 'eager'}{ext or '.json'}")

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = {e.key: (e.self_device_time_total / 1e3 / steps, e.count / steps)
            for e in kernels}
    # the host path's copies run on the copy engine beside the kernels:
    # reported apart, not counted as busy
    h2d = {k: busy.pop(k) for k in list(busy) if "HtoD" in k}
    ops = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
           and "HtoD" not in e.name()]
    total = union_ns((s, e) for _, s, e in ops) / 1e6 / steps
    b1 = sum(ms for k, (ms, _) in busy.items() if "implicit_attention" in k)
    b2 = sum(ms for k, (ms, _) in busy.items() if "graph_attention_kernel" in k)
    gemm = sum(ms for k, (ms, _) in busy.items() if GEMM.search(k))
    mode = "graphed" if graphed else "eager"
    capture = train.graphs.capture_seconds()
    if capture:
        print(f"[{mode}] capture (warm-up + capture, s): "
              f"{', '.join(f'{k}: {v:.3f}' for k, v in capture.items())}")
    print(f"[{mode}] host ms/step: {plain_ms:.3f} (no profiler), {traced_ms:.3f} (profiled)")
    if not total:
        print(f"[{mode}] device busy: not measured (the profiler saw no kernel)")
        return
    print(f"[{mode}] device busy ms/step: {total:.3f}; idle share of the profiled step: "
          f"{1 - total / traced_ms:.3f}, of the unprofiled step: "
          f"{max(0.0, 1 - total / plain_ms):.3f}")
    marked, phases = phase_ns(ops)
    if marked:
        ms = {k: v / 1e6 / marked for k, v in phases.items()}
        covered = sum(ms[k] for k in PHASES)
        print(f"[{mode}] phases, device ms/step over {marked} marked steps: "
              + ", ".join(f"{k} {ms[k]:.3f}" for k in PHASES + PAIRS)
              + f"; the phases cover {covered / total:.3f} of busy")
    print(f"[{mode}] kernels per step: {sum(c for _, c in busy.values()):.0f}; B1 share of "
          f"busy {b1 / total:.3f} ({b1:.3f} ms); B2 share {b2 / total:.3f} ({b2:.3f} ms); "
          f"GEMM share {gemm / total:.3f} ({gemm:.3f} ms); peak device memory {peak_gb:.2f} GB")
    if h2d:
        print(f"[{mode}] host-to-device copies per step: {sum(ms for ms, _ in h2d.values()):.3f} "
              f"ms in {sum(c for _, c in h2d.values()):.0f} copies (copy engine, beside the "
              f"kernels)")
    print(f"[{mode}] top kernels (ms/step, launches/step, name):")
    for k, (ms, c) in sorted(busy.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {ms:9.3f} {c:6.0f}  {k[:110]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=CONFIG, help="JSON config (default %(default)s)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default="", help="write Chrome traces here (-graphed, -eager)")
    args, config_flags = ap.parse_known_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    cfg = parse_with_config(
        ["--config", args.config, "--synthetic", "--mode", "train", *config_flags]
    )
    check_grad_accum(cfg)
    ds = build_dataset(cfg, "train")
    print(f"train step b={cfg.batch_size} at the widths of {os.path.basename(args.config)} "
          f"({cfg.relation_type}-{cfg.fusion}{' ' if config_flags else ''}"
          f"{' '.join(config_flags)}), compute {cfg.compute_dtype}, "
          f"grad_accum {cfg.grad_accum}, data "
          f"{f'host (prefetch {cfg.prefetch})' if cfg.data_mode == 'host' else 'device (one batch)'}"
          f", TF32 off, on {smi}")
    for graphed in (True, False):
        profile_mode(cfg, ds, device, graphed, args.steps, args.trace)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
