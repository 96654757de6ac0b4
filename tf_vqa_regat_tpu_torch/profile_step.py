"""Where a train step's time goes on the card: the full-width model of a
config (default configs/butd_vqa.json) at its batch size (256), one batch of
the synthetic train split, traced with torch.profiler.

    python -m tf_vqa_regat_tpu_torch.profile_step [--config configs/spatial_vqa.json]
        [--steps 5] [--trace out.json] [config flags, e.g. --mutan_shared_qdrop,
        --compute_dtype bfloat16, --num_rois 36, --grad_accum 2,
        --data_mode host --prefetch 2]

With `--data_mode host` each step takes the next batch of the host path
(data/loader.py: packed on the host, copied by the prefetch thread
`--prefetch` batches ahead, or in the step's thread at 0), so the step time
and idle share include what the host stream costs; otherwise every step
reuses one batch gathered on the card from the device store.

Prints, for the traced steps: the step time on the host clock with and
without the profiler, the device's busy time (sum of kernel times) and idle
share, kernels launched per step, the shares of B1 (both variants), B2 and
the GEMMs, the peak device memory, and the kernels that took the most time.
Flags it does not know go to the config parser after the JSON's values
(e.g. `--compute_dtype bfloat16 --num_rois 36`). Needs a CUDA device; TF32
is off, as in chip_smoke.py.
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
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.main import build_dataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.train.loop import check_grad_accum, host_loader
from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
from tf_vqa_regat_tpu_torch.train.step import train_step

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "butd_vqa.json")
# cuBLAS names its Hopper bf16 GEMMs nvjet_*, its f32 ones *xmma_gemm* / cutlass
GEMM = re.compile(r"gemm|xmma|cutlass|gemv|nvjet", re.IGNORECASE)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=CONFIG, help="JSON config (default %(default)s)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default="", help="write a Chrome trace here")
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
    host = cfg.data_mode == "host"
    if host:
        loader = host_loader(cfg, ds, cfg.batch_size, True)
        stream = itertools.chain.from_iterable(
            prefetch_to_device(loader, device, epoch, 0, cfg.prefetch)
            for epoch in itertools.count())
    else:
        store = DeviceStore(ds, device, feature_dtype=cfg.feature_dtype)
        idx = next(store.epoch_indices(0, cfg.batch_size, True, cfg.seed))
        batch = gather_batch(store, torch.from_numpy(idx).to(device), cfg.resolved_num_rois())
        stream = itertools.repeat(batch)
    model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans).to(device)
    opt = Adamax(model, trainable_mask(model, False), make_lr_schedule(
        cfg.base_lr, 16, cfg.lr_decay_rate, cfg.lr_decay_step), cfg.grad_clip)

    def steps(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in itertools.islice(stream, n):
            train_step(model, opt, batch, opt.count, cfg.seed, cfg.grad_accum)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    torch.cuda.reset_peak_memory_stats(device)
    steps(3)  # warm-up: builds the kernel, fills the allocator's cache
    plain_ms = steps(args.steps)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = steps(args.steps)
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = {e.key: (e.self_device_time_total / 1e3 / args.steps, e.count / args.steps)
            for e in kernels}
    # the host path's copies run on the copy engine beside the kernels:
    # reported apart, not counted as busy
    h2d = {k: busy.pop(k) for k in list(busy) if "HtoD" in k}
    total = sum(ms for ms, _ in busy.values())
    b1 = sum(ms for k, (ms, _) in busy.items() if "implicit_attention" in k)
    b2 = sum(ms for k, (ms, _) in busy.items() if "graph_attention_kernel" in k)
    gemm = sum(ms for k, (ms, _) in busy.items() if GEMM.search(k))
    print(f"train step b={cfg.batch_size} at the widths of {os.path.basename(args.config)} "
          f"({cfg.relation_type}-{cfg.fusion}{' ' if config_flags else ''}"
          f"{' '.join(config_flags)}), compute {cfg.compute_dtype}, "
          f"grad_accum {cfg.grad_accum}, data "
          f"{f'host (prefetch {cfg.prefetch})' if host else 'device (one batch)'}, TF32 off, "
          f"on {smi}")
    print(f"host ms/step: {plain_ms:.3f} (no profiler), {traced_ms:.3f} (profiled)")
    print(f"device busy ms/step: {total:.3f}; idle share of the profiled step: "
          f"{1 - total / traced_ms:.3f}, of the unprofiled step: {max(0.0, 1 - total / plain_ms):.3f}")
    print(f"kernels per step: {sum(c for _, c in busy.values()):.0f}; B1 share of busy "
          f"{b1 / total:.3f} ({b1:.3f} ms); B2 share {b2 / total:.3f} ({b2:.3f} ms); "
          f"GEMM share {gemm / total:.3f} ({gemm:.3f} ms); peak device memory {peak_gb:.2f} GB")
    if h2d:
        print(f"host-to-device copies per step: {sum(ms for ms, _ in h2d.values()):.3f} ms in "
              f"{sum(c for _, c in h2d.values()):.0f} copies (copy engine, beside the kernels)")
    print("top kernels (ms/step, launches/step, name):")
    for k, (ms, c) in sorted(busy.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {ms:9.3f} {c:6.0f}  {k[:110]}")


if __name__ == "__main__":
    main()
