"""A cell of BENCHMARK.json at a size a CPU test run holds: the published
configuration with small widths, a small split and short blocks."""

import time

import torch

from regat_bench import run

CONFIG = {"num_hid": 64, "relation_dim": 96, "num_heads": 4, "nongt_dim": 10,
          "num_rois": 24, "max_boxes": 24, "batch_size": 16, "train_questions": 128,
          "train_images": 16, "val_questions": 32, "val_images": 8, "ntoken": 30}
MIXES = {
    "train_epoch": {"program": {"data_mode": "device", "device_store_budget_gb": 70.0,
                                "train_block": 4, "eval_batch": 8, "eval_block": 2,
                                "roi_buckets": "", "grad_accum": 1}},
    "http_poisson": {"rate_per_s": 40.0, "warmup_s": 0.3, "sample": 16, "grace_s": 20.0},
}


def context(workload: str, seed: int = 2_147_483_999, seconds: float = 1.0, trace: int = 0):
    """(the run's context on the CPU, its parsed arguments)."""
    torch.set_num_threads(2)
    args = run.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)]
                     + ["--pending"])  # the cells not run yet stay tested here
    probe = run.context(args, torch.device("cpu"))
    ctx = run.context(args, torch.device("cpu"), time.time(), CONFIG,
                      MIXES[probe.mix["driver"]])
    return ctx, args
