"""Run one cell of BENCHMARK.json once:

    python3 -m regat_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, regat_bench/ and the
program (tf_vqa_regat_tpu_torch). It needs as many CUDA devices as the cell
asks for and exits non-zero, printing no result, without them. The last
line of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics with --trace 0, its per-layer ones
with --trace 1), device, with --trace 1 breakdown, and last `checks`, each
compared number beside its limit; the same numbers end standard error.
With --pending it runs a cell of regat_bench/pending.json, which the
benchmark does not run yet.
"""

from __future__ import annotations

import time

T0 = time.time()  # the run's start: set-up is measured from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

import torch  # noqa: E402

from regat_bench import compare, guard, manifest, tracing  # noqa: E402
from tf_vqa_regat_tpu_torch.parallel import distributed  # noqa: E402

RANK_WAIT_S = 300  # how long rank 0 waits for the other ranks to end


@dataclass
class Context:
    """What a driver gets: the cell, its configuration, mix and limits, the
    run's seed, window and trace flag, the device and the start time."""

    workload: dict
    cfg: dict
    mix: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    chips: int
    t0: float
    readings: Optional[List[str]] = None  # regat_bench/control.py's readings, no window


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--pending", action="store_true",
                    help="also the cells of regat_bench/pending.json")
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--readings", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def context(args: argparse.Namespace, device: torch.device, t0: float = T0,
            cfg_override: Optional[dict] = None, mix_override: Optional[dict] = None) -> Context:
    man = manifest.Manifest(pending=args.pending)
    w = man.workload(args.workload)
    cfg = dict(man.config(w["config"]), **(cfg_override or {}))
    mix = dict(manifest.traffic(w["traffic"]), **(mix_override or {}))
    faults = None if args.readings is None else [f for f in args.readings.split(",") if f]
    return Context(w, cfg, mix, manifest.limits(w["name"]), args.seed, args.seconds,
                   bool(args.trace), device, int(w["chips"]), t0, faults)


def device_info(ctx: Context, peak: int) -> Dict[str, Any]:
    if ctx.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": ctx.chips,
                "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
            "count": ctx.chips, "memory_peak_bytes": int(peak)}


def execute(ctx: Context, args: argparse.Namespace) -> Dict[str, Any]:
    """Run the cell's driver and build the result line (without the
    no-JAX check, which main makes once the window has closed)."""
    man = manifest.Manifest(pending=args.pending)
    out = manifest.driver(ctx.mix["driver"]).run(ctx)
    if out is None:  # a rank other than 0: rank 0 reports
        return None
    if "readings" in out:
        return out
    ok, checks = compare.verdict(out["numbers"], ctx.limits)
    result: Dict[str, Any] = {"correct": ok, "attempted": int(out["attempted"]),
                              "failed": int(out["failed"])}
    device = device_info(ctx, out["memory_peak_bytes"])
    name = ctx.workload["name"]
    if not ctx.trace:
        metrics = {}
        for m in man.metrics_for("end_to_end", name):
            if m["name"] in out["end_to_end"]:
                metrics[m["name"]] = {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
    else:
        trace = out["trace"]
        rec = tracing.Record(ctx.workload, ctx.cfg, ctx.mix, ctx.chips, out["counters"],
                             trace if trace is not None and trace.device_ops else None)
        metrics = manifest.read_metrics(man.metrics_for("per_layer", name), rec)
        if trace is not None:
            lo, hi = out["counters"]["traced_window_ns"]
            busy = out["counters"].get("busy_ns_ranks") or [trace.busy_ns(lo, hi)]
            device["busy_s"] = sum(busy) / len(busy) / 1e9
            device["window_s"] = (hi - lo) / 1e9
            result["breakdown"] = trace.breakdown(lo, hi)
    result.update(metrics=metrics, device=device, notes=out["notes"], checks=checks)
    return result


def start_ranks(argv: List[str], chips: int) -> List[subprocess.Popen]:
    """Open the process group of a cell on `chips` cards: this process is
    rank 0; ranks 1.. are this command again with --rank, one card each,
    through the program's REGAT_* environment contract."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    procs = []
    for r in range(1, chips):
        env = dict(os.environ, REGAT_COORDINATOR=coordinator, REGAT_NUM_PROCESSES=str(chips),
                   REGAT_PROCESS_ID=str(r), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(chips))
        procs.append(subprocess.Popen([sys.executable, "-m", "regat_bench.run", *argv,
                                       "--rank", str(r)], env=env,
                                      stdout=subprocess.DEVNULL))
    os.environ.update(REGAT_COORDINATOR=coordinator, REGAT_NUM_PROCESSES=str(chips),
                      REGAT_PROCESS_ID="0", LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(chips))
    return procs


def join_ranks(procs: List[subprocess.Popen]) -> List[int]:
    """Wait for the other ranks (killed past RANK_WAIT_S) -> their exit codes."""
    deadline = time.time() + RANK_WAIT_S
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, deadline - time.time())))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    man = manifest.Manifest(pending=args.pending)
    chips = int(man.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"regat_bench: workload {args.workload} needs {chips} CUDA device(s), "
              f"{have} visible; no result", file=sys.stderr)
        return 2
    # the configuration computes in f32 with TF32 off (the program's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    procs = start_ranks(argv, chips) if chips > 1 and args.rank == 0 else []
    try:
        if chips > 1:
            distributed.maybe_initialize("cuda")
        device = distributed.rank_device("cuda") if chips > 1 else torch.device("cuda", 0)
        ctx = context(args, device)
        result = execute(ctx, args)
    finally:
        if chips > 1:
            distributed.destroy()
        codes = join_ranks(procs)
    bad = guard.found()
    if bad:
        print(f"regat_bench: rank {args.rank}'s process loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    if args.rank != 0:
        return 0
    if any(codes):
        print(f"regat_bench: the other ranks ended with {codes}; no result", file=sys.stderr)
        return 4
    if "readings" in result:
        print(json.dumps(dict(result["readings"], seed=args.seed, workload=args.workload)),
              flush=True)
        return 0
    for note in result.pop("notes"):
        print(note, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
