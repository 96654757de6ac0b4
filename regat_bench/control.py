"""The readings a cell's limits are set from, on the card at the cell's own
size, all in one process:

    python3 -m regat_bench.control --workload butd.train --seeds 11,12,13 [--faults half,unchanged]

For each seed it builds the cell as a run does, lets the program make the
outputs the comparison checks (no measured window), and prints one JSON
line with the compared numbers of the program against the reference (the
lower reading), of the control (the reference computed with TF32 matmuls,
put in the program's place) and of each planted fault (the reference with
the fault, in the program's place). The benchmark's own runs never run
this. A cell on several cards takes its readings through the run's own
ranks, one seed a command:

    python3 -m regat_bench.run --workload butd.train.dp4 --seed 11 --seconds 0 \
        --readings half,unchanged --pending
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from regat_bench import manifest, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--pending", action="store_true",
                    help="also the cells of regat_bench/pending.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("regat_bench.control needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    faults = [f for f in a.faults.split(",") if f]
    for seed in (int(s) for s in a.seeds.split(",")):
        args = run.parse(["--workload", a.workload, "--seed", str(seed), "--seconds", "0"]
                         + ["--pending"] * a.pending)
        ctx = run.context(args, torch.device("cuda", 0), time.time())
        drv = manifest.driver(ctx.mix["driver"])
        t = time.time()
        readings = drv.readings(ctx, faults)
        readings.update(seed=seed, workload=a.workload, seconds=time.time() - t)
        print(json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
