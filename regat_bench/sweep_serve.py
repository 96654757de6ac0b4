"""Find the rate the HTTP service sustains, once, on the card:

    python3 -m regat_bench.sweep_serve --workload butd.serve --rates 200,400,800 \\
        [--seconds 10] [--seed 1]

One process builds the cell's service as a run does, then drives one
open-loop window per rate, lowest first, and prints a JSON line per rate:
requests sent, failed, latency percentiles, the share answered by the
window's end, and the median latency of the window's last tenth of
requests over its first tenth (a backlog that grows shows as a ratio well
above 1). The knee is the highest rate whose requests all got answers and
whose backlog did not grow, with no request waiting out a connection
retry (every answer within 1 s: the server's accept queue drops a
connection in a burst, and the client's retry waits 1 s); the cell's mix
runs at four fifths of it.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from regat_bench import manifest, run, stats  # noqa: E402

GROWING = 2.0  # last tenth's median latency over the first tenth's
# a connection the server's accept queue dropped waits a 1 s SYN retry
RETRY_MS = 1000.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="butd.serve")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("regat_bench.sweep_serve needs a CUDA device", file=sys.stderr)
        return 2
    args = run.parse(["--workload", a.workload, "--seed", str(a.seed), "--seconds",
                      str(a.seconds), "--pending"])
    ctx = run.context(args, torch.device("cuda", 0), T0)
    drv = manifest.driver(ctx.mix["driver"])
    service = drv.Service(ctx)
    knee = None
    try:
        for rate in sorted(float(r) for r in a.rates.split(",")):
            _, due, report, _ = drv.drive(service, ctx, rate, a.seconds, a.seed)
            res = report["results"]
            lat = drv.latencies(res, due, a.seconds, float(ctx.mix["grace_s"]))
            failed = sum(1 for r in res if r[2] != 200)
            tenth = max(1, len(lat) // 10)
            growth = statistics.median(lat[-tenth:]) / statistics.median(lat[:tenth])
            in_window = sum(1 for r, d in zip(res, due)
                            if r[2] == 200 and d + r[1] <= a.seconds) / len(res)
            line = {"rate_per_s": rate, "sent": len(res), "failed": failed,
                    "p50_ms": 1e3 * stats.percentile(lat, 50),
                    "p95_ms": 1e3 * stats.percentile(lat, 95),
                    "p99_ms": 1e3 * stats.percentile(lat, 99), "max_ms": 1e3 * max(lat),
                    "answered_in_window": in_window, "backlog_growth": growth,
                    "lateness_p99_ms": 1e3 * stats.percentile(
                        [r[0] for r in res if r[0] is not None] or [0.0], 99)}
            print(json.dumps(line), flush=True)
            if failed == 0 and growth < GROWING and line["max_ms"] < RETRY_MS:
                knee = rate
    finally:
        service.close()
    print(json.dumps({"knee_per_s": knee, "four_fifths": None if knee is None else 0.8 * knee}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
