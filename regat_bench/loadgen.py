"""The open-loop load generator of the HTTP mixes, run as its own process:

    python3 -m regat_bench.loadgen < spec.json

It imports the standard library alone (no torch, no numpy). The spec on
standard input: {"port", "warmup": [[due_s, body], ...], "requests": [[due_s,
body], ...], "grace_s"}: due times in seconds from the start of each phase,
bodies the JSON of one POST /predict. The warm-up phase runs first and is
not reported. Then it prints `START <unix time>` and sends the window's
requests, each on its own connection at its due time whatever the server
has answered (an open loop); it waits for the answers up to `grace_s` past
the last due time and prints one JSON line: per request [lateness_s,
latency_s or null, status, answer or error, confidence], latency counted
from the due time, and the modules it found loaded that it must not load.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time

from regat_bench import guard

REQUEST = (b"POST /predict HTTP/1.1\r\nHost: localhost\r\nContent-Type: application/json\r\n"
           b"Content-Length: %d\r\nConnection: close\r\n\r\n")


async def _one(port: int, body: bytes, due: float, out: list, i: int) -> None:
    sent = time.perf_counter()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(REQUEST % len(body) + body)
        await writer.drain()
        data = await reader.read()
        writer.close()
        done = time.perf_counter()
        head, _, payload = data.partition(b"\r\n\r\n")
        status = int(head.split(b" ", 2)[1])
        res = json.loads(payload) if status == 200 else {}
        out[i] = [sent - due, done - due, status, res.get("answer", payload[:80].decode()),
                  res.get("confidence")]
    except (OSError, ValueError, IndexError) as e:
        out[i] = [sent - due, None, 0, f"{type(e).__name__}: {e}"[:120], None]


async def phase(port: int, items: list, grace: float) -> list:
    """Send `items` ([due_s, body]) on schedule -> per request results
    (None where no answer came within `grace` s of the last due time)."""
    out = [None] * len(items)
    base = time.perf_counter()
    tasks = []
    for i, (due, body) in enumerate(items):
        delay = base + due - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.create_task(_one(port, body.encode(), base + due, out, i)))
    if tasks:
        last = base + (items[-1][0] if items else 0.0)
        _, pending = await asyncio.wait(tasks, timeout=max(0.0, last + grace - time.perf_counter()))
        for t in pending:
            t.cancel()
        await asyncio.gather(*pending, return_exceptions=True)
    return [r if r is not None else [None, None, 0, "no answer", None] for r in out]


async def main_async(spec: dict) -> dict:
    await phase(spec["port"], spec["warmup"], spec["grace_s"])
    print(f"START {time.time()!r}", flush=True)
    results = await phase(spec["port"], spec["requests"], spec["grace_s"])
    return {"results": results, "forbidden": guard.found()}


def main() -> int:
    spec = json.loads(sys.stdin.read())
    print(json.dumps(asyncio.run(main_async(spec))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
