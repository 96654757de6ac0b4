"""The HTTP answer service under an open loop of Poisson arrivals, as `--mode
serve` runs it: the program's `make_server` (micro-batching at fixed batch
sizes, one CUDA graph per size) over the val split, with weights made from
the seed, and a load generator in a child process (regat_bench/loadgen.py,
no torch) that sends each request on its due time, one question about one
image per POST /predict.

The schedule: rate x seconds requests whose gaps are the quantiles of an
exponential law at the mix's rate, in an order drawn from the seed (every
seed sends the same set of gaps); questions of 4-14 words drawn from the
seed over the vocabulary, about images drawn uniformly from the split. A
warm-up of the same kind runs before the window. Each request's latency is
from its due time to its response; one that gets no answer counts as
failed, with the longest wait the window allows.

Once the window has closed, the reference computes the logits of a sample
of the answered requests, drawn from the seed, and checks the answer and
the confidence each was served.

The mix's keys: "program" (the serve settings), "rate_per_s", "warmup_s",
"grace_s", "sample", "trace_after" and "trace_share" (the stretch of the
window the traced run profiles).
"""

from __future__ import annotations

import gc
import json
import math
import os
import random
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List

import numpy as np
import torch

from regat_bench import inputs, port, stats, tracing
from regat_bench.reference import data as refdata
from regat_bench.reference import regat as ref
from regat_bench.weights import make_weights
from tf_vqa_regat_tpu_torch.serve import make_server

VAL_SEED = 1_000_003  # as the training mixes: the val split's seed


def schedule(rate: float, seconds: float, seed: int) -> List[float]:
    """Due times (s from the window's start) of round(rate * seconds)
    requests: the gaps are the exponential law's (k + 0.5) / n quantiles,
    shuffled by the seed."""
    n = max(1, round(rate * seconds))
    gaps = [-math.log(1.0 - (k + 0.5) / n) / rate for k in range(n)]
    random.Random(seed).shuffle(gaps)
    due, t = [], 0.0
    for g in gaps:
        due.append(t)
        t += g
    return due


def questions(n: int, seed: int, ntoken: int, T: int, images: int):
    """n (token ids [T] padded with ntoken, text, image) requests from the
    seed; lengths 4..T spread evenly and shuffled."""
    rng = random.Random(seed)
    lengths = [inputs.MIN_WORDS + (k * (T - inputs.MIN_WORDS + 1)) // n for k in range(n)]
    rng.shuffle(lengths)
    out = []
    for L in lengths:
        ids = [rng.randrange(ntoken) for _ in range(L)]
        text = " ".join(port.word(i) for i in ids)
        out.append((ids + [ntoken] * (T - L), text, rng.randrange(images)))
    return out


class EngineCounters:
    """Wraps the engine instance's `infer` and `step`: questions per call,
    the fixed batch size each call ran at, and host milliseconds per step
    (each step ends on the answers on the host)."""

    def __init__(self, engine):
        self.calls: List[tuple] = []  # (questions, batch size, ms)
        self._infer, self._step = engine.infer, engine.step
        self._n = 0
        engine.infer = self.infer
        engine.step = self.step

    def infer(self, questions, image_ids):
        self._n = len(questions)
        return self._infer(questions, image_ids)

    def step(self, question, img, valid):
        t = time.perf_counter()
        with tracing.span("engine_step"):
            out = self._step(question, img, valid)
        B = int(question.shape[0])
        self.calls.append((min(self._n, B), B, (time.perf_counter() - t) * 1e3))
        self._n -= min(self._n, B)
        return out


def _generator_env() -> Dict[str, str]:
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


class Service:
    """The program's HTTP service over the seed's val split and weights,
    serving on a thread, with the harness's engine counters."""

    def __init__(self, ctx):
        cfg, seed, device = ctx.cfg, ctx.seed, ctx.device
        self.device = device
        self.raw = inputs.make_split(cfg, seed + VAL_SEED, cfg["val_questions"],
                                     cfg["val_images"], device)
        weights = make_weights(cfg, seed, device)
        pcfg = port.config(cfg, seed, mode="serve", **ctx.mix["program"])
        ds = port.dataset(self.raw, "val", cfg["relation_type"])
        self.model = port.model(pcfg, ds, weights, device)
        self.server, self.batcher = make_server(pcfg, ds, self.model, device, port=0)
        self.counters = EngineCounters(self.batcher.engine)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.batcher.close()
        self.server.server_close()
        self.thread.join(timeout=10)
        self.server = self.batcher = self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def drive(service: Service, ctx, rate: float, seconds: float, seed: int, traced=None):
    """One open-loop window at `rate` -> (requests, due times, the
    generator's report, its window's start as a unix time). `traced(t_start)`
    runs on this thread while the window runs (the profiler)."""
    cfg, mix = ctx.cfg, ctx.mix
    T, ntoken, images = int(cfg["max_q_len"]), int(cfg["ntoken"]), int(cfg["val_images"])
    due = schedule(rate, seconds, seed)
    reqs = questions(len(due), seed, ntoken, T, images)
    warm_due = schedule(rate, float(mix["warmup_s"]), seed + 1)
    warm = questions(len(warm_due), seed + 1, ntoken, T, images)

    def body(q):
        return json.dumps({"question": q[1], "image_id": q[2]})

    spec = {"port": service.server.server_address[1], "grace_s": float(mix["grace_s"]),
            "warmup": [[d, body(q)] for d, q in zip(warm_due, warm)],
            "requests": [[d, body(q)] for d, q in zip(due, reqs)]}
    gen = subprocess.Popen([sys.executable, "-m", "regat_bench.loadgen"], stdin=subprocess.PIPE,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           env=_generator_env())
    try:
        gen.stdin.write(json.dumps(spec))
        gen.stdin.close()
        line = gen.stdout.readline()
        if not line.startswith("START "):
            raise RuntimeError(f"load generator: {line!r} {gen.stderr.read()[-2000:]}")
        t_start = float(line.split()[1])
        if traced is not None:
            traced(t_start)
        report = json.loads(gen.stdout.read())
        err = gen.stderr.read()
        gen.wait(timeout=30)
    finally:
        if gen.poll() is None:
            gen.kill()
            gen.wait()
    if gen.returncode != 0 or report["forbidden"]:
        raise RuntimeError(f"load generator failed ({gen.returncode}, loaded "
                           f"{report.get('forbidden')}): {err[-2000:]}")
    return reqs, due, report, t_start


def latencies(results, due, seconds: float, grace: float) -> List[float]:
    """Seconds from each request's due time to its answer; one with no
    answer waits the longest the window allows."""
    worst = seconds + grace
    return [r[1] if r[1] is not None and r[2] == 200 else worst - d
            for r, d in zip(results, due)]


def run(ctx) -> Dict[str, Any]:
    mix, seed, device, seconds = ctx.mix, ctx.seed, ctx.device, float(ctx.seconds)
    rate = float(mix["rate_per_s"])
    service = Service(ctx)
    if ctx.trace:
        tracing.Trace(device).warm()
    n_before = len(service.counters.calls)
    state: Dict[str, Any] = {"trace": None}

    def traced(t_start):
        time.sleep(max(0.0, t_start + float(mix["trace_after"]) * seconds - time.time()))
        trace = state["trace"] = tracing.Trace(device)
        trace.start()
        with tracing.span("serve_window"):
            time.sleep(float(mix["trace_share"]) * seconds)
        trace.stop()

    try:
        reqs, due, report, t_start = drive(service, ctx, rate, seconds, seed,
                                           traced if ctx.trace else None)
    finally:
        calls = service.counters.calls[n_before:]
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        raw = service.raw
        service.close()
    trace = state["trace"]
    if trace is not None:
        trace.read()
    results = report["results"]
    lat = latencies(results, due, seconds, float(mix["grace_s"]))
    failed = sum(1 for r in results if r[2] != 200)
    late = sorted(r[0] for r in results if r[0] is not None)
    answered = [i for i, r in enumerate(results) if r[2] == 200]
    sample = sorted(random.Random(seed + 2).sample(answered, min(int(mix["sample"]),
                                                                 len(answered))))
    served = [(reqs[i], results[i][3], results[i][4]) for i in sample]
    nums = check(ctx, raw, served, "f32")
    counters = {
        "engine_calls": len(calls),
        "batch_fill": (sum(c[0] for c in calls) / sum(c[1] for c in calls)) if calls else None,
        "engine_ms": (sum(c[2] for c in calls) / len(calls)) if calls else None,
    }
    if trace is not None:
        counters["traced_window_ns"] = trace.windows("serve_window")[0]
    return {
        "numbers": nums,
        "attempted": len(results),
        "failed": failed,
        "end_to_end": {"setup_s": t_start - ctx.t0,
                       "serve_p95_ms": 1e3 * stats.percentile(lat, 95)},
        "counters": counters,
        "trace": trace,
        "memory_peak_bytes": int(peak),
        "notes": [
            f"serve: {len(results)} requests at {rate} /s over {seconds} s, {failed} failed; "
            f"latency ms p50 {1e3 * stats.percentile(lat, 50)!r} p95 "
            f"{1e3 * stats.percentile(lat, 95)!r} p99 {1e3 * stats.percentile(lat, 99)!r} "
            f"max {1e3 * max(lat)!r}",
            f"generator lateness ms p50 {1e3 * stats.percentile(late, 50)!r} p99 "
            f"{1e3 * stats.percentile(late, 99)!r} max {1e3 * late[-1]!r}" if late else
            "generator lateness: no request sent",
            f"engine: {len(calls)} calls, fill {counters['batch_fill']!r}, "
            f"{counters['engine_ms']!r} ms per call",
        ],
    }


def reference_logits(ctx, raw, requests, precision: str) -> torch.Tensor:
    """The reference's logits [n, answers] of the requests' (tokens, image)."""
    cfg, device = ctx.cfg, ctx.device
    w = make_weights(cfg, ctx.seed, device)
    nx = ref.Numerics(precision)
    R = int(cfg["max_boxes"])
    out = []
    with nx.active(device), torch.no_grad():
        for lo in range(0, len(requests), 64):
            chunk = requests[lo:lo + 64]
            batch = refdata.image_batch(raw, np.array([q[2] for q in chunk]),
                                        np.array([q[0] for q in chunk]), R, device)
            out.append(ref.Model(cfg, w, nx).forward(batch).float())
    return torch.cat(out) if out else torch.zeros(0, int(cfg["num_ans"]), device=device)


def gaps(logits: torch.Tensor, answers: List[int], confidences: List[float]) -> Dict[str, float]:
    """The widest distance of a served answer's reference logit below the
    reference's best, and the widest gap between a served confidence and
    the sigmoid of the reference's logit of that answer."""
    if len(answers) == 0:
        return {"answer_gap": float("nan"), "confidence_gap": float("nan")}
    idx = torch.tensor(answers, device=logits.device)
    mine = logits.gather(1, idx[:, None])[:, 0].double()
    conf = torch.tensor(confidences, dtype=torch.float64, device=logits.device)
    return {"answer_gap": float((logits.double().max(dim=1).values - mine).max()),
            "confidence_gap": float((conf - torch.sigmoid(mine)).abs().max())}


def answer_index(answer: str) -> int:
    return int(answer[3:]) if answer.startswith("ans") else -1


def check(ctx, raw, served, precision: str) -> Dict[str, float]:
    """The compared numbers of the served (request, answer, confidence)."""
    logits = reference_logits(ctx, raw, [s[0] for s in served], precision)
    return gaps(logits, [answer_index(s[1]) for s in served], [float(s[2]) for s in served])


def readings(ctx, faults: List[str]) -> Dict[str, Any]:
    """regat_bench/control.py's readings for one seed, without a window: the
    reference's answers at TF32 (the control) in the program's place,
    against the f32 reference, on the requests of a run of this seed."""
    cfg, mix, seed = ctx.cfg, ctx.mix, ctx.seed
    raw = inputs.make_split(cfg, seed + VAL_SEED, cfg["val_questions"], cfg["val_images"],
                            ctx.device)
    due = schedule(float(mix["rate_per_s"]), 10.0, seed)
    reqs = questions(len(due), seed, int(cfg["ntoken"]), int(cfg["max_q_len"]),
                     int(cfg["val_images"]))
    sample = sorted(random.Random(seed + 2).sample(range(len(reqs)),
                                                   min(int(mix["sample"]), len(reqs))))
    chosen = [reqs[i] for i in sample]
    ref32 = reference_logits(ctx, raw, chosen, "f32")
    low = reference_logits(ctx, raw, chosen, "tf32")
    best = low.argmax(dim=1)
    conf = torch.sigmoid(low.gather(1, best[:, None])[:, 0])
    out = {"control": gaps(ref32, best.tolist(), conf.tolist())}
    if "answer" in faults:  # one served answer replaced by the next label
        alt = ref32.argmax(dim=1).clone()
        alt[0] = (alt[0] + 1) % alt.new_tensor(ref32.shape[1])
        c = torch.sigmoid(ref32.gather(1, alt[:, None])[:, 0])
        out["answer"] = gaps(ref32, alt.tolist(), c.tolist())
    return out
