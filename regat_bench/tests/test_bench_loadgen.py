"""The load generator's schedule and questions from the seed, and its child
process against a stub HTTP server: no torch, no JAX, open-loop timing."""

import json
import math
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from regat_bench import guard, port

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _driver():
    from regat_bench import manifest
    return manifest.driver("http_poisson")


def test_schedule_same_gaps_for_every_seed():
    d = _driver()
    a, b = d.schedule(200.0, 5.0, 1), d.schedule(200.0, 5.0, 2)
    assert a == d.schedule(200.0, 5.0, 1)
    assert len(a) == len(b) == 1000 and a != b
    gaps = lambda due: sorted(round(y - x, 12) for x, y in zip(due, due[1:]))
    # the same multiset of gaps, in another order (the last gap is never sent)
    assert abs(sum(gaps(a)) - sum(gaps(b))) < 0.1
    assert a[0] == 0.0 and 4.5 < a[-1] < 5.5
    mean_gap = a[-1] / (len(a) - 1)
    assert math.isclose(mean_gap, 1 / 200.0, rel_tol=0.1)


def test_questions_from_the_seed():
    d = _driver()
    q = d.questions(110, 7, 30, 14, 8)
    assert q == d.questions(110, 7, 30, 14, 8) and q != d.questions(110, 8, 30, 14, 8)
    lengths = sorted(sum(t != 30 for t in ids) for ids, _, _ in q)
    assert lengths[0] == 4 and lengths[-1] == 14
    for ids, text, img in q:
        words = text.split()
        assert [port.word(i) for i in ids if i != 30] == words and 0 <= img < 8


def test_generator_imports_neither_torch_nor_jax():
    out = subprocess.run(
        [sys.executable, "-c", "import sys, regat_bench.loadgen; "
         "print(sorted({m.split('.')[0] for m in sys.modules} & {'torch', 'numpy', 'jax'}))"],
        capture_output=True, text=True, cwd=ROOT, check=True)
    assert out.stdout.strip() == "[]"


class _Stub(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_POST(self):
        req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        body = json.dumps({"answer": "ans%d" % req["image_id"], "confidence": 0.5}).encode()
        self.send_response(404 if req["image_id"] < 0 else 200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_generator_against_a_stub_server():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        reqs = [[0.01 * i, json.dumps({"question": "w1 w2", "image_id": i - 1})]
                for i in range(20)]
        spec = {"port": server.server_address[1], "grace_s": 10.0,
                "warmup": reqs[:3], "requests": reqs}
        out = subprocess.run([sys.executable, "-m", "regat_bench.loadgen"],
                             input=json.dumps(spec), capture_output=True, text=True,
                             cwd=ROOT, timeout=60, check=True)
    finally:
        server.shutdown()
        server.server_close()
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("START ")
    report = json.loads(lines[-1])
    assert report["forbidden"] == []
    res = report["results"]
    assert [r[2] for r in res] == [404] + [200] * 19
    assert [r[3] for r in res[1:]] == ["ans%d" % i for i in range(19)]
    assert all(r[1] >= r[0] >= -0.005 for r in res)


def test_guard_compares_whole_top_level_names():
    assert guard.found(["tf_vqa_regat_tpu_torch.serve", "torch", "numpy"]) == []
    assert guard.found(["tf_vqa_regat_tpu.models", "jaxlib.xla", "jax"]) == [
        "jax", "jaxlib", "tf_vqa_regat_tpu"]
    assert guard.found(["jaxtyping", "flax_like"]) == []
