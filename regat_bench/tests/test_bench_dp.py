"""The data-parallel cell's run on two CPU ranks (gloo) at a small size:
sound, and with each fault the cell can have planted in the timed path
(the exchange between the ranks left out of the train step, a step that
leaves the state unchanged, half of each rank's rows left out), which
`correct` has to catch."""

import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ranks(fault: str = "") -> dict:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "regat_bench.tests.dp_rank", str(r), "2",
                               port, fault], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("fault,correct", [("", True), ("no_exchange", False),
                                           ("unchanged", False), ("half", False)])
def test_two_ranks(fault, correct):
    res = _ranks(fault)
    assert res["correct"] is correct, res["checks"]
