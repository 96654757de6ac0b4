"""Multi-process runs of the port's entry point for its CPU tests: a
launcher (`run_ranks`) and, when this file runs as a script, the runner of
one rank.

The runner (`python tests/torch_mp_util.py SPEC RANK`) runs the commands of
the JSON spec one after another through `tf_vqa_regat_tpu_torch.main.main`,
each with its own rendezvous port in the REGAT_* environment (nproc > 1)
and its own extra environment, and records per command, into
`{out}/record-{command}-rank{rank}.json`: the files the rank wrote (log and
metrics files, predictions, checkpoint directories, meta.json, the final
.npz), whether the run was preempted, and, after training, the rank's final
parameters in `{out}/params-{command}-rank{rank}.npz`. With
`sigterm_at_step` in a command, the rank sends itself SIGTERM inside that
optimizer step (counted from 1).
"""

import json
import os
import signal
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the rendezvous failed (a port taken between its choice and its use, or a
# slow start under load): such a launch is tried once more on fresh ports
_RENDEZVOUS = ("DistNetworkError", "address already in use", "Address already in use",
               "DistStoreError")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(nproc, commands, out, timeout=600, check=True):
    """Run `commands` (dicts: argv, env, sigterm_at_step, rank) on `nproc`
    rank processes; -> [(returncode, log)] per rank. `check` asserts every
    rank exited 0."""
    os.makedirs(out, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "REGAT_FAULT_PREEMPT_STEP")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for attempt in (0, 1):
        spec = {"nproc": nproc, "out": out,
                "commands": [dict(c, port=free_port()) for c in commands]}
        path = os.path.join(out, "spec.json")
        with open(path, "w") as fh:
            json.dump(spec, fh)
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), path, str(r)],
                                  cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT) for r in range(nproc)]
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
        results = [(p.returncode, log) for p, log in zip(procs, logs)]
        flake = any(rc != 0 and any(s in log for s in _RENDEZVOUS) for rc, log in results)
        if not (flake and attempt == 0):
            break
    if check:
        for r, (rc, log) in enumerate(results):
            assert rc == 0, f"rank {r} of {nproc} exited {rc}:\n{log[-6000:]}"
    return results


def record(out, command, rank):
    with open(os.path.join(out, f"record-{command}-rank{rank}.json")) as fh:
        return json.load(fh)


def _drive(spec_path, rank):
    import numpy as np

    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.train import checkpoint as ckpt
    from tf_vqa_regat_tpu_torch.train import logging as tlog
    from tf_vqa_regat_tpu_torch.train import loop
    from tf_vqa_regat_tpu_torch.train.step import TrainSteps

    with open(spec_path) as fh:
        spec = json.load(fh)
    out, nproc = spec["out"], spec["nproc"]
    writes = []

    def spy_open(path, mode="r", *a, **k):
        if any(c in mode for c in "wa"):
            writes.append(["open", os.path.basename(path)])
        return open(path, mode, *a, **k)

    for mod in (loop, tlog):
        mod.open = spy_open
    write_dir, write_meta, save_npz = ckpt._write_dir, ckpt._write_meta, port_main.save_npz

    def spy_dir(root, name, arrays):
        writes.append(["dir", name])
        return write_dir(root, name, arrays)

    def spy_meta(root, name, *a):
        writes.append(["meta", name])
        return write_meta(root, name, *a)

    def spy_npz(path, model):
        writes.append(["final", os.path.basename(path)])
        return save_npz(path, model)

    ckpt._write_dir, ckpt._write_meta, port_main.save_npz = spy_dir, spy_meta, spy_npz
    run_training = port_main.run_training
    step = TrainSteps.step
    for i, cmd in enumerate(spec["commands"]):
        writes.clear()
        rec = {}
        env = dict(cmd.get("env", {}))
        if nproc > 1:
            env.update(REGAT_COORDINATOR=f"127.0.0.1:{cmd['port']}",
                       REGAT_NUM_PROCESSES=str(nproc), REGAT_PROCESS_ID=str(rank))
        for k in ("REGAT_FAULT_PREEMPT_STEP", "REGAT_COORDINATOR", "REGAT_NUM_PROCESSES",
                  "REGAT_PROCESS_ID"):
            os.environ.pop(k, None)
        os.environ.update(env)
        kill_at = cmd.get("sigterm_at_step") if cmd.get("rank", rank) == rank else None
        calls = [0]

        def spy_step(self, R, inputs):
            calls[0] += 1
            if kill_at is not None and calls[0] == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(self, R, inputs)

        def spy_training(*a, **k):
            model, best = run_training(*a, **k)
            np.savez(os.path.join(out, f"params-{i}-rank{rank}.npz"),
                     **{n: p.detach().cpu().numpy() for n, p in model.named_parameters()})
            return model, best

        TrainSteps.step = spy_step
        port_main.run_training = spy_training
        result = port_main.main(cmd["argv"])
        rec["preempted"] = cmd["argv"][cmd["argv"].index("--mode") + 1] == "train" \
            and result is None
        rec["result"] = result if isinstance(result, (str, float, int, type(None))) \
            else list(result)
        rec["writes"] = list(writes)
        with open(os.path.join(out, f"record-{i}-rank{rank}.json"), "w") as fh:
            json.dump(rec, fh)


if __name__ == "__main__":
    _drive(sys.argv[1], int(sys.argv[2]))
