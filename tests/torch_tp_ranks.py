"""The rank side of the port's tensor-parallel and sharded-serve CPU tests:
`python tests/torch_tp_ranks.py SPEC RANK` opens a gloo group of the spec's
`nproc` ranks, makes the `dp` x `tp` mesh and runs the spec's jobs one
after another, each writing `{out}/{job name}-rank{RANK}.npz`:

- "step": a model family's train steps from the parent's parameters and
  batches (`{data}` npz: `p/<path>` full leaves, `b<i>/<field>` batches),
  each rank taking its data index's rows (the model built with the data
  axis, which --ref_compat_q_att's softmax gathers over): per step the
  loss, score and count; the rank's parameter parts after the steps; with
  `grad_sums`, first the rank's gradient sums of its rows of the first
  batch (`gsum/<name>`, `gsum_loss`, `gsum_n`); before the steps, at
  dp = 1, each leaf's gradient gathered to its full shape beside the
  gradient of the one-device model built in this process; the eval
  metrics and predicted answers of the first batch at this mesh and at one
  device;
- "gather": the sharded store's lookup by global image id
  (`ShardedDeviceStore.gather_images`) of the parent's image ids and box
  counts, for each feature dtype;
- "serve": the engine over the sharded store (every rank builds it; rank 0
  answers the parent's requests, the others follow) and its logits,
  computed by every rank alike;
- "ensemble": the sharded ensemble's averaged probabilities by entry and
  its score.

Each rank runs torch on one thread. The parent starts the ranks with
`run_tp_ranks`.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tp_ranks(nproc, dp, tp, jobs, out, timeout=600):
    """Run `jobs` on `nproc` = dp x tp rank processes; asserts every rank
    exited 0. A launch whose rendezvous failed is tried once more on a
    fresh port (torch_mp_util)."""
    from torch_mp_util import _RENDEZVOUS, free_port

    os.makedirs(out, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
           and not k.startswith("REGAT_")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for attempt in (0, 1):
        path = os.path.join(out, "tp_spec.json")
        with open(path, "w") as fh:
            json.dump({"nproc": nproc, "dp": dp, "tp": tp, "out": out, "port": free_port(),
                       "jobs": jobs}, fh)
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), path, str(r)],
                                  cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT) for r in range(nproc)]
        try:
            logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        flake = any(p.returncode != 0 and any(s in log for s in _RENDEZVOUS)
                    for p, log in zip(procs, logs))
        if not (flake and attempt == 0):
            break
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {nproc} exited {p.returncode}:\n{log[-6000:]}"


def _load(path):
    import numpy as np

    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _batches(data):
    import torch

    out = []
    i = 0
    while any(k.startswith(f"b{i}/") for k in data):
        pre = f"b{i}/"
        out.append({k[len(pre):]: torch.from_numpy(v) for k, v in data.items()
                    if k.startswith(pre)})
        i += 1
    return out


def _rows(batch, mesh):
    """The data index's rows of a batch (the global batch split over dp)."""
    B = batch["features"].shape[0]
    per = B // mesh.dp
    return {k: v[mesh.data * per:(mesh.data + 1) * per] for k, v in batch.items()}


def _step_job(job, mesh, out, rank):
    import numpy as np
    import torch

    from tf_vqa_regat_tpu_torch.config import Config
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
    from tf_vqa_regat_tpu_torch.parallel import distributed
    from tf_vqa_regat_tpu_torch.parallel.mesh import shard_axis
    from tf_vqa_regat_tpu_torch.params import load_jax_arrays
    from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
    from tf_vqa_regat_tpu_torch.train.step import EvalSteps, TrainSteps, eval_step, grad_sums

    cfg = Config(**job["cfg"])
    data = _load(job["data"])
    flat = {k[2:]: v for k, v in data.items() if k.startswith("p/")}
    batches = _batches(data)
    dims = job["dims"]
    tp = mesh.tensor_parallel()
    cpu = torch.device("cpu")

    def build(tp_):
        model = ReGAT(cfg, dims["ntoken"], dims["v_dim"], dims["num_ans"], tp=tp_,
                      data=mesh.data_axis())
        load_jax_arrays(model, flat)
        return model

    rec = {}
    model = build(tp)
    if job.get("grad_sums"):
        # this rank's gradient sums of its rows of the first batch, their
        # loss sum and count (the parent adds the ranks' and divides)
        g, loss_sum, _, n = grad_sums(model, list(model.parameters()), _rows(batches[0], mesh),
                                      0, cfg.seed, cfg.grad_accum)
        for (name, _), v in zip(model.named_parameters(), g):
            rec[f"gsum/{name}"] = v.detach().numpy()
        rec["gsum_loss"], rec["gsum_n"] = np.float64(loss_sum), np.float64(n)
    if mesh.dp == 1:
        # every leaf's gradient at this mesh, gathered, and at one device
        one = build(None)
        names = [n for n, _ in model.named_parameters()]
        got = grad_sums(model, list(model.parameters()), batches[0], 0, cfg.seed)[0]
        want = grad_sums(one, list(one.parameters()), batches[0], 0, cfg.seed)[0]
        for name, g, w in zip(names, got, want):
            axis = shard_axis(name)
            if axis is not None:
                g = distributed.all_gather(g, axis, mesh.model_group())
            rec[f"grad/{name}"] = g.detach().numpy()
            rec[f"grad1/{name}"] = w.detach().numpy()
        # eval metrics and answers of the first batch, here and at one device
        e = EvalSteps(model, cpu, mesh=mesh).batch(batches[0])
        e1 = eval_step(one, batches[0])
        for k in ("loss", "score", "n"):
            rec[f"eval/{k}"] = np.float64(e[k])
            rec[f"eval1/{k}"] = np.float64(e1[k])
        model.eval()
        with torch.no_grad():
            rec["answers"] = model(batches[0]).argmax(-1).numpy()
            rec["answers1"] = one(batches[0]).argmax(-1).numpy()
    sched = make_lr_schedule(cfg.base_lr, len(batches), cfg.lr_decay_rate, cfg.lr_decay_step)
    opt = Adamax(model, trainable_mask(model, False), sched, cfg.grad_clip)
    train = TrainSteps(model, opt, cfg, cpu, None, mesh=mesh)
    metrics = []
    for batch in batches:
        m = train.batch(_rows(batch, mesh))
        n = float(m["n"])
        metrics.append([float(m["loss_sum"]) / max(n, 1.0), float(m["score"]), n])
    rec["metrics"] = np.asarray(metrics)
    for name, p in model.named_parameters():
        rec[f"param/{name}"] = p.detach().numpy()
    np.savez(os.path.join(out, f"{job['name']}-rank{rank}.npz"), **rec)


def _gather_job(job, mesh, out, rank):
    import dataclasses

    import numpy as np
    import torch

    from tf_vqa_regat_tpu_torch.data.sharded_store import ShardedDeviceStore
    from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset

    ds = dataclasses.replace(synthetic_dataset(**job["dataset"]),
                             relation_type=job["relation_type"])
    req = _load(job["data"])
    img, n_box = torch.from_numpy(req["img"]), torch.from_numpy(req["n_box"])
    rec = {}
    for dtype in job["dtypes"]:
        store = ShardedDeviceStore(ds, torch.device("cpu"), mesh.data, mesh.dp, targets=False,
                                   feature_dtype=dtype, include_adj=True)
        outs = store.gather_images(store.image_meta_arrays(), img, n_box, job["num_rois"],
                                   mesh.data_group())
        for name, t in zip(("features", "norm_bb", "bb", "adj"), outs):
            rec[f"{dtype}/{name}"] = t.numpy()
    np.savez(os.path.join(out, f"{job['name']}-rank{rank}.npz"), **rec)


def _serve_job(job, mesh, out, rank):
    import numpy as np
    import torch

    from tf_vqa_regat_tpu_torch.main import build_dataset, load_model, parse
    from tf_vqa_regat_tpu_torch.serve import InferenceEngine

    cfg = parse(job["argv"])[0]
    ds = build_dataset(cfg)
    engine = InferenceEngine(cfg, ds, load_model(cfg, ds), torch.device("cpu"),
                             batch_sizes=(1, 4), mesh=mesh)
    req = _load(job["data"])
    question, img = torch.from_numpy(req["question"]), torch.from_numpy(req["img"])
    valid = torch.from_numpy(req["valid"])
    rec = {"logits": engine.logits(question, img, valid).numpy(),
           "store_mode": np.asarray(engine.store_mode)}
    if rank == 0:
        answers = engine.infer(list(job["questions"]), list(job["image_ids"]))
        rec["answers"] = np.asarray(json.dumps(answers))
        engine.stop()
    else:
        engine.follow()
    np.savez(os.path.join(out, f"{job['name']}-rank{rank}.npz"), **rec)


def _ensemble_job(job, mesh, out, rank):
    import numpy as np
    import torch

    from tf_vqa_regat_tpu_torch.main import build_dataset, parse
    from tf_vqa_regat_tpu_torch.train import ensemble
    from tf_vqa_regat_tpu_torch.train.logging import Logger

    cfg = parse(job["argv"])[0]
    ds = build_dataset(cfg)
    cpu = torch.device("cpu")
    logger = Logger(os.path.join(out, f"{job['name']}-log-rank{rank}.txt"))
    try:
        members = ensemble.load_members(cfg, ds, cpu, logger, mesh)
        sources = ensemble.member_adj_sources(members, ds)
        probs, entries = [], []
        for p, batch in ensemble._sharded_passes(cfg, ds, cpu, members, sources, mesh=mesh):
            probs.append(p.numpy().copy())
            entries.append(np.asarray(batch["entry"]))
        score = ensemble.run_ensemble_eval(cfg, ds, cpu, logger)
    finally:
        logger.close()
    np.savez(os.path.join(out, f"{job['name']}-rank{rank}.npz"), probs=np.concatenate(probs),
             entries=np.concatenate(entries), score=np.float64(score))


JOBS = {"step": _step_job, "gather": _gather_job, "serve": _serve_job,
        "ensemble": _ensemble_job}


def main(spec_path, rank):
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from tf_vqa_regat_tpu_torch.parallel import distributed
    from tf_vqa_regat_tpu_torch.parallel.mesh import make_mesh

    with open(spec_path) as fh:
        spec = json.load(fh)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                            world_size=spec["nproc"], rank=rank)
    try:
        mesh = make_mesh(spec["dp"], spec["tp"])
        for job in spec["jobs"]:
            JOBS[job["kind"]](job, mesh, spec["out"], rank)
    finally:
        distributed.destroy()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
