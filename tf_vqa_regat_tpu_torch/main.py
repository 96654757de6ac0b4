"""Entry point of the PyTorch port, with the JAX package's flags and JSON
configs (counterpart of main.py):

    python -m tf_vqa_regat_tpu_torch.main --config configs/butd_vqa.json \\
        --mode train --synthetic [--device cuda]
    python -m tf_vqa_regat_tpu_torch.main --config configs/butd_vqa.json \\
        --mode eval|serve --synthetic --checkpoint model.npz [--device cuda]

`--device` (default cuda) is the port's one extra flag. With `--device cuda`
and no visible GPU the run fails; it never moves to the CPU on its own.
`--device cpu` runs every kernel's plain PyTorch version.

Ported so far: `--mode train`, `eval` and `serve` on `--synthetic` data, for
implicit, spatial and semantic relations with BUTD fusion, and implicit
relations with BAN and MuTAN fusion (configs/ban_vqa.json,
mutan_vqa_cp.json). Training writes
`{output}/{relation_type}-{fusion}-pretrained_model.npz` (params.py), which
eval and serve read. Other modes raise NotImplementedError naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

import torch

from tf_vqa_regat_tpu_torch.config import Config, parse_with_config
from tf_vqa_regat_tpu_torch.data.synthetic import SyntheticDataset, synthetic_dataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, check_supported
from tf_vqa_regat_tpu_torch.params import load_jax_arrays, load_npz, save_npz
from tf_vqa_regat_tpu_torch.serve import make_server
from tf_vqa_regat_tpu_torch.train.logging import Logger
from tf_vqa_regat_tpu_torch.train.loop import run_evaluation, run_training

_NOT_PORTED = {
    "predict": "ROADMAP Queue A, persistence and the other modes",
    "ensemble_eval": "ROADMAP Queue A, persistence and the other modes",
    "export_h5": "ROADMAP Queue A, persistence and the other modes",
}


def split_device_flag(argv: List[str]) -> Tuple[str, List[str]]:
    """(--device value, the other arguments): parse_with_config rejects
    flags it does not know."""
    device, rest = "cuda", []
    it = iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
            if device is None:
                raise ValueError("--device needs a value (cuda, cuda:N or cpu)")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return device, rest


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is visible. Pass --device cpu to "
            f"run the plain PyTorch versions on the CPU."
        )
    return device


def build_dataset(cfg: Config, name: str = "val") -> SyntheticDataset:
    """The JAX entry point's synthetic split: `val` (seed + 1,
    synthetic_val_size questions), which eval and serve read, or `train`
    (seed, synthetic_train_size questions); with per-image semantic edge
    labels when the relation type is semantic."""
    if not cfg.synthetic:
        raise NotImplementedError(
            "real VQA features are not ported yet (ROADMAP Queue A, real VQA "
            "data without h5py); pass --synthetic"
        )
    if not cfg.adaptive:
        raise NotImplementedError(
            "the fixed-36 layout is not ported yet (ROADMAP Queue A, main-path "
            "runtime); use an adaptive config"
        )
    size, seed = (
        (cfg.synthetic_train_size, cfg.seed) if name == "train"
        else (cfg.synthetic_val_size, cfg.seed + 1)
    )
    return synthetic_dataset(
        num_images=max(size // 8, 8), num_questions=size, seed=seed,
        semantic=cfg.relation_type == "semantic", name=name,
    )


def load_model(cfg: Config, ds: SyntheticDataset) -> ReGAT:
    if not cfg.checkpoint:
        raise ValueError(f"--mode {cfg.mode} needs --checkpoint (an .npz of params.py)")
    if not cfg.checkpoint.endswith(".npz"):
        raise NotImplementedError(
            f"--checkpoint {cfg.checkpoint!r}: the port reads .npz parameter "
            f"files (params.py); orbax and .h5 checkpoints are ROADMAP Queue A, "
            f"persistence and the other modes"
        )
    model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans)
    load_jax_arrays(model, load_npz(cfg.checkpoint))
    return model


def parse(argv: Optional[List[str]] = None) -> Tuple[Config, torch.device]:
    """(config, device) of a ported mode; raises for any other."""
    device_name, rest = split_device_flag(sys.argv[1:] if argv is None else argv)
    cfg = parse_with_config(rest)
    if cfg.mode not in ("train", "eval", "serve"):
        item = _NOT_PORTED.get(cfg.mode)
        if item is None:
            raise ValueError(f"unknown mode {cfg.mode!r}")
        raise NotImplementedError(f"--mode {cfg.mode} is not ported yet ({item})")
    check_supported(cfg)
    return cfg, resolve_device(device_name)


def final_model_path(cfg: Config) -> str:
    """Where training writes its parameters (the JAX package's final
    artifact name, checkpoint.py:393-403, plus .npz)."""
    name = f"{cfg.relation_type}-{cfg.fusion}-pretrained_model.npz"
    return os.path.abspath(os.path.join(cfg.output, name))


def train(cfg: Config, device: torch.device) -> str:
    """`--mode train`: train from the seed's init, evaluating after every
    epoch; returns the path of the written parameters."""
    train_ds, val_ds = build_dataset(cfg, "train"), build_dataset(cfg, "val")
    model = ReGAT(cfg, train_ds.ntoken, train_ds.v_dim, train_ds.num_ans)
    model, best = run_training(cfg, train_ds, val_ds, model, device)
    path = final_model_path(cfg)
    save_npz(path, model)
    print(f"saved final model to {path} (best eval score {best:.4f})", flush=True)
    return path


def evaluate(cfg: Config, device: torch.device) -> Tuple[float, float]:
    """`--mode eval`: one pass over the val split -> (score %, mean loss).
    The loss is printed in full, so it can be held to the training run's
    last `eval_loss` in metrics.jsonl."""
    ds = build_dataset(cfg)
    model = load_model(cfg, ds)
    logger = Logger(os.path.join(cfg.output, "eval_log.txt"))
    try:
        score, loss, _ = run_evaluation(cfg, ds, model, device, logger)
        logger.write(f"Final eval score: {score:.4f} (eval loss {loss!r})")
    finally:
        logger.close()
    return score, loss


def build_server(argv: Optional[List[str]] = None):
    """(server, batcher, engine) exactly as `--mode serve` runs them; the
    server is bound but not started."""
    cfg, device = parse(argv)
    if cfg.mode != "serve":
        raise ValueError(f"build_server builds --mode serve, not --mode {cfg.mode}")
    ds = build_dataset(cfg)
    model = load_model(cfg, ds)
    server, batcher = make_server(cfg, ds, model, device, cfg.serve_port)
    return server, batcher, batcher.engine


def serve(argv: Optional[List[str]] = None) -> None:
    server, batcher, engine = build_server(argv)
    print(
        f"serving on http://127.0.0.1:{server.server_address[1]} "
        f"(device {engine.device}, batch sizes {list(engine.batch_sizes)}, "
        f"split {engine.ds.name})",
        flush=True,
    )
    try:
        server.serve_forever()
    finally:
        batcher.close()
        server.server_close()


def main(argv: Optional[List[str]] = None):
    """Runs the mode; returns train's written path or eval's (score, loss)."""
    cfg, device = parse(argv)
    if cfg.mode == "train":
        return train(cfg, device)
    if cfg.mode == "eval":
        return evaluate(cfg, device)
    return serve(argv)


if __name__ == "__main__":
    main()
