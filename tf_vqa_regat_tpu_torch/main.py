"""Entry point of the PyTorch port, with the JAX package's flags and JSON
configs (counterpart of main.py):

    python -m tf_vqa_regat_tpu_torch.main --config configs/butd_vqa.json \\
        --mode serve --synthetic --checkpoint model.npz [--device cuda]

`--device` (default cuda) is the port's one extra flag. With `--device cuda`
and no visible GPU the run fails; it never moves to the CPU on its own.
`--device cpu` runs every kernel's plain PyTorch version.

This slice ports `--mode serve` on `--synthetic` data with an `.npz`
checkpoint (params.py). Other modes raise NotImplementedError naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import torch

from tf_vqa_regat_tpu_torch.config import Config, parse_with_config
from tf_vqa_regat_tpu_torch.data.synthetic import SyntheticDataset, synthetic_dataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, check_supported
from tf_vqa_regat_tpu_torch.params import load_jax_arrays, load_npz
from tf_vqa_regat_tpu_torch.serve import make_server

_NOT_PORTED = {
    "train": "ROADMAP Queue A item 2, training",
    "eval": "ROADMAP Queue A item 3, main-path runtime",
    "predict": "ROADMAP Queue A item 6, persistence and the other modes",
    "ensemble_eval": "ROADMAP Queue A item 6, persistence and the other modes",
    "export_h5": "ROADMAP Queue A item 6, persistence and the other modes",
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


def build_dataset(cfg: Config) -> SyntheticDataset:
    """The split the JAX entry point serves: its synthetic val split."""
    if not cfg.synthetic:
        raise NotImplementedError(
            "real VQA features are not ported yet (ROADMAP Queue A item 6, "
            "persistence and the other modes); pass --synthetic"
        )
    if not cfg.adaptive:
        raise NotImplementedError(
            "the fixed-36 layout is not ported yet (ROADMAP Queue A item 3, "
            "main-path runtime); use an adaptive config"
        )
    return synthetic_dataset(
        num_images=max(cfg.synthetic_val_size // 8, 8),
        num_questions=cfg.synthetic_val_size,
        seed=cfg.seed + 1,
        name="val",
    )


def load_model(cfg: Config, ds: SyntheticDataset) -> ReGAT:
    if not cfg.checkpoint:
        raise ValueError(f"--mode {cfg.mode} needs --checkpoint (an .npz of params.py)")
    if not cfg.checkpoint.endswith(".npz"):
        raise NotImplementedError(
            f"--checkpoint {cfg.checkpoint!r}: the port reads .npz parameter "
            f"files (params.py); orbax and .h5 checkpoints are ROADMAP Queue A "
            f"item 6, persistence and the other modes"
        )
    model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans)
    load_jax_arrays(model, load_npz(cfg.checkpoint))
    return model


def build_server(argv: Optional[List[str]] = None):
    """(server, batcher, engine) exactly as `--mode serve` runs them; the
    server is bound but not started."""
    device_name, rest = split_device_flag(sys.argv[1:] if argv is None else argv)
    cfg = parse_with_config(rest)
    if cfg.mode != "serve":
        item = _NOT_PORTED.get(cfg.mode)
        if item is None:
            raise ValueError(f"unknown mode {cfg.mode!r}")
        raise NotImplementedError(f"--mode {cfg.mode} is not ported yet ({item})")
    check_supported(cfg)
    device = resolve_device(device_name)
    ds = build_dataset(cfg)
    model = load_model(cfg, ds)
    server, batcher = make_server(cfg, ds, model, device, cfg.serve_port)
    return server, batcher, batcher.engine


def main(argv: Optional[List[str]] = None) -> None:
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


if __name__ == "__main__":
    main()
