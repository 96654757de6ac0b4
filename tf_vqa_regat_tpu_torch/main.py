"""Entry point of the PyTorch port, with the JAX package's flags and JSON
configs (counterpart of main.py):

    python -m tf_vqa_regat_tpu_torch.main --config configs/butd_vqa.json \\
        --mode train --synthetic [--device cuda]
    python -m tf_vqa_regat_tpu_torch.main --config configs/butd_vqa.json \\
        --mode train --data_folder DIR [--use_both --use_vg] [--device cuda]
    python -m tf_vqa_regat_tpu_torch.main --config configs/butd_vqa.json \\
        --mode eval|serve|predict --synthetic --checkpoint model.npz [--device cuda]
    python -m tf_vqa_regat_tpu_torch.main --config configs/semantic_vqa.json \\
        --mode ensemble_eval --synthetic \\
        --ensemble_checkpoints implicit:A.npz,spatial:B.npz,semantic:C.npz

`--device` (default cuda) is the port's one extra flag. With `--device cuda`
and no visible GPU the run fails; it never moves to the CPU on its own.
`--device cpu` runs every kernel's plain PyTorch version.

Ported so far: `--mode train`, `eval`, `serve`, `predict` and
`ensemble_eval`, on `--synthetic` data or on a `--data_folder` in the
reference's layout whose HDF5 feature files were converted once by
data/convert.py (the port reads no HDF5): `--dataset vqa_cp`, `--use_both`,
`--use_vg`, `--tfidf` with the GloVe init of the word embedding,
`--mmap_features` and `--packed_cache`; adaptive or fixed-36
(configs/butd_vqa_fixed36.json), for implicit, spatial and semantic
relations with BUTD fusion, and implicit relations with BAN and MuTAN fusion
(configs/ban_vqa.json, mutan_vqa_cp.json); `--feature_dtype
float32|bfloat16|int8`, `--roi_buckets`, `--compute_dtype bfloat16`, and
the data path `--data_mode auto|device|host` with
`--device_store_budget_gb` and `--prefetch` (train/loop.py::
resolve_data_mode), and `--train_block` / `--eval_block`, the batches per
block of train and of eval, predict and the ensemble (train/loop.py). On
CUDA every train, eval, predict, ensemble and serve step is a replay of its
shape's CUDA graph (train/graphs.py). Training writes checkpoints under
`{output}/checkpoints/` (train/checkpoint.py; `--resume` continues from the
newest) and, at its end, `{output}/{relation_type}-{fusion}-pretrained_model.npz`
(params.py). A preempted run (SIGTERM) saves a step checkpoint, prints how
to resume and exits 0 without the final file. `--checkpoint` takes an .npz
or a checkpoint directory. `--mode export_h5` raises NotImplementedError
naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import os
import pickle
import sys
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.config import Config, parse_with_config
from tf_vqa_regat_tpu_torch.data import compose
from tf_vqa_regat_tpu_torch.data.dictionary import Dictionary
from tf_vqa_regat_tpu_torch.data.features import VQADataset, load_imgid2idx, load_vqa_dataset
from tf_vqa_regat_tpu_torch.data.glove import tfidf_from_questions
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.models.language import word_embedding_load_glove
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, check_supported
from tf_vqa_regat_tpu_torch.params import load_jax_arrays, save_npz
from tf_vqa_regat_tpu_torch.serve import make_server
from tf_vqa_regat_tpu_torch.train.checkpoint import load_params
from tf_vqa_regat_tpu_torch.train.ensemble import parse_members, run_ensemble_eval
from tf_vqa_regat_tpu_torch.train.logging import Logger
from tf_vqa_regat_tpu_torch.train.loop import (
    Preempted,
    run_evaluation,
    run_prediction,
    run_training,
)

PORTED_MODES = ("train", "eval", "serve", "predict", "ensemble_eval")
_NOT_PORTED = {
    "export_h5": "ROADMAP Queue A, persistence and the other modes: export_h5 and .h5 import",
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


def build_dataset(cfg: Config, name: str = "val") -> VQADataset:
    """The JAX entry point's synthetic split, in the config's layout
    (adaptive or fixed-36): `val` (seed + 1, synthetic_val_size questions),
    which eval, serve, predict and the ensemble read, or `train` (seed,
    synthetic_train_size questions); with
    per-image semantic edge labels when the relation type is semantic or an
    ensemble has a semantic member (the table's draws change the answers)."""
    size, seed = (
        (cfg.synthetic_train_size, cfg.seed) if name == "train"
        else (cfg.synthetic_val_size, cfg.seed + 1)
    )
    semantic = cfg.relation_type == "semantic" or (
        cfg.mode == "ensemble_eval" and "semantic:" in cfg.ensemble_checkpoints
    )
    return synthetic_dataset(
        num_images=max(size // 8, 8), num_questions=size, seed=seed,
        semantic=semantic, name=name, adaptive=cfg.adaptive,
    )


def build_datasets(
    cfg: Config,
) -> Tuple[Optional[VQADataset], VQADataset, Optional[Any], Optional[np.ndarray]]:
    """(train split or None, the split eval/predict/serve/ensemble read,
    TF-IDF matrix or None, its extension rows or None), as JAX
    main.py:46-184 builds them. --synthetic: build_dataset's splits. Else
    the converted dataset under --data_folder: vqa_cp's train and test over
    one merged COCO store; or val (--predict_split under --mode predict) and
    in train the train split, joined with val under --use_both and with the
    Visual Genome pairs under --use_vg; the ensemble's store loads every
    member's edge labels. --tfidf (train only) extends the dictionary."""
    if cfg.synthetic:
        train = build_dataset(cfg, "train") if cfg.mode == "train" else None
        return train, build_dataset(cfg, "val"), None, None

    dictionary = Dictionary.load_from_file(
        os.path.join(cfg.data_folder, "glove", "dictionary.pkl"))
    store_rts = None
    if cfg.mode == "ensemble_eval":
        store_rts = {rt for rt, _ in parse_members(cfg.ensemble_checkpoints)}
        store_rts.add(cfg.relation_type)
    # --use_both/--use_vg compose in train only; the vqa_cp base in every mode
    if cfg.mmap_features and (
        cfg.dataset == "vqa_cp" or (cfg.mode == "train" and (cfg.use_both or cfg.use_vg))
    ):
        raise ValueError(
            "--mmap_features cannot compose splits (--use_both/--use_vg and "
            "the vqa_cp merged train+val store concatenate feature tables, "
            "which requires materializing them); drop one or the other"
        )
    train = None
    if cfg.dataset == "vqa_cp":
        base = compose.load_vqa_cp_base(cfg.data_folder, cfg.adaptive,
                                        store_rts or cfg.relation_type)
        val = compose.load_vqa_cp_dataset(
            "test", dictionary, cfg.relation_type, cfg.data_folder, cfg.adaptive,
            store_relation_types=store_rts, base=base)
        if cfg.mode == "train":
            train = compose.load_vqa_cp_dataset(
                "train", dictionary, cfg.relation_type, cfg.data_folder, cfg.adaptive,
                base=base)
    else:
        val_split = cfg.predict_split if cfg.mode == "predict" else "val"
        val = load_vqa_dataset(val_split, dictionary, cfg.relation_type, cfg.data_folder,
                               cfg.adaptive, cfg.mmap_features, store_relation_types=store_rts)
        if cfg.mode == "train":
            train = load_vqa_dataset("train", dictionary, cfg.relation_type, cfg.data_folder,
                                     cfg.adaptive, cfg.mmap_features)
            if cfg.use_both:
                train = compose.concat_datasets(train, val, "trainval")
            if cfg.use_vg:
                train = append_visual_genome(cfg, train, dictionary)
    tfidf = weights = None
    if cfg.tfidf and cfg.mode == "train":
        # train only, as the reference: the model keeps the snapshotted ntoken
        tfidf, weights = tfidf_from_questions(["train", "val", "test2015"], dictionary,
                                              cfg.data_folder)
    return train, val, tfidf, weights


def append_visual_genome(cfg: Config, train: VQADataset, dictionary: Dictionary) -> VQADataset:
    """--use_vg: the train split with the Visual Genome pairs over its
    images; under --use_both the val images too, past the train images."""
    with open(os.path.join(cfg.data_folder, "cache", "trainval_ans2label.pkl"), "rb") as fh:
        ans2label = pickle.load(fh)
    img_id2idx = load_imgid2idx(cfg.data_folder, "train", cfg.adaptive)
    if cfg.use_both:
        val_map = load_imgid2idx(cfg.data_folder, "val", cfg.adaptive)
        offset = train.store.num_images - len(val_map)
        for k, v in val_map.items():
            img_id2idx.setdefault(k, v + offset)
    vg = compose.load_visual_genome_entries(cfg.data_folder, dictionary, ans2label, img_id2idx)
    return compose.append_entries(train, vg, train.name + "+vg")


def load_model(cfg: Config, ds: VQADataset) -> ReGAT:
    """The model of --checkpoint: an .npz of params.py or a checkpoint
    directory of train/checkpoint.py, full state or params only."""
    if not cfg.checkpoint:
        raise ValueError(
            f"--mode {cfg.mode} needs --checkpoint (an .npz or a checkpoint directory)"
        )
    model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans)
    load_jax_arrays(model, load_params(cfg.checkpoint))
    return model


def parse(argv: Optional[List[str]] = None) -> Tuple[Config, torch.device]:
    """(config, device) of a ported mode; raises for any other."""
    device_name, rest = split_device_flag(sys.argv[1:] if argv is None else argv)
    cfg = parse_with_config(rest)
    if cfg.mode not in PORTED_MODES:
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


def train(cfg: Config, device: torch.device) -> Optional[str]:
    """`--mode train`: train from the seed's init (or, under --resume, from
    the newest checkpoint), evaluating after every epoch; returns the path
    of the written parameters, or None when the run was preempted."""
    train_ds, val_ds, tfidf, tfidf_weights = build_datasets(cfg)
    # sized by the snapshotted ntoken, not the TF-IDF-extended dictionary's
    model = ReGAT(cfg, train_ds.ntoken, train_ds.v_dim, train_ds.num_ans)
    emb2_trainable = False
    if not cfg.synthetic:
        glove = np.load(os.path.join(cfg.data_folder, "glove", "glove6b_init_300d.npy")).squeeze()
        emb2_trainable = word_embedding_load_glove(
            model.w_emb, glove, cfg.op, tfidf, tfidf_weights)
    try:
        model, best = run_training(
            cfg, train_ds, val_ds, model, device, emb2_trainable=emb2_trainable)
    except Preempted as e:
        # the state is checkpointed; the unfinished run writes no final file
        print(
            f"preempted at {e} — checkpoint saved; rerun the same command with "
            f"--resume to continue",
            flush=True,
        )
        return None
    path = final_model_path(cfg)
    save_npz(path, model)
    print(f"saved final model to {path} (best eval score {best:.4f})", flush=True)
    return path


def evaluate(cfg: Config, device: torch.device) -> Tuple[float, float]:
    """`--mode eval`: one pass over the val split -> (score %, mean loss).
    The loss is printed in full, so it can be held to the training run's
    last `eval_loss` in metrics.jsonl."""
    ds = build_datasets(cfg)[1]
    model = load_model(cfg, ds)
    logger = Logger(os.path.join(cfg.output, "eval_log.txt"))
    try:
        score, loss, _ = run_evaluation(cfg, ds, model, device, logger)
        logger.write(f"Final eval score: {score:.4f} (eval loss {loss!r})")
    finally:
        logger.close()
    return score, loss


def predict(cfg: Config, device: torch.device) -> str:
    """`--mode predict`: the submission JSON of the split; returns its path."""
    ds = build_datasets(cfg)[1]
    model = load_model(cfg, ds)
    logger = Logger(os.path.join(cfg.output, "predict_log.txt"))
    try:
        path = run_prediction(cfg, ds, model, device, logger)
    finally:
        logger.close()
    print(f"predictions: {path}", flush=True)
    return path


def ensemble_eval(cfg: Config, device: torch.device) -> float:
    """`--mode ensemble_eval`: the score (%) of --ensemble_checkpoints."""
    ds = build_datasets(cfg)[1]
    logger = Logger(os.path.join(cfg.output, "eval_log.txt"))
    try:
        score = run_ensemble_eval(cfg, ds, device, logger)
        logger.write(f"Final ensemble eval score: {score:.4f}")
    finally:
        logger.close()
    return score


def build_server(argv: Optional[List[str]] = None):
    """(server, batcher, engine) exactly as `--mode serve` runs them; the
    server is bound but not started."""
    cfg, device = parse(argv)
    if cfg.mode != "serve":
        raise ValueError(f"build_server builds --mode serve, not --mode {cfg.mode}")
    ds = build_datasets(cfg)[1]
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
    """Runs the mode; returns train's written path (None if preempted),
    eval's (score, loss), predict's JSON path or the ensemble's score."""
    cfg, device = parse(argv)
    if cfg.mode == "train":
        return train(cfg, device)
    if cfg.mode == "eval":
        return evaluate(cfg, device)
    if cfg.mode == "predict":
        return predict(cfg, device)
    if cfg.mode == "ensemble_eval":
        return ensemble_eval(cfg, device)
    return serve(argv)


if __name__ == "__main__":
    main()
