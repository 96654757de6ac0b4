"""Real-dataset preflight of the port (counterpart of tools/preflight.py):
run it against a converted `--data_folder` before the first real training
run, to learn which --feature_dtype and --data_mode a run will take.

    python -m tf_vqa_regat_tpu_torch.preflight --data_folder ./data --adaptive \\
        [--budget_gb 8] [--splits train,val] [--relation_type implicit] \\
        [--sample_rows 4096] [--tfidf] [--json]

Reports, per split:
  1. the file inventory: every path the port's loaders open, the converted
     feature directory (data/convert.py's `.npy` files and `meta.json`) in
     place of the HDF5 file, with sizes and MISSING markers;
  2. the device-table estimate at f32, bf16 and int8 (data/store.py::
     estimate_nbytes, JAX's count) and the eval-only `--data_mode auto`
     resolution at `--budget_gb` (what --mode eval and predict take for this
     split; serve refuses a split over the budget), one process; with train
     and val both listed, the joint `--mode train` resolution (each split
     against half the budget), exactly the call run_training makes;
  3. the int8 quantization check on a strided sample of the split's real
     feature rows through the port's `quantize_rows`: relative L2 error and
     the outlier ratio rowmax / row-RMS;
and the card's total memory when a CUDA device is visible.

Nothing is uploaded and the entry tables are not joined: the estimate's
entry terms come from the question file's length, the feature table is
memory-mapped and only the sampled rows are read. There is no sharded
column: the sharded store is not ported (ROADMAP Queue A, multi-device).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.dictionary import Dictionary
from tf_vqa_regat_tpu_torch.data.entries import EntryTable, question_path
from tf_vqa_regat_tpu_torch.data.features import (
    META,
    VQADataset,
    converted_dir,
    load_feature_store,
    split_stem,
)
from tf_vqa_regat_tpu_torch.data.store import estimate_nbytes, quantize_rows
from tf_vqa_regat_tpu_torch.train.loop import resolve_data_mode

DTYPES = ("float32", "bfloat16", "int8")


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1000:
            return f"{n:.1f} {unit}"
        n /= 1000
    return f"{n:.1f} TB"


def inventory(dataroot: str, name: str, adaptive: bool, tfidf: bool
              ) -> List[Tuple[str, bool, int]]:
    """(path, exists, size) for every file the split's load reads."""
    stem = split_stem(name, adaptive)
    feat = converted_dir(dataroot, name, adaptive)
    paths = [
        os.path.join(dataroot, "glove", "dictionary.pkl"),
        os.path.join(dataroot, "glove", "glove6b_init_300d.npy"),
        os.path.join(dataroot, "cache", "trainval_ans2label.pkl"),
        os.path.join(dataroot, "cache", "trainval_label2ans.pkl"),
        question_path(dataroot, name),
        os.path.join(dataroot, "imgids", f"{stem}_imgid2idx.pkl"),
        os.path.join(feat, META),
        os.path.join(feat, "image_features.npy"),
        os.path.join(feat, "spatial_features.npy"),
        os.path.join(feat, "image_bb.npy"),
    ]
    if adaptive:
        paths.append(os.path.join(feat, "pos_boxes.npy"))
    if "test" not in name:
        paths.append(os.path.join(dataroot, "cache", f"{name}_target.pkl"))
    if tfidf:
        paths += [
            os.path.join(dataroot, "tfidf", "indices.npy"),
            os.path.join(dataroot, "tfidf", "values.npy"),
            os.path.join(dataroot, "glove", "glove.6B.300d.txt"),
        ]
    return [(p, os.path.exists(p), os.path.getsize(p) if os.path.exists(p) else 0)
            for p in paths]


def sized_split(dataroot: str, name: str, adaptive: bool, relation_type: str) -> VQADataset:
    """The split with its feature table memory-mapped and stand-in entries
    of the question file's length (JAX's preflight: the estimate reads only
    the entry count and the question width)."""
    store = load_feature_store(dataroot, name, adaptive, relation_type, mmap=True)
    with open(question_path(dataroot, name)) as fh:
        n_q = len(json.load(fh)["questions"])
    ent = EntryTable(
        question_ids=np.zeros(n_q, np.int64),
        image_ids=np.zeros(n_q, np.int64),
        image_index=(np.arange(n_q) % max(store.num_images, 1)).astype(np.int32),
        q_tokens=np.zeros((n_q, 14), np.int32),
        label_offsets=np.zeros(n_q + 1, np.int64),
        labels=np.zeros(0, np.int32),
        scores=np.zeros(0, np.float32),
        has_answers=False,
    )
    return VQADataset(name=name, entries=ent, store=store, num_ans=3129, label2ans=[],
                      dictionary=Dictionary(), relation_type=relation_type, ntoken=19901)


def _cfg(ds: VQADataset, dtype: str, budget_gb: float, relation_type: str) -> Config:
    return Config(batch_size=256, adaptive=ds.store.adaptive, feature_dtype=dtype,
                  device_store_budget_gb=budget_gb, relation_type=relation_type)


def estimate_tables(ds: VQADataset, budget_gb: float, relation_type: str
                    ) -> List[Tuple[str, int, str]]:
    """(dtype, device bytes, eval-only auto mode) per feature dtype."""
    include_adj = relation_type in ("semantic", "spatial")
    return [(dtype, estimate_nbytes(ds, include_adj, dtype),
             resolve_data_mode(_cfg(ds, dtype, budget_gb, relation_type), ds, None, include_adj))
            for dtype in DTYPES]


def train_run_modes(train_ds: VQADataset, val_ds: VQADataset, budget_gb: float,
                    relation_type: str) -> Dict[str, str]:
    """dtype -> the mode `--mode train --data_mode auto` takes: both splits
    resolved jointly, each against half the budget."""
    include_adj = relation_type in ("semantic", "spatial")
    return {dtype: resolve_data_mode(_cfg(val_ds, dtype, budget_gb, relation_type), val_ds,
                                     train_ds, include_adj)
            for dtype in DTYPES}


def int8_check(features: np.ndarray, sample_rows: int) -> Dict[str, float]:
    """Per-row int8 quantization error on a strided sample of the table's
    rows (JAX preflight's int8_check through the port's quantize_rows):
    relative L2 error (mean, max) and the 99th percentile of rowmax /
    row-RMS."""
    flat = features.reshape(-1, features.shape[-1])
    n = flat.shape[0]
    step = max(n // max(min(sample_rows, n), 1), 1)
    block = 64
    rel_errs, ratios, got = [], [], 0
    for lo in range(0, n, step * block):
        chunk = np.asarray(flat[lo : min(lo + block, n)], np.float32)
        q, s = quantize_rows(chunk)
        deq = q.astype(np.float32) * s[:, None]
        norm = np.linalg.norm(chunk, axis=1)
        ok = norm > 0
        rel_errs.append(np.linalg.norm(chunk - deq, axis=1)[ok] / norm[ok])
        rms = norm[ok] / np.sqrt(chunk.shape[1])
        ratios.append(np.abs(chunk[ok]).max(axis=1) / np.maximum(rms, 1e-12))
        got += int(ok.sum())
        if got >= sample_rows:
            break
    rel = np.concatenate(rel_errs) if rel_errs else np.zeros(1)
    rat = np.concatenate(ratios) if ratios else np.zeros(1)
    return {"rel_err_mean": float(rel.mean()), "rel_err_max": float(rel.max()),
            "outlier_ratio_p99": float(np.percentile(rat, 99)), "n_sampled": int(len(rel))}


def card_memory() -> Optional[Dict[str, object]]:
    """The first CUDA device's name and total memory, or None without one."""
    if not torch.cuda.is_available():
        return None
    props = torch.cuda.get_device_properties(0)
    return {"name": props.name, "total_bytes": int(props.total_memory)}


def report(args: argparse.Namespace) -> dict:
    rep: dict = {"data_folder": args.data_folder, "budget_gb": args.budget_gb, "splits": {},
                 "card": card_memory()}
    say = (lambda *a: None) if args.json else print
    loaded: Dict[str, VQADataset] = {}
    ok = True
    for name in [s.strip() for s in args.splits.split(",") if s.strip()]:
        inv = inventory(args.data_folder, name, args.adaptive, args.tfidf)
        missing = [p for p, exists, _ in inv if not exists]
        split = {"files": [{"path": p, "exists": e, "bytes": n} for p, e, n in inv],
                 "missing": missing}
        rep["splits"][name] = split
        say(f"== split {name!r} ==")
        for p, exists, n in inv:
            say(f"  [{'ok ' if exists else 'MISSING'}] {p}"
                + (f" ({_fmt_bytes(n)})" if exists else ""))
        if missing:
            ok = False
            say(f"  -> {len(missing)} file(s) missing; skipping estimates")
            continue
        ds = sized_split(args.data_folder, name, args.adaptive, args.relation_type)
        loaded[name] = ds
        rows = estimate_tables(ds, args.budget_gb, args.relation_type)
        split["estimates"] = [{"feature_dtype": d, "device_bytes": b, "auto_mode": m}
                              for d, b, m in rows]
        say(f"  questions: {len(ds):,}; feature rows: "
            f"{int(np.prod(ds.store.features.shape[:-1])):,} x {ds.store.v_dim}")
        say(f"  {'dtype':9s} {'on the card':>12s}  auto at {args.budget_gb:g} GB (eval-only)")
        for d, b, m in rows:
            say(f"  {d:9s} {_fmt_bytes(b):>12s}  {m}")
        chk = int8_check(ds.store.features, args.sample_rows)
        split["int8_check"] = chk
        say(f"  int8 sample ({chk['n_sampled']} rows): rel L2 err mean "
            f"{chk['rel_err_mean']:.4f} / max {chk['rel_err_max']:.4f}; outlier ratio p99 "
            f"{chk['outlier_ratio_p99']:.1f}")
        if chk["rel_err_max"] > 0.05 or chk["outlier_ratio_p99"] > 20:
            say("  !! heavy outlier structure: per-row int8 loses >5% of some rows; validate "
                "training before trusting --feature_dtype int8")
    if "train" in loaded and "val" in loaded:
        modes = train_run_modes(loaded["train"], loaded["val"], args.budget_gb,
                                args.relation_type)
        rep["train_run_auto_mode"] = modes
        say(f"== `--mode train` resolution (train and val jointly, "
            f"{args.budget_gb / 2:g} GB per split) ==")
        for d, m in modes.items():
            say(f"  {d:9s} auto-> {m}")
    if rep["card"] is not None:
        say(f"card: {rep['card']['name']}, {_fmt_bytes(rep['card']['total_bytes'])} in all")
    rep["ok"] = ok
    return rep


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data_folder", required=True)
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--splits", default="train,val")
    ap.add_argument("--budget_gb", type=float, default=8.0)
    ap.add_argument("--sample_rows", type=int, default=4096)
    ap.add_argument("--relation_type", default="implicit")
    ap.add_argument("--tfidf", action="store_true")
    ap.add_argument("--json", action="store_true", help="one JSON object on stdout")
    args = ap.parse_args(argv)
    rep = report(args)
    if args.json:
        print(json.dumps(rep))
    elif not rep["ok"]:
        print("PREFLIGHT: missing files: convert or copy them before training")
    else:
        print("PREFLIGHT: all files present; see the estimates above")
    if not rep["ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
