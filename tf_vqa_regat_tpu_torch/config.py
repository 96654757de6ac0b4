"""Configuration of the port: the reference's argparse surface with the JSON
overlay (JSON overrides defaults, flags given on the command line win), as
tf_vqa_regat_tpu/config.py has it, so `--config configs/*.json` parses the
same way in both packages.

The port carries its own copy so that it runs without the JAX package. It
holds the reference's flags (reference main.py:14-97), every key the JSON
configs use, and the extensions the port implements: every field of the JAX
Config but three that name TPU or JAX machinery (`prng_impl`, `sp_rois`,
`use_pallas`), whose flags the parser rejects. Each field keeps the JAX
package's name, type and default (a CPU test checks).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, List, Optional


@dataclasses.dataclass
class Config:
    # --- reference contract (reference main.py:14-97) ---
    epochs: int = 20
    base_lr: float = 1e-3
    lr_decay_start: int = 15
    lr_decay_rate: float = 0.25
    lr_decay_step: int = 2
    grad_clip: float = 0.25
    batch_size: int = 8
    output: str = "saved_models/"
    seed: int = 42
    checkpoint: str = ""
    dataset: str = "vqa"  # vqa | vqa_cp
    data_folder: str = "./data"
    use_both: bool = False
    use_vg: bool = False
    adaptive: bool = False
    relation_type: str = "implicit"  # spatial | semantic | implicit
    fusion: str = "mutan"  # ban | butd | mutan
    tfidf: bool = False
    op: str = "c"
    num_hid: int = 1024
    imp_pos_emb_dim: int = 64
    spa_label_num: int = 11
    sem_label_num: int = 15
    dir_num: int = 2
    relation_dim: int = 1024
    nongt_dim: int = 20
    num_heads: int = 16
    num_steps: int = 1
    residual_connection: bool = False
    label_bias: bool = False
    dropout: float = 0.2
    print_freq: int = 500
    mode: str = "train"  # train | eval | serve | predict | ensemble_eval (ported) | export_h5
    lr_decay_based_on_val: bool = False  # in the reference's JSON, unused by its model

    # --- BAN and MuTAN, beyond the reference (the first three are JSON keys) ---
    ban_glimpse: int = 4
    mutan_rank: int = 15
    mutan_gamma: int = 2
    # MuTAN train option: one question-side input-dropout mask per example
    # in the attention block instead of one per roi, which keeps that side
    # per-example and so takes the rank-sum reassociation in train too
    # (models/mutan.py). Identical whenever no input dropout runs.
    mutan_shared_qdrop: bool = False

    # --- extensions the port implements ---
    # Static roi padding; 0 = 36 for the fixed layout, 100 adaptive.
    num_rois: int = 0
    # Data-parallel size (0 = every process of the group) and tensor-parallel
    # size; dp x tp must equal the process group's size (parallel/mesh.py).
    # At tp > 1 the model axis splits the attention heads and the
    # classifier; it must divide both (no uneven shards).
    dp_size: int = 0
    tp_size: int = 1
    # bf16 matmuls and bf16 activation storage; the parameters, the Adamax
    # state, the softmax statistics, the kernels' inputs and outputs, the
    # loss and the answer logits stay f32. Explicit casts where the JAX
    # package casts (models/regat.py, ban.py, mutan.py), for every fusion.
    compute_dtype: str = "float32"
    # Gradient accumulation: each optimizer batch splits into this many
    # strided microbatches (rows a, a+k, ...), run one after another; their
    # sum-loss gradients add up in f32 and ONE clip + Adamax update acts on
    # the batch mean, so the optimizer sees the single-pass step's
    # gradient, while the peak activation memory is one microbatch's. Each
    # microbatch draws its own dropout masks. 1 = the single-pass step.
    grad_accum: int = 1
    # Accepted for the JAX command line; no effect in the port. JAX folds
    # the two attention directions into one 2H-head computation in eval
    # only on its jnp path; the port's attention has the semantics of JAX's
    # Pallas path, where the flag changes nothing either.
    fold_dual_attention: bool = True
    # Memory-map the converted feature table (data/features.py) instead of
    # reading it into host RAM; the device store then converts and uploads
    # it chunk by chunk, so the host holds one chunk. Splits cannot be
    # composed from a mapped table (--use_both, --use_vg, vqa_cp).
    mmap_features: bool = False
    # Packed-feature cache directory ("" = off): the feature table converted
    # to --feature_dtype persists as .npy after the first run and later runs
    # memory-map it. JAX's key, signature and files, so one directory serves
    # both packages (data/cache.py).
    packed_cache: str = ""
    # The resident feature table's dtype: "bfloat16" (round to nearest even)
    # or "int8" (per-row symmetric quantization, scale = rowmax/127); the
    # gather widens to f32 (and dequantizes). Box tables stay f32: spatial
    # edge labels are discrete in them.
    feature_dtype: str = "float32"
    # Roi bucketing: comma-separated static roi sizes, e.g. "36,64,100";
    # each batch holds entries of one bucket and runs at that size. Images
    # with more boxes than the largest bucket are cut to it. Empty = one
    # static size (resolved_num_rois()).
    roi_buckets: str = ""
    # Eval batch size; 0 = the reference's batch_size // 4.
    eval_batch: int = 0
    # Eval, predict and ensemble batches per block on the device path: the
    # stream groups K batches of one roi size, the tail block padded with
    # all -1 batches, and a block's metrics are summed before they reach
    # the pass's accumulators (JAX's one program per block; on CUDA each
    # batch is a replay of the step's graph, train/graphs.py). 1 = one
    # batch per block.
    eval_block: int = 8
    # Train steps per block on the device path (JAX's one program per
    # block): 0 = auto, 8 on the device store and 1 on the host path
    # (train/loop.py::resolve_train_block); an explicit K > 1 on the host
    # path is refused. Under --roi_buckets the epoch stream groups K
    # same-bucket batches per block, which changes the order in which the
    # optimizer sees them (recorded in the resume signature); step lines,
    # step checkpoints and preemption fall on block boundaries. The tail
    # block runs its real steps only, which leaves the state as JAX's
    # padded no-op steps leave it.
    train_block: int = 0
    # Host-to-device prefetch depth of the host data path: batches packed
    # and copied ahead by a background thread (0 = in the caller's thread).
    prefetch: int = 2
    # Data path: "device" holds each split's tables on the card and gathers
    # a batch there; "sharded" partitions the images over the data-parallel
    # ranks, each holding its own images' rows (data/sharded_store.py);
    # "host" packs batches on the host and streams them (data/loader.py);
    # "auto" takes "device" when every split's tables (data/store.py::
    # estimate_nbytes at --feature_dtype) fit the budget, each split half of
    # it when a train split is present, else "sharded" at dp > 1 when every
    # split's per-shard tables fit, else "host" (train/loop.py::
    # resolve_data_mode, JAX's policy).
    data_mode: str = "auto"
    device_store_budget_gb: float = 8.0
    # --mode serve: port, fixed batch sizes, straggler wait.
    serve_port: int = 8000
    serve_batch_sizes: str = "1,8,32"
    serve_max_delay_ms: float = 5.0
    # --mode predict: the split whose submission JSON is written (test2015 |
    # test-dev2015 | val; answerless test splits work); with --synthetic the
    # synthetic val split.
    predict_split: str = "test2015"
    # --mode ensemble_eval: "implicit:PATH,spatial:PATH,semantic:PATH", each
    # PATH an .npz or a checkpoint directory (train/ensemble.py).
    ensemble_checkpoints: str = ""
    # Checkpoints under {output}/checkpoints/ (train/checkpoint.py): one per
    # epoch and the best; --resume continues from the newest.
    resume: bool = False
    save_every_epoch: bool = True
    # A step checkpoint every N optimizer steps (0 = per epoch only), from
    # which --resume continues inside the epoch, exactly.
    checkpoint_every_steps: int = 0
    # Snapshot on the device, write from a background thread (one in flight).
    async_checkpoint: bool = True
    # Keep only the newest N epoch checkpoints (0 = all); best/ and step
    # checkpoints take no slot.
    keep_ckpts: int = 0
    # --mode train: check every module's output for a non-finite value and
    # run the backward under autograd's anomaly mode; the first module or
    # autograd Function that yields one raises FloatingPointError (JAX's
    # jax_debug_nans). The steps then run eagerly (train/debug_nans.py).
    debug_nans: bool = False
    # --mode train profiling (train/profiling.py): a capture endpoint on this
    # port (0 = off; `GET /capture?duration_ms=N` records about N ms of
    # steps) and a torch.profiler trace of each epoch under this directory
    # ("" = off), written to {profile_dir}/epoch_NNNN/.
    profile_port: int = 0
    profile_dir: str = ""
    # Generated in-memory data with the real shapes instead of the dataset.
    synthetic: bool = False
    synthetic_train_size: int = 4096
    synthetic_val_size: int = 1024
    # The TF reference's two transcription bugs, reproduced on request (the
    # port, as the JAX package, fixes both by default): the question
    # self-attention's softmax over the BATCH axis, then a flat reshape
    # (models/language.py), and the row-sliced position matrix, flat
    # regrouped (ops/position.py::position_matrix_ref_compat).
    ref_compat_q_att: bool = False
    ref_compat_pos: bool = False

    def __post_init__(self) -> None:
        for field, allowed in (("feature_dtype", ("float32", "bfloat16", "int8")),
                               ("compute_dtype", ("float32", "bfloat16"))):
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(f"--{field} {v!r} is not one of {'|'.join(allowed)}")
        if self.data_mode not in ("auto", "device", "host", "sharded"):
            raise ValueError(
                f"--data_mode {self.data_mode!r} is not one of auto|device|host|sharded")
        if self.tp_size < 1 or self.dp_size < 0:
            raise ValueError(
                f"--dp_size must be >= 0 (0 = every process) and --tp_size >= 1, got "
                f"{self.dp_size}/{self.tp_size}"
            )
        # the model axis splits the heads and the classifier's hidden width
        # in equal parts (GSPMD would pad an uneven split; the port does not)
        split = [("--num_heads", self.num_heads)]
        if self.fusion != "mutan":  # MuTAN has no classifier
            split.append(("the classifier's hidden width (2 * --num_hid)", 2 * self.num_hid))
        for name, n in split:
            if n % self.tp_size:
                raise ValueError(
                    f"--tp_size {self.tp_size} does not divide {name} = {n}: tensor "
                    f"parallelism splits it in equal parts"
                )
        sizes = [x for x in self.serve_batch_sizes.split(",") if x.strip()]
        if not sizes or any(int(x) <= 0 for x in sizes):
            raise ValueError(
                f"--serve_batch_sizes needs >=1 positive sizes, got "
                f"{self.serve_batch_sizes!r}"
            )
        if self.train_block < 0 or self.eval_block < 0:
            raise ValueError(
                f"--train_block/--eval_block must be >= 0 (0 = auto for "
                f"train / off for eval; 1 disables blocking), got "
                f"{self.train_block}/{self.eval_block}"
            )
        if self.grad_accum < 1:
            raise ValueError(f"--grad_accum must be >= 1, got {self.grad_accum}")
        if self.serve_max_delay_ms < 0:
            raise ValueError(
                f"--serve_max_delay_ms must be >= 0, got {self.serve_max_delay_ms}"
            )

    def resolved_eval_batch(self, dp: int = 1) -> int:
        """The eval batch (0: the reference's batch_size // 4), rounded up to
        a multiple of the data-parallel size `dp` (the batch is split over
        the ranks)."""
        base = self.eval_batch if self.eval_batch > 0 else max(self.batch_size // 4, 1)
        return -(-base // dp) * dp

    def resolved_num_rois(self) -> int:
        if self.num_rois > 0:
            return self.num_rois
        return 100 if self.adaptive else 36

    def parsed_roi_buckets(self) -> Optional[List[int]]:
        buckets = sorted(int(x) for x in self.roi_buckets.split(",") if x.strip())
        return buckets or None

    @property
    def word_dim(self) -> int:
        return 600 if "c" in self.op else 300

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


_BOOL_FLAGS = {f.name for f in dataclasses.fields(Config) if f.type in ("bool", bool)}


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="ReGAT, PyTorch port")
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        if f.name in _BOOL_FLAGS:
            # `--flag` sets True, `--no-flag` clears a default-True field.
            parser.add_argument(name, action=argparse.BooleanOptionalAction, default=f.default)
        else:
            parser.add_argument(name, type=type(f.default), default=f.default)
    parser.add_argument("--config", type=str, default=None, help="JSON config file")
    return parser


def parse_with_config(argv: Optional[List[str]] = None) -> Config:
    """JSON values override defaults; flags present on the command line win
    (reference config/parser.py:13-23)."""
    if argv is None:
        argv = sys.argv[1:]
    args = build_arg_parser().parse_args(argv)
    if args.config is not None:
        with open(args.config) as fh:
            config_args = json.load(fh)
        override_keys = set()
        for a in argv:
            if not a.startswith("--"):
                continue
            k = a[2:].split("=")[0]
            if k.startswith("no-"):
                k = k[3:]
            override_keys.add(k)
        known = {f.name for f in dataclasses.fields(Config)}
        for k, v in config_args.items():
            if k in override_keys:
                continue
            if k not in known:
                raise ValueError(f"Unknown config key in JSON: {k!r}")
            setattr(args, k, v)
    d = vars(args)
    d.pop("config", None)
    return Config(**d)
