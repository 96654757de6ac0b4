"""tools/orbax_to_npz.py: the JAX package's Orbax checkpoints, written by
its own train/checkpoint.py at tiny widths, converted to the port's files
and read by the port's entry point on the CPU:

- a params-only directory (`save_params_only`) becomes an `.npz` whose
  `--mode eval` and `--mode predict` match JAX's run_evaluation and
  run_prediction on the Orbax directory (eval loss rtol 1e-5, equal
  answers);
- a `checkpoints/` root (`save_checkpoint` of a train state with moments
  and a count, meta.json with JAX's run signature) becomes the port's root:
  each `state.npz` equals JAX's state leaf for leaf (parameters, Adamax
  `mu`, `nu`, the count), and the port's `--resume` starts at the next
  epoch with JAX's best score;
- the port's `load_params`, `--resume` and ensemble member loading refuse
  a raw Orbax directory, naming the converter.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.config import parse_with_config as jax_parse
from tf_vqa_regat_tpu.data.fixtures import synthetic_dataset as jax_synthetic_dataset
from tf_vqa_regat_tpu.models.regat import init_regat
from tf_vqa_regat_tpu.models.regat import trainable_mask as jax_trainable_mask
from tf_vqa_regat_tpu.parallel.mesh import make_mesh
from tf_vqa_regat_tpu.train import checkpoint as jax_ckpt
from tf_vqa_regat_tpu.train.logging import Logger as JaxLogger
from tf_vqa_regat_tpu.train.loop import _run_signature as jax_run_signature
from tf_vqa_regat_tpu.train.loop import run_evaluation as jax_run_evaluation
from tf_vqa_regat_tpu.train.loop import run_prediction as jax_run_prediction
from tf_vqa_regat_tpu.train.optim import make_optimizer
from tf_vqa_regat_tpu.train.step import init_train_state
from tf_vqa_regat_tpu_torch.main import main
from tf_vqa_regat_tpu_torch.params import flatten_tree, load_npz
from tf_vqa_regat_tpu_torch.train import checkpoint as ckpt
from tf_vqa_regat_tpu_torch.train import loop

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--config", os.path.join(REPO, "configs", "butd_vqa.json"), "--num_hid", "32",
        "--relation_dim", "48", "--num_heads", "4", "--nongt_dim", "6",
        "--imp_pos_emb_dim", "16", "--num_rois", "12", "--synthetic",
        "--synthetic_train_size", "64", "--synthetic_val_size", "32", "--batch_size", "16",
        "--eval_batch", "8", "--print_freq", "100"]
STEPS_PER_EPOCH, BEST = 4, 12.5


def _tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_npz", os.path.join(REPO, "tools", "orbax_to_npz.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _split(cfg, name):
    size, seed = ((cfg.synthetic_train_size, cfg.seed) if name == "train"
                  else (cfg.synthetic_val_size, cfg.seed + 1))
    return jax_synthetic_dataset(num_images=max(size // 8, 8), num_questions=size,
                                 adaptive=cfg.adaptive, seed=seed, name=name)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """JAX's files: (cfg, params tree, params-only dir, the train state
    (host numpy), its run's output dir), and the converter's outputs."""
    tmp = tmp_path_factory.mktemp("orbax")
    cfg = jax_parse(ARGV + ["--output", str(tmp / "jax") + "/"])
    val = _split(cfg, "val")
    params = jax.jit(lambda k: init_regat(k, cfg, val.ntoken, val.v_dim, val.num_ans))(
        jax.random.PRNGKey(7))
    params_dir = jax_ckpt.save_params_only(cfg.output, cfg.relation_type, cfg.fusion, params)
    # a train state whose moments and count are not the init's
    opt = make_optimizer(cfg.base_lr, cfg.grad_clip, STEPS_PER_EPOCH, cfg.lr_decay_rate,
                         cfg.lr_decay_step, jax_trainable_mask(params, False))
    state = jax.device_get(init_train_state(params, opt, make_mesh(1, 1, jax.devices()[:1])))
    rng = np.random.default_rng(0)
    state["opt_state"] = jax.tree.map(
        lambda x: (np.full_like(x, 3) if np.ndim(x) == 0
                   else rng.random(np.shape(x)).astype(np.asarray(x).dtype)),
        state["opt_state"])
    state["step"] = np.asarray(3, np.int32)
    jax_ckpt.save_checkpoint(cfg.output, state, 0, BEST, True, block=True,
                             run_sig=jax_run_signature(cfg, STEPS_PER_EPOCH, "device", 1))
    tool = _tool()
    npz = tool.convert(params_dir, str(tmp / "converted" / "model"))
    root = tool.convert(os.path.join(cfg.output, "checkpoints"),
                        str(tmp / "port" / "checkpoints"))
    return cfg, params, params_dir, state, npz, root, tmp


def test_params_only_eval_and_predict_match_jax(written):
    cfg, params, params_dir, _, npz, _, tmp = written
    assert npz.endswith(".npz")
    assert set(load_npz(npz)) == set(flatten_tree(jax.tree.map(np.asarray, params)))
    val = _split(cfg, "val")
    restored = jax_ckpt.load_params(params_dir, params)
    _, want_loss, _ = jax_run_evaluation(cfg, val, restored, JaxLogger(str(tmp / "jax.txt")))
    os.makedirs(tmp / "jax_pred")
    want_path = jax_run_prediction(cfg.replace(output=str(tmp / "jax_pred") + "/"), val,
                                   restored, JaxLogger(str(tmp / "jax_pred.txt")))
    out = ["--device", "cpu", "--checkpoint", npz, "--output", str(tmp / "port_eval") + "/"]
    _, loss = main(ARGV + out + ["--mode", "eval"])
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    path = main(ARGV + out + ["--mode", "predict"])
    with open(path) as fh, open(want_path) as gh:
        assert json.load(fh) == json.load(gh)


def test_converted_state_equals_jax_leaf_for_leaf(written):
    _, _, _, state, _, root, _ = written
    assert sorted(os.listdir(root)) == ["best", "epoch_0000", "meta.json"]
    adam = state["opt_state"][1][0]
    want = {**flatten_tree(state["params"]),
            **{f"opt/mu/{k}": v for k, v in flatten_tree(adam.mu).items()},
            **{f"opt/nu/{k}": v for k, v in flatten_tree(adam.nu).items()}}
    for name in ("epoch_0000", "best"):
        got = load_npz(os.path.join(root, name, ckpt.STATE_FILE))
        assert int(got.pop("opt/count")) == 3
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_resume_on_converted_root_starts_next_epoch(written, monkeypatch):
    _, _, _, _, _, root, tmp = written
    points = []
    real = loop._resume_point

    def spy(*a, **k):
        points.append(real(*a, **k))
        return points[-1]

    monkeypatch.setattr(loop, "_resume_point", spy)
    out = os.path.dirname(root)
    main(ARGV + ["--device", "cpu", "--mode", "train", "--epochs", "2", "--resume",
                 "--output", out + "/"])
    assert points == [(1, 0, None, BEST)]
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        assert [json.loads(line)["epoch"] for line in fh] == [1]


def test_raw_orbax_directories_are_refused_naming_the_tool(written, tmp_path):
    cfg, _, params_dir, _, _, _, _ = written
    with pytest.raises(ValueError, match="tools/orbax_to_npz.py"):
        ckpt.load_params(params_dir)
    with pytest.raises(ValueError, match="tools/orbax_to_npz.py"):
        main(ARGV + ["--device", "cpu", "--mode", "eval", "--checkpoint", params_dir,
                     "--output", str(tmp_path) + "/"])
    with pytest.raises(ValueError, match="tools/orbax_to_npz.py"):
        main(ARGV + ["--device", "cpu", "--mode", "ensemble_eval", "--ensemble_checkpoints",
                     f"implicit:{params_dir}", "--output", str(tmp_path) + "/"])
    with pytest.raises(ValueError, match="tools/orbax_to_npz.py"):
        main(ARGV + ["--device", "cpu", "--mode", "train", "--epochs", "2", "--resume",
                     "--output", cfg.output])
