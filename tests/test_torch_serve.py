"""The port's `--mode serve` on the CPU (`--device cpu`), built through
`tf_vqa_regat_tpu_torch.main.build_server` exactly as the entry point builds
it, against the JAX package's InferenceEngine holding the same parameters;
plus the port's synthetic split, config parser and tokenizer against the
JAX package's, and the import hygiene of the port (no JAX, no h5py, nothing
of the JAX package)."""

import dataclasses
import glob
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu import config as jconfig
from tf_vqa_regat_tpu.config import parse_with_config
from tf_vqa_regat_tpu.data.dictionary import encode_question as jax_encode_question
from tf_vqa_regat_tpu.data.fixtures import make_dictionary as jax_make_dictionary
from tf_vqa_regat_tpu.data.fixtures import synthetic_dataset as jax_synthetic_dataset
from tf_vqa_regat_tpu.models.regat import init_regat
from tf_vqa_regat_tpu.serve import InferenceEngine as JaxInferenceEngine
from tf_vqa_regat_tpu_torch import config as tconfig
from tf_vqa_regat_tpu_torch.data.dictionary import encode_question
from tf_vqa_regat_tpu_torch.data.synthetic import make_dictionary, synthetic_dataset
from tf_vqa_regat_tpu_torch.main import build_server, split_device_flag
from tf_vqa_regat_tpu_torch.params import flatten_tree

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Small widths; the synthetic split keeps its real 2048-d features and 3,129
# answers. 16 questions over 8 images.
FLAGS = [
    "--mode", "serve", "--synthetic", "--relation_type", "implicit",
    "--fusion", "butd", "--adaptive", "--residual_connection",
    "--num_hid", "64", "--relation_dim", "96", "--num_heads", "4",
    "--nongt_dim", "10", "--num_rois", "24", "--synthetic_val_size", "16",
    "--serve_batch_sizes", "1,4", "--serve_max_delay_ms", "20", "--serve_port", "0",
]


def test_synthetic_split_equals_the_jax_fixture():
    ours = synthetic_dataset(num_images=9, num_questions=30, v_dim=16, num_ans=20, seed=3)
    ref = jax_synthetic_dataset(
        num_images=9, num_questions=30, v_dim=16, num_ans=20, seed=3, adaptive=True
    )
    for a, b in [
        (ours.store.features, ref.store.features),
        (ours.store.normalized_bb, ref.store.normalized_bb),
        (ours.store.bb, ref.store.bb),
        (ours.store.pos_boxes, ref.store.pos_boxes),
    ]:
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for field in [f.name for f in dataclasses.fields(ours.entries)]:
        a, b = np.asarray(getattr(ours.entries, field)), np.asarray(getattr(ref.entries, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert ours.label2ans == ref.label2ans and ours.num_ans == ref.num_ans
    assert ours.ntoken == ref.ntoken and ours.padding_idx == ref.padding_idx
    assert ours.dictionary.word2idx == ref.dictionary.word2idx


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.json"))))
def test_config_parses_as_the_jax_config(path):
    """Every port field has the JAX field's name, type and default, and a
    JSON config with command-line overrides parses to the same values."""
    jax_fields = {f.name: f for f in dataclasses.fields(jconfig.Config)}
    for f in dataclasses.fields(tconfig.Config):
        assert f.name in jax_fields, f.name
        assert (f.type, f.default) == (jax_fields[f.name].type, jax_fields[f.name].default), f.name
    argv = ["--config", path, "--mode", "serve", "--num_hid", "64", "--no-adaptive"]
    ours, ref = tconfig.parse_with_config(argv), jconfig.parse_with_config(argv)
    for f in dataclasses.fields(tconfig.Config):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert ours.resolved_num_rois() == ref.resolved_num_rois() == 36
    assert ours.word_dim == ref.word_dim
    with pytest.raises(SystemExit):  # a "Do not port" flag is refused
        tconfig.parse_with_config(["--use_pallas"])


def test_tokenizer_matches_the_jax_tokenizer():
    ours, ref = make_dictionary(), jax_make_dictionary()
    assert ours.word2idx == ref.word2idx
    for q in ["What is the COLOR of the dog's car?", "how many people, on the left",
              "zebra unicorn?", "", "a " * 20]:
        assert encode_question(ours, q) == jax_encode_question(ref, q)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(base URL, port engine, JAX engine) over the same parameters."""
    cfg = parse_with_config(FLAGS)
    ds = jax_synthetic_dataset(
        num_images=8, num_questions=16, adaptive=True, seed=cfg.seed + 1, name="val"
    )
    params = init_regat(jax.random.PRNGKey(0), cfg, ds.ntoken, ds.v_dim, ds.num_ans)
    path = str(tmp_path_factory.mktemp("ckpt") / "model.npz")
    np.savez(path, **flatten_tree(jax.tree.map(np.asarray, params)))
    server, batcher, engine = build_server(
        FLAGS + ["--checkpoint", path, "--device", "cpu"]
    )
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    jax_engine = JaxInferenceEngine(cfg, ds, params, batch_sizes=(1, 4))
    yield f"http://127.0.0.1:{server.server_address[1]}", engine, jax_engine
    server.shutdown()
    batcher.close()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url, body):
    req = urllib.request.Request(
        url + "/predict", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


QUESTIONS = ["what color is the cat ?", "how many people are on the left ?",
             "is the car red ?", "what is the man on ?", "blue or green ?"]
IMAGE_IDS = [0, 3, 5, 7, 3]


def test_healthz(served):
    url, engine, _ = served
    with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok" and body["model"] == "implicit-butd"
    assert body["batch_sizes"] == [1, 4] and body["num_answers"] == 3129
    assert body["device"] == "cpu" and engine.device == torch.device("cpu")


def test_single_predictions_match_jax_engine(served):
    url, _, jax_engine = served
    for q, iid in zip(QUESTIONS[:3], IMAGE_IDS[:3]):
        code, body = _post(url, {"question": q, "image_id": iid})
        assert code == 200
        want = jax_engine.infer([q], [iid])[0]
        assert body["answer"] == want["answer"]
        assert body["confidence"] == pytest.approx(want["confidence"], abs=1e-4)
        assert 0.0 < body["confidence"] < 1.0


def test_batch_prediction_matches_jax_engine(served):
    """Five items: one chunk of 4 and a tail of 1 (both fixed sizes)."""
    url, engine, jax_engine = served
    code, body = _post(url, [{"question": q, "image_id": i}
                             for q, i in zip(QUESTIONS, IMAGE_IDS)])
    assert code == 200 and len(body) == 5
    want = jax_engine.infer(QUESTIONS, IMAGE_IDS)
    assert [b["answer"] for b in body] == [w["answer"] for w in want]
    assert body == engine.infer(QUESTIONS, IMAGE_IDS)


def test_unknown_image_and_malformed_requests(served):
    url, _, _ = served
    code, body = _post(url, {"question": "what ?", "image_id": 999})
    assert code == 404 and "unknown image_id" in body["error"]
    code, body = _post(url, [{"question": "what ?", "image_id": 999},
                             {"question": "what ?", "image_id": 1}])
    assert code == 200 and "error" in body[0] and "answer" in body[1]
    assert _post(url, 5)[0] == 400
    assert _post(url, [{"question": "no image"}])[0] == 400


def test_device_flag_and_unported_modes():
    assert split_device_flag(["--mode", "serve", "--device", "cpu"]) == ("cpu", ["--mode", "serve"])
    assert split_device_flag(["--device=cuda:1"]) == ("cuda:1", [])
    assert split_device_flag([])[0] == "cuda"
    with pytest.raises(NotImplementedError, match="persistence and the other modes"):
        build_server(["--mode", "export_h5", "--device", "cpu"])
    with pytest.raises(ValueError, match="builds --mode serve"):
        build_server(["--mode", "train", "--fusion", "butd", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_server(FLAGS + ["--checkpoint", "x.npz", "--device", "cuda"])


def test_unconverted_data_folder_names_the_converter(tmp_path):
    """Without --synthetic, a data folder whose HDF5 files were never
    converted is refused with the converter's command."""
    from tf_vqa_regat_tpu.data.fixtures import write_fixture

    write_fixture(str(tmp_path), name="val", num_images=4, num_questions=6)
    argv = [a for a in FLAGS if a != "--synthetic"]
    with pytest.raises(FileNotFoundError,
                       match="python -m tf_vqa_regat_tpu_torch.data.convert --data_folder"):
        build_server(argv + ["--data_folder", str(tmp_path), "--checkpoint", "x.npz",
                             "--device", "cpu"])


def test_port_imports_no_jax_and_no_h5py():
    """In a fresh interpreter (this test process already holds JAX, which
    tests/conftest.py imports): neither JAX, h5py nor the JAX package."""
    code = (
        "import sys\n"
        "import tf_vqa_regat_tpu_torch.main, tf_vqa_regat_tpu_torch.serve\n"
        "import tf_vqa_regat_tpu_torch.ops.kernels.implicit_attention\n"
        "import tf_vqa_regat_tpu_torch.train.loop\n"
        "import tf_vqa_regat_tpu_torch.train.checkpoint, tf_vqa_regat_tpu_torch.train.ensemble\n"
        "import tf_vqa_regat_tpu_torch.data.convert, tf_vqa_regat_tpu_torch.data.compose\n"
        "import tf_vqa_regat_tpu_torch.data.loader, tf_vqa_regat_tpu_torch.data.native\n"
        "import tf_vqa_regat_tpu_torch.preflight, tf_vqa_regat_tpu_torch.profile_step\n"
        "import tf_vqa_regat_tpu_torch.parallel.distributed, tf_vqa_regat_tpu_torch.parallel.mesh\n"
        "import tf_vqa_regat_tpu_torch.parallel.tensor\n"
        "import tf_vqa_regat_tpu_torch.data.sharded_store\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'jaxlib', 'orbax', 'h5py', 'tf_vqa_regat_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
