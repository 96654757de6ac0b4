"""The port's dataset compositions against the JAX package's, on the CPU,
over JAX's `write_fixture` + `write_cp_vg_fixture` files converted by the
port's data/convert.py (tests/test_compose.py is the JAX pattern):
`--use_both`, `--use_vg` (with and without `--use_both`, whose val images
take the offset past the train images), `--dataset vqa_cp` (both splits
over one merged store), an ensemble's store, `--tfidf`, fixed-36
`merge_stores`, the Visual Genome answer normalization, and the
`--mmap_features` composition refusal in every mode. The port's entry point
`build_datasets` is held to JAX main.py's, dataset for dataset, bit for
bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.config import parse_with_config as jax_parse
from tf_vqa_regat_tpu.data.compose import merge_stores as jax_merge_stores
from tf_vqa_regat_tpu.data.compose import preprocess_answer as jax_preprocess_answer
from tf_vqa_regat_tpu.data.dictionary import Dictionary as JaxDictionary
from tf_vqa_regat_tpu.data.features import load_vqa_dataset as jax_load_vqa_dataset
from tf_vqa_regat_tpu.data.fixtures import write_cp_vg_fixture, write_fixture
from tf_vqa_regat_tpu_torch.config import parse_with_config
from tf_vqa_regat_tpu_torch.data.compose import merge_stores, preprocess_answer
from tf_vqa_regat_tpu_torch.data.convert import convert
from tf_vqa_regat_tpu_torch.data.dictionary import Dictionary
from tf_vqa_regat_tpu_torch.data.features import load_vqa_dataset
from tf_vqa_regat_tpu_torch.data.store import DeviceStore
from tf_vqa_regat_tpu_torch.main import build_datasets

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CPU = torch.device("cpu")

STORE_KEYS = ("features", "normalized_bb", "bb", "pos_boxes", "semantic_adj", "spatial_adj")


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    write_fixture(root, name="train", num_images=6, num_questions=12, seed=0,
                  first_image_id=1000, semantic=True)
    write_fixture(root, name="val", num_images=4, num_questions=8, seed=1,
                  first_image_id=2000, first_question_id=100, semantic=True)
    write_cp_vg_fixture(root)
    convert(root, ["train", "val"])
    return root


def same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), what


def assert_datasets_equal(ours, ref):
    assert (ours is None) == (ref is None)
    if ours is None:
        return
    for f in dataclasses.fields(ours.entries):
        same(getattr(ours.entries, f.name), getattr(ref.entries, f.name), f.name)
    for key in STORE_KEYS:
        a, b = getattr(ours.store, key), getattr(ref.store, key)
        assert (a is None) == (b is None), key
        if a is not None:
            same(a, b, key)
    assert (ours.name, ours.num_ans, ours.label2ans, ours.ntoken, ours.relation_type) == (
        ref.name, ref.num_ans, ref.label2ans, ref.ntoken, ref.relation_type)


def both(argv):
    import main as jax_main

    return build_datasets(parse_with_config(argv)), jax_main.build_datasets(jax_parse(argv))


@pytest.mark.parametrize("flags", [
    ["--use_both"],
    ["--use_vg"],
    ["--use_both", "--use_vg"],
    ["--dataset", "vqa_cp"],
    ["--dataset", "vqa_cp", "--mode", "eval"],
    ["--mode", "ensemble_eval", "--relation_type", "implicit",
     "--ensemble_checkpoints", "implicit:a.npz,semantic:b.npz"],
    ["--use_both", "--tfidf"],
], ids=["use_both", "use_vg", "use_both_use_vg", "vqa_cp", "vqa_cp_eval", "ensemble", "tfidf"])
def test_build_datasets_equals_jax_main(dataroot, flags):
    argv = ["--data_folder", dataroot, "--adaptive", "--mode", "train",
            "--relation_type", "semantic", *flags]
    (train, val, tfidf, weights), (jtrain, jval, jtfidf, jweights) = both(argv)
    assert_datasets_equal(train, jtrain)
    assert_datasets_equal(val, jval)
    assert (tfidf is None) == (jtfidf is None) == ("--tfidf" not in flags)
    if tfidf is not None:
        same(tfidf.toarray(), jtfidf.toarray(), "tfidf")
        same(weights, jweights, "weights")
        assert val.dictionary.word2idx == jval.dictionary.word2idx
        assert train.ntoken < len(train.dictionary)  # the snapshot stays
    if "vqa_cp" in flags:
        assert val.name == "cp_test" and (train is None or train.store is val.store)
        if train is not None:  # one upload of the merged image tables
            a, b = DeviceStore(train, CPU), DeviceStore(val, CPU)
            assert a.images is b.images and a.entry_img is not b.entry_img
    if "--use_vg" in flags:  # VG pairs over val images only under --use_both
        n_vg = len(train) - 12 - (8 if "--use_both" in flags else 0)
        assert n_vg == (6 if "--use_both" in flags else 4)
    if "ensemble_eval" in flags:
        assert val.store.semantic_adj is not None


def test_merge_stores_fixed36_equals_jax(tmp_path):
    root = str(tmp_path / "d")
    write_fixture(root, name="train", adaptive=False, num_images=3, num_questions=6)
    write_fixture(root, name="val", adaptive=False, num_images=2, num_questions=4, seed=1,
                  first_image_id=2000, first_question_id=50)
    convert(root, ["train", "val"])
    d = root + "/glove/dictionary.pkl"
    ours = [load_vqa_dataset(n, Dictionary.load_from_file(d), "implicit", root, False)
            for n in ("train", "val")]
    ref = [jax_load_vqa_dataset(n, JaxDictionary.load_from_file(d), "implicit", root, False)
           for n in ("train", "val")]
    merged, offset = merge_stores(ours[0].store, ours[1].store)
    jmerged, joffset = jax_merge_stores(ref[0].store, ref[1].store)
    assert offset == joffset == 3 and merged.pos_boxes is None
    for key in STORE_KEYS:
        a, b = getattr(merged, key), getattr(jmerged, key)
        assert (a is None) == (b is None)
        if a is not None:
            same(a, b, key)


def test_vg_answer_normalization_equals_jax():
    rng = np.random.RandomState(0)
    alphabet = list("abz019 ,.;!?'-/()\"") + ["two", "the ", "a ", "dont", "none"]
    cases = ["A Dog.", "Two.", "11,000", "the red car", "It's sunny!", "dont", "NONE",
             "3.5", "x-ray", "yes, it is", "(a) cat"]
    cases += ["".join(rng.choice(alphabet, size=rng.randint(1, 12))) for _ in range(300)]
    for c in cases:
        assert preprocess_answer(c) == jax_preprocess_answer(c), c


MODES = ["train", "eval", "predict", "serve", "ensemble_eval"]
COMPOSE = {"use_both": ["--use_both"], "use_vg": ["--use_vg"], "vqa_cp": ["--dataset", "vqa_cp"]}


@pytest.mark.parametrize("compose", list(COMPOSE))
@pytest.mark.parametrize("mode", MODES)
def test_mmap_compose_refusal_matches_jax(dataroot, mode, compose):
    """--mmap_features refuses to compose where JAX's main.py refuses, with
    its message: vqa_cp in every mode, --use_both/--use_vg in train only;
    elsewhere both load the same split."""
    import main as jax_main

    argv = ["--data_folder", dataroot, "--adaptive", "--mode", mode, "--mmap_features",
            "--predict_split", "val", "--ensemble_checkpoints", "implicit:a.npz",
            *COMPOSE[compose]]
    refused = compose == "vqa_cp" or mode == "train"
    if refused:
        with pytest.raises(ValueError) as ours:
            build_datasets(parse_with_config(argv))
        with pytest.raises(ValueError) as ref:
            jax_main.build_datasets(jax_parse(argv))
        assert str(ours.value) == str(ref.value)
        assert "--mmap_features cannot compose splits" in str(ours.value)
    else:
        (_, val, _, _), (_, jval, _, _) = both(argv)
        assert val.store.features_lazy and jval.store.features_lazy
        same(val.store.features, np.asarray(jval.store.features), "features")
        jval.store.h5_file.close()
