"""The port's real-data path against the JAX package's, on the CPU, over the
miniature reference layout of JAX `fixtures.write_fixture` (real HDF5 files,
an `image_adj_matrix` added here with h5py) converted by the port's
`data/convert.py`:

(a) `load_vqa_dataset` equals JAX's field for field and bit for bit
    (entries, store arrays, num_ans, label2ans, ntoken), adaptive and
    fixed-36, train, val and test2015 (answerless), with and without the
    semantic and spatial tables, with and without --mmap_features; a re-run
    of the converter skips converted splits;
(b) the port's `write_dataset` / `write_cp_vg` write, file for file, what
    JAX's `write_fixture` / `write_cp_vg_fixture` and the converter write;
(c) dictionary pickles load in both packages, and `tokenize(add_word=True)`
    grows the dictionary as JAX's does;
(d) `tfidf_from_questions` and `word_embedding_load_glove` equal JAX's;
(f) a bf16, an int8 and an f32 packed cache written by JAX is a hit for the
    port and the other way round, byte for byte; a stale meta rebuilds;
(g) `gather_batch` on a real-layout store equals JAX's bit for bit for f32,
    bf16 and int8, adaptive and fixed-36, the spatial `adj_label` taken from
    the file;
(h) the entry point: `--config configs/butd_vqa.json --mode train --tfidf
    --data_folder FIXTURE` at small widths against JAX's main.py under
    `--train_block 1 --use_pallas`, from the same initial parameters at
    `--dropout 0`; then `--mode predict` on test2015 and `--mode serve` on a
    real image id.

Tolerances. (a)-(g): exact. (h): the train and eval losses and scores rel
1e-6 and the final parameters atol 1e-5, tests/test_torch_store_layouts.py's
(d) tolerances for a training run against JAX's `run_training`.
"""

import dataclasses
import filecmp
import json
import os
import pickle
import warnings

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.data import device_store as jds
from tf_vqa_regat_tpu.data.dictionary import Dictionary as JaxDictionary
from tf_vqa_regat_tpu.data.features import load_vqa_dataset as jax_load_vqa_dataset
from tf_vqa_regat_tpu.data.fixtures import write_cp_vg_fixture, write_fixture
from tf_vqa_regat_tpu.data.glove import tfidf_from_questions as jax_tfidf_from_questions
from tf_vqa_regat_tpu.models.language import (
    word_embedding_init,
    word_embedding_load_glove as jax_load_glove,
)
from tf_vqa_regat_tpu_torch.data.convert import convert
from tf_vqa_regat_tpu_torch.data.dictionary import Dictionary
from tf_vqa_regat_tpu_torch.data.features import load_vqa_dataset
from tf_vqa_regat_tpu_torch.data.glove import tfidf_from_questions
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, cached_chunks, gather_batch, upload_table
from tf_vqa_regat_tpu_torch.data.synthetic import write_cp_vg, write_dataset
from tf_vqa_regat_tpu_torch.models.language import WordEmbedding, word_embedding_load_glove

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = ("train", "val", "test2015")
# (name, write_fixture arguments); train and test2015 carry the semantic
# table and the spatial labels, val neither
FIXTURE = {
    "train": dict(num_images=8, num_questions=24, seed=0, semantic=True),
    "val": dict(num_images=5, num_questions=12, seed=1, first_image_id=2000,
                first_question_id=100),
    "test2015": dict(num_images=4, num_questions=9, seed=2, semantic=True,
                     first_image_id=3000, first_question_id=500),
}
BOTH = ("semantic", "spatial")


def add_spatial_labels(root, name, adaptive, seed):
    """An `image_adj_matrix` [num_images, 100, 100] int32 of labels 0-11 in
    the split's HDF5 file, as the reference's spatial data has one."""
    from tf_vqa_regat_tpu.data.features import load_imgid2idx

    n = len(load_imgid2idx(root, name, adaptive))
    suffix = "" if adaptive else ("_36" if "test" in name else "36")
    feat_dir = "Bottom-up-features-adaptive" if adaptive else "Bottom-up-features-fixed"
    with h5py.File(os.path.join(root, feat_dir, f"{name}{suffix}.hdf5"), "a") as hf:
        hf.create_dataset("image_adj_matrix", data=np.random.RandomState(seed).randint(
            0, 12, size=(n, 100, 100)).astype(np.int32))


def write_root(root, adaptive):
    """train and val, the VQA-CP and VG files, then test2015 (its questions
    replace the TF-IDF pass's five of write_cp_vg_fixture), spatial labels
    for train and test2015; converted."""
    for name in ("train", "val"):
        write_fixture(root, name=name, adaptive=adaptive, **FIXTURE[name])
    if adaptive:  # write_cp_vg_fixture reads the adaptive image-id maps
        write_cp_vg_fixture(root)
    write_fixture(root, name="test2015", adaptive=adaptive, **FIXTURE["test2015"])
    for i, name in enumerate(("train", "test2015")):
        add_spatial_labels(root, name, adaptive, seed=10 + i)
    assert len(convert(root, list(SPLITS))) == 3
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return {adaptive: write_root(str(tmp_path_factory.mktemp("ad" if adaptive else "fx")),
                                 adaptive)
            for adaptive in (True, False)}


def assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype.kind == "f":  # bit for bit, the signs of zeros too
        assert np.array_equal(a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")), what
    else:
        assert np.array_equal(a, b), what


def load_pair(root, name, adaptive, mmap=False, relation_type="spatial"):
    d = root + "/glove/dictionary.pkl"
    ours = load_vqa_dataset(name, Dictionary.load_from_file(d), relation_type, root, adaptive,
                            mmap, store_relation_types=BOTH)
    ref = jax_load_vqa_dataset(name, JaxDictionary.load_from_file(d), relation_type, root,
                               adaptive, mmap, store_relation_types=BOTH)
    return ours, ref


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("mmap", [False, True], ids=["ram", "mmap"])
@pytest.mark.parametrize("name", SPLITS)
@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "fixed36"])
def test_loader_equals_jax(roots, adaptive, name, mmap):
    ours, ref = load_pair(roots[adaptive], name, adaptive, mmap)
    try:
        for f in dataclasses.fields(ours.entries):
            assert_same(getattr(ours.entries, f.name), getattr(ref.entries, f.name), f.name)
        for key in ("features", "normalized_bb", "bb", "pos_boxes", "semantic_adj",
                    "spatial_adj"):
            a, b = getattr(ours.store, key), getattr(ref.store, key)
            assert (a is None) == (b is None), key
            if a is not None:
                assert_same(a, b, key)
        assert ours.store.features_lazy == ref.store.features_lazy == mmap
        assert (ours.store.semantic_adj is None) == (name == "val")
        assert ours.entries.has_answers == ref.entries.has_answers == (name != "test2015")
        assert (ours.num_ans, ours.label2ans, ours.name) == (ref.num_ans, ref.label2ans, ref.name)
        assert (ours.ntoken, ours.padding_idx, ours.v_dim) == (ref.ntoken, ref.padding_idx,
                                                               ref.v_dim)
        assert ours.dictionary.word2idx == ref.dictionary.word2idx
    finally:
        if ref.store.h5_file is not None:
            ref.store.h5_file.close()


def test_tables_load_only_for_their_relation_type(roots):
    d = Dictionary.load_from_file(roots[True] + "/glove/dictionary.pkl")
    plain = load_vqa_dataset("train", d, "implicit", roots[True], True)
    assert plain.store.semantic_adj is None and plain.store.spatial_adj is None
    sem = load_vqa_dataset("train", d, "semantic", roots[True], True)
    assert sem.store.semantic_adj is not None and sem.store.spatial_adj is None
    spa = load_vqa_dataset("train", d, "spatial", roots[True], True)
    assert spa.store.semantic_adj is None and spa.store.spatial_adj is not None


def test_converter_skips_converted_splits_and_refuses_incomplete_ones(roots, tmp_path):
    import shutil

    root = str(tmp_path / "d")
    shutil.copytree(roots[True], root)
    assert convert(root, list(SPLITS)) == []
    table = os.path.join(root, "Bottom-up-features-adaptive", "val", "image_bb.npy")
    np.save(table, np.zeros((3, 4), np.float32))  # a table that disagrees with the meta
    with pytest.raises(FileNotFoundError, match="incomplete conversion.*--splits val"):
        load_vqa_dataset("val", Dictionary.load_from_file(root + "/glove/dictionary.pkl"),
                         "implicit", root, True)
    os.remove(os.path.join(root, "Bottom-up-features-adaptive", "val", "meta.json"))
    assert len(convert(root, ["val"])) == 1  # no meta: converted again
    load_vqa_dataset("val", Dictionary.load_from_file(root + "/glove/dictionary.pkl"),
                     "implicit", root, True)


# ------------------------------------------------------------------ (b)
def tree(root):
    out = set()
    for d, _, files in os.walk(root):
        out |= {os.path.relpath(os.path.join(d, f), root) for f in files}
    return out


@pytest.mark.parametrize("case", ["adaptive_train_semantic", "fixed36_test2015", "cp_vg"])
def test_writer_equals_fixture_and_converter(tmp_path, case):
    ref, ours = str(tmp_path / "ref"), str(tmp_path / "ours")
    if case == "cp_vg":
        calls = [dict(name="train", **FIXTURE["train"]), dict(name="val", **FIXTURE["val"])]
    elif case == "fixed36_test2015":
        calls = [dict(name="test2015", adaptive=False, **FIXTURE["test2015"])]
    else:
        calls = [dict(name="train", **FIXTURE["train"])]
    for kw in calls:
        write_fixture(ref, **kw)
        write_dataset(ours, **kw)
    if case == "cp_vg":
        write_cp_vg_fixture(ref)
        write_cp_vg(ours)
    convert(ref, list(SPLITS))
    want = {f for f in tree(ref) if not f.endswith(".hdf5")}
    assert tree(ours) == want
    _, mismatch, errors = filecmp.cmpfiles(ref, ours, sorted(want), shallow=False)
    assert mismatch == [] and errors == []


# ------------------------------------------------------------------ (c)
def test_dictionary_pickles_and_add_word(tmp_path):
    ours = Dictionary()
    ref = JaxDictionary()
    for s in ["What is the COLOR of the dog's car?", "how many people, on the left"]:
        assert ours.tokenize(s, True) == ref.tokenize(s, True)
    assert ours.word2idx == ref.word2idx and ours.idx2word == ref.idx2word
    assert ours.tokenize("zebra on the car", False) == ref.tokenize("zebra on the car", False)
    ours.dump_to_file(str(tmp_path / "ours.pkl"))
    ref.dump_to_file(str(tmp_path / "ref.pkl"))
    assert filecmp.cmp(str(tmp_path / "ours.pkl"), str(tmp_path / "ref.pkl"), shallow=False)
    a = JaxDictionary.load_from_file(str(tmp_path / "ours.pkl"))
    b = Dictionary.load_from_file(str(tmp_path / "ref.pkl"))
    assert a.word2idx == b.word2idx == ours.word2idx and a.idx2word == b.idx2word
    assert len(b) == len(ours) == b.ntoken == b.padding_idx


# ------------------------------------------------------------------ (d)
@pytest.mark.parametrize("op,tfidf", [("c", True), ("c", False), ("", False)])
def test_glove_and_tfidf_equal_jax(roots, op, tfidf):
    root = roots[True]
    ours = Dictionary.load_from_file(root + "/glove/dictionary.pkl")
    ref = JaxDictionary.load_from_file(root + "/glove/dictionary.pkl")
    ntoken = ours.ntoken
    mat = weights = jmat = jweights = None
    if tfidf:
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # the fixture ships the VG file: no warning
            mat, weights = tfidf_from_questions(list(SPLITS), ours, root)
            jmat, jweights = jax_tfidf_from_questions(list(SPLITS), ref, root)
        assert ours.word2idx == ref.word2idx and ours.idx2word == ref.idx2word
        assert ours.ntoken > ntoken  # the VG questions add words
        assert mat.shape == jmat.shape == (ntoken, ours.ntoken)
        assert_same(mat.toarray(), jmat.toarray(), "tfidf")
        assert_same(weights, jweights, "weights")
    glove = np.load(root + "/glove/glove6b_init_300d.npy").squeeze()
    w_emb = WordEmbedding(ntoken, 300, op, torch.Generator().manual_seed(0))
    trainable = word_embedding_load_glove(w_emb, glove, op, mat, weights)
    params = word_embedding_init(jax.random.PRNGKey(0), ntoken, 300, op)
    jparams, jtrainable = jax_load_glove(params, glove, op, jmat, jweights)
    assert trainable == jtrainable == tfidf
    assert_same(w_emb.emb.table.detach().numpy(), jparams["emb"]["table"], "emb")
    assert (w_emb.emb_ is None) == ("emb_" not in jparams)
    if w_emb.emb_ is not None:
        assert_same(w_emb.emb_.table.detach().numpy(), jparams["emb_"]["table"], "emb_")


# ------------------------------------------------------------------ (f)
CACHE_DTYPES = ("float32", "bfloat16", "int8")


def _port_cache(store, feature_dtype, cache_dir):
    """The port's packed-cache read (or write), as the uploaded table."""
    from tf_vqa_regat_tpu_torch.data.store import table_rows

    chunks = cached_chunks(store.features, store.adaptive, feature_dtype, cache_dir)
    return upload_table(chunks, table_rows(store.features), feature_dtype, CPU)


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("feature_dtype", CACHE_DTYPES)
@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "fixed36"])
def test_packed_cache_is_shared_with_jax(roots, tmp_path, monkeypatch, adaptive, feature_dtype):
    from tf_vqa_regat_tpu_torch.data import store as port_store

    ours, ref = load_pair(roots[adaptive], "train", adaptive)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jfeat, jscale = jds._cached_features(ref.store, feature_dtype, jax_dir)  # JAX writes
    want = np.asarray(jfeat).view(np.uint16) if feature_dtype == "bfloat16" else np.asarray(jfeat)

    def no_conversion(*a, **kw):
        raise AssertionError("a cache hit converts nothing")

    with monkeypatch.context() as m:  # the port reads JAX's cache
        m.setattr(port_store, "converted_chunks", no_conversion)
        feat, scale = _port_cache(ours.store, feature_dtype, jax_dir)
    assert_same(_bits(feat).view(want.dtype) if feature_dtype == "bfloat16" else _bits(feat),
                want, "features")
    assert (scale is None) == (jscale is None)
    if scale is not None:
        assert_same(scale.numpy(), jscale, "scale")

    _port_cache(ours.store, feature_dtype, port_dir)  # the port writes
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for f in os.listdir(jax_dir):
        assert filecmp.cmp(os.path.join(jax_dir, f), os.path.join(port_dir, f), shallow=False), f
    with monkeypatch.context() as m:  # JAX reads the port's cache
        m.setattr(jds, "_materialize_features", no_conversion)
        jfeat2, _ = jds._cached_features(ref.store, feature_dtype, port_dir)
    assert_same(np.asarray(jfeat2).view(np.uint8), np.asarray(jfeat).view(np.uint8), "jax read")

    meta = next(os.path.join(port_dir, f) for f in os.listdir(port_dir) if f.endswith(".json"))
    with open(meta) as fh:
        sig = json.load(fh)
    with open(meta, "w") as fh:  # a stale meta: another source's fingerprint
        json.dump(dict(sig, src_sha1="0" * 40), fh)
    feat, _ = _port_cache(ours.store, feature_dtype, port_dir)
    with open(meta) as fh:
        assert json.load(fh) == sig  # rebuilt
    assert_same(_bits(feat).view(want.dtype) if feature_dtype == "bfloat16" else _bits(feat),
                want, "rebuilt")


# ------------------------------------------------------------------ (g)
@pytest.mark.parametrize("feature_dtype", CACHE_DTYPES)
@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "fixed36"])
def test_gather_equals_jax_with_the_files_spatial_labels(roots, adaptive, feature_dtype):
    ours, ref = load_pair(roots[adaptive], "train", adaptive)
    port = DeviceStore(ours, CPU, feature_dtype=feature_dtype)
    jstore = jds.DeviceStore(ref, include_adj=True, feature_dtype=feature_dtype)
    idx = list(port.epoch_indices(0, 16, True, seed=3))[-1]  # 8 padded slots
    assert (idx < 0).sum() == 8
    for num_rois in (20, 36, 100):
        got = gather_batch(port, torch.from_numpy(idx).long(), num_rois)
        want = jds.gather_batch(jstore.arrays, jnp.asarray(idx), num_rois, ref.num_ans,
                                ref.padding_idx)
        assert set(got) == set(want) and "adj_label" in got
        for k in want:  # the port's index tables are int64
            g, w = got[k].numpy(), np.asarray(want[k])
            if w.dtype.kind == "f":
                assert_same(g, w, k)
            else:
                assert g.shape == w.shape and np.array_equal(g, w), k
        img = ours.entries.image_index[idx[idx >= 0]]
        k = min(num_rois, 100)
        np.testing.assert_array_equal(got["adj_label"][idx >= 0][:, :k, :k].numpy(),
                                      ours.store.spatial_adj[img][:, :k, :k])


def test_tables_larger_than_the_free_device_memory_are_refused(roots, monkeypatch):
    """Before any upload: the message names the smaller feature dtypes."""
    from tf_vqa_regat_tpu_torch.data import store as port_store

    ours, _ = load_pair(roots[True], "train", True)
    need = port_store.table_nbytes(ours, "float32", ours.store.spatial_adj)
    assert need > ours.store.features.nbytes
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (need - 1, 10 * need))
    with pytest.raises(MemoryError, match="--feature_dtype bfloat16 .* or int8"):
        port_store.check_fits(ours, "float32", ours.store.spatial_adj, torch.device("cuda"))
    half = port_store.table_nbytes(ours, "bfloat16", None)
    assert half < need
    port_store.check_fits(ours, "bfloat16", None, torch.device("cuda"))  # fits: no error


# ------------------------------------------------------------------ (h)
WIDTHS = ["--num_hid", "64", "--relation_dim", "96", "--num_heads", "4", "--nongt_dim", "10",
          "--num_rois", "32", "--batch_size", "16", "--dropout", "0", "--no-save_every_epoch",
          "--print_freq", "100"]


def test_entry_point_train_predict_serve_against_jax_main(roots, tmp_path, monkeypatch):
    import main as jax_main
    from tf_vqa_regat_tpu.models.regat import init_regat
    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT
    from tf_vqa_regat_tpu_torch.params import flatten_tree, load_jax_arrays, load_npz

    root = roots[True]
    argv = ["--config", os.path.join(REPO, "configs", "butd_vqa.json"), *WIDTHS,
            "--data_folder", root, "--mode", "train", "--epochs", "1", "--tfidf"]
    jout, pout = str(tmp_path / "jax") + "/", str(tmp_path / "port") + "/"
    ran = {}
    real = jax_main.run_training

    def capture(cfg, train_ds, val_ds, init_params, emb2_trainable):
        ran["init"] = flatten_tree(jax.tree.map(np.array, init_params))
        ran["trainable"] = emb2_trainable
        ran["final"], _ = out = real(cfg, train_ds, val_ds, init_params=init_params,
                                     emb2_trainable=emb2_trainable)
        return out

    monkeypatch.setattr(jax_main, "run_training", capture)
    jax_main.main(argv + ["--output", jout, "--train_block", "1", "--use_pallas"])

    def from_jax_init(cfg, ntoken, v_dim, num_ans):  # the JAX run's pre-GloVe init
        model = ReGAT(cfg, ntoken, v_dim, num_ans)
        jcfg = jax_main.parse_with_config(argv)
        load_jax_arrays(model, flatten_tree(jax.tree.map(
            np.array, init_regat(jax.random.PRNGKey(cfg.seed), jcfg, ntoken, v_dim, num_ans))))
        return model

    seen = {}
    real_port = port_main.run_training

    def port_capture(*a, **kw):
        seen["trainable"] = kw["emb2_trainable"]
        return real_port(*a, **kw)

    with monkeypatch.context() as m:
        m.setattr(port_main, "ReGAT", from_jax_init)
        m.setattr(port_main, "run_training", port_capture)
        path = port_main.main(argv + ["--output", pout, "--device", "cpu"])
    assert seen["trainable"] is ran["trainable"] is True
    got, want = load_npz(path), flatten_tree(jax.device_get(ran["final"]))
    assert sorted(got) == sorted(want)
    with open(jout + "metrics.jsonl") as fh:
        jm = [json.loads(line) for line in fh]
    with open(pout + "metrics.jsonl") as fh:
        pm = [json.loads(line) for line in fh]
    assert len(jm) == len(pm) == 1
    for key in ("train_loss", "eval_loss", "train_score", "eval_score", "lr"):
        np.testing.assert_allclose(pm[0][key], jm[0][key], rtol=1e-6, err_msg=key)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
    # emb_ trained under TF-IDF; both tables started from the GloVe rows
    assert not np.array_equal(got["w_emb/emb_/table"], ran["init"]["w_emb/emb_/table"])

    pred = port_main.main(argv[:-5] + ["--mode", "predict", "--checkpoint", path,
                                       "--output", pout, "--device", "cpu"])
    d = JaxDictionary.load_from_file(root + "/glove/dictionary.pkl")
    ref = jax_load_vqa_dataset("test2015", d, "implicit", root, True)
    with open(pred) as fh:
        answers = json.load(fh)
    assert [a["question_id"] for a in answers] == ref.entries.question_ids.tolist()
    assert all(a["answer"] in ref.label2ans for a in answers)
    assert pred.endswith("implicit-butd-test2015-predictions.json")

    server, batcher, engine = port_main.build_server(
        argv[:-5] + ["--mode", "serve", "--checkpoint", path, "--serve_port", "0",
                     "--serve_batch_sizes", "1,4", "--device", "cpu"])
    try:
        with open(os.path.join(root, "imgids", "val_imgid2idx.pkl"), "rb") as fh:
            image_id = sorted(pickle.load(fh))[2]
        out = engine.infer(["what color is the cat ?", "what ?"], [image_id, 10**9])
        assert out[0]["answer"] in ref.label2ans and 0.0 < out[0]["confidence"] < 1.0
        assert "unknown image_id" in out[1]["error"]
    finally:
        batcher.close()
        server.server_close()
