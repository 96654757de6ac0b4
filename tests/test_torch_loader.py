"""The port's host data path (data/native.py, data/loader.py) against the
JAX package's (native/__init__.py, data/loader.py), on the CPU:

(a) the threaded C++ row gather, its numpy version and JAX's
    `native.gather_rows` write the same bytes (f32, bf16 as 16-bit words,
    int8; -1 rows zeroed); a row past the table, too small an `out` and
    arrays it cannot take raise;
(b) the bf16 wire rounding (torch's f32 -> bf16 copy) equals ml_dtypes'
    `astype(bfloat16)`, which JAX's loader applies, bit for bit;
(c) every batch of an epoch (shuffled, epoch 1, `skip` 2, the last batch
    partial) equals JAX's `BatchLoader` batch key for key: f32, bf16 and
    int8 (sent as bf16) wires, adaptive and fixed-36 layouts, the features
    in RAM or memory-mapped, implicit, spatial (the file's labels) and
    semantic splits; the integer columns, int32 in JAX, are int64 here as
    the device store's gather gives them;
(d) a host batch, widened where the device store widens, equals the
    port's `gather_batch` at the same indices bit for bit (f32, bf16);
(e) the prefetch: depth 0, 1 and 2 give the loader's batches; the producer
    thread ends when the consumer closes the iterator mid-epoch; an error
    in the producer is raised in the consumer; a stress run with a short
    switch interval.

Inputs come from one seed through the port's `write_dataset` (the files of
JAX's `write_fixture`), loaded by the port; the JAX dataset is built from
the same arrays. Tolerances: none, every comparison is exact.
"""

import dataclasses
import sys
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu import native as jax_native
from tf_vqa_regat_tpu.data import entries as jax_entries
from tf_vqa_regat_tpu.data import features as jax_features
from tf_vqa_regat_tpu.data.loader import BatchLoader as JaxBatchLoader
from tf_vqa_regat_tpu_torch.data import native
from tf_vqa_regat_tpu_torch.data.features import load_vqa_dataset
from tf_vqa_regat_tpu_torch.data.loader import BatchLoader, prefetch_to_device, widen_features
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.data.synthetic import make_dictionary, write_dataset
from tf_vqa_regat_tpu_torch.ops.kernels import build

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
V_DIM, NUM_ANS = 24, 9
B, R = 7, 20  # 26 questions: 4 batches a epoch, the last of 5


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A dataset per layout: train with the semantic table and the file's
    spatial labels, boxes 10-29 per image (some past R)."""
    out = {}
    for adaptive in (True, False):
        root = str(tmp_path_factory.mktemp("ad" if adaptive else "fx"))
        write_dataset(root, num_images=6, num_questions=26, v_dim=V_DIM, num_ans=NUM_ANS,
                      adaptive=adaptive, name="train", seed=3, semantic=True, spatial_seed=4)
        out[adaptive] = root
    return out


def port_split(root, adaptive, relation_type="spatial", mmap=False):
    return load_vqa_dataset("train", make_dictionary(), relation_type, root, adaptive, mmap,
                            store_relation_types={"semantic", "spatial"})


def jax_split(ds):
    """The JAX package's dataset over the same arrays; a memory-mapped table
    takes JAX's lazy path (per-image slices), as an open HDF5 file does."""
    s = ds.store
    store = jax_features.FeatureStore(
        adaptive=s.adaptive, features=s.features, normalized_bb=s.normalized_bb, bb=s.bb,
        pos_boxes=s.pos_boxes, semantic_adj=s.semantic_adj, spatial_adj=s.spatial_adj,
        h5_file=object() if s.features_lazy else None)
    ent = jax_entries.EntryTable(**{f.name: getattr(ds.entries, f.name)
                                    for f in dataclasses.fields(ds.entries)})
    return jax_features.VQADataset(
        name=ds.name, entries=ent, store=store, num_ans=ds.num_ans, label2ans=ds.label2ans,
        dictionary=ds.dictionary, relation_type=ds.relation_type, ntoken=ds.ntoken)


def bits(a):
    """An array's raw bits (bf16 as 16-bit words), to compare exactly."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16", np.int8])
def test_native_gather_equals_numpy_and_jax(dtype):
    rng = np.random.RandomState(0)
    tab = rng.randn(50, 33).astype(np.float32)
    if dtype == "bfloat16":
        tab = tab.astype(ml_dtypes.bfloat16).view(np.uint16)  # the port's bf16 bits
    else:
        tab = (tab * 40).astype(dtype)
    rows = rng.randint(-1, 50, size=70)
    rows[[0, 5, 69]] = -1
    outs = [np.full((75, 33), 7, tab.dtype) for _ in range(3)]
    native.gather_rows(tab, rows, outs[0], n_threads=3)
    native.gather_rows_plain(tab, rows, outs[1])
    assert jax_native.gather_rows(tab, rows, outs[2])
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    np.testing.assert_array_equal(outs[0][:70][rows >= 0], tab[rows[rows >= 0]])
    assert not outs[0][:70][rows < 0].any() and (outs[0][70:] == 7).all()


def test_gather_refuses_what_it_cannot_take():
    tab = np.zeros((10, 4), np.float32)
    out = np.zeros((5, 4), np.float32)
    with pytest.raises(IndexError, match="past the table"):
        native.gather_rows(tab, np.array([1, 10]), out)
    with pytest.raises(IndexError, match="past the table"):
        native.gather_rows_plain(tab, np.array([1, 10]), out)
    with pytest.raises(ValueError, match="do not fit"):
        native.gather_rows(tab, np.zeros(6, np.int64), out)
    with pytest.raises(ValueError, match="one dtype"):
        native.gather_rows(tab, np.zeros(2, np.int64), out.astype(np.float64))
    with pytest.raises(ValueError, match="C-contiguous"):
        native.gather_rows(np.zeros((10, 8), np.float32)[:, ::2], np.zeros(2, np.int64), out)


def test_native_library_is_named_by_its_source():
    so = build.library_path(native.SOURCE)
    assert so.parent == build.BUILD_DIR and so.name.startswith("libpack-")
    native.LIB.load()
    assert so.exists()


# ------------------------------------------------------------------ (b)
def test_bf16_wire_rounding_equals_ml_dtypes():
    rng = np.random.RandomState(1)
    x = np.concatenate([
        rng.randn(10000).astype(np.float32) * np.float32(10) ** rng.randint(-30, 30, 10000),
        np.array([0.0, -0.0, 1.0, np.inf, -np.inf, 3.4e38, 1e-40, -1e-45], np.float32),
        # exact ties between two bf16 values: round to the even one
        (np.arange(1 << 15, dtype=np.uint32) << 16 | 0x8000).view(np.float32)[:2000],
    ])
    x = x[np.isfinite(x) | np.isinf(x)]
    got = torch.empty(x.shape, dtype=torch.bfloat16)
    got.copy_(torch.from_numpy(x))
    np.testing.assert_array_equal(bits(got), x.astype(ml_dtypes.bfloat16).view(np.uint16))


# ------------------------------------------------------------------ (c)
CASES = [(rt, mmap) for rt in ("implicit", "spatial", "semantic") for mmap in (False, True)]


@pytest.mark.parametrize("relation_type,mmap", CASES,
                         ids=[f"{rt}-{'mmap' if m else 'ram'}" for rt, m in CASES])
@pytest.mark.parametrize("feature_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "fixed36"])
def test_every_batch_of_an_epoch_equals_jax(roots, adaptive, feature_dtype, relation_type, mmap):
    ds = port_split(roots[adaptive], adaptive, relation_type, mmap)
    assert ds.store.features_lazy == mmap
    include_adj = relation_type != "implicit"
    ours = BatchLoader(ds, B, R, shuffle=True, seed=5, include_adj=include_adj,
                       feature_dtype=feature_dtype)
    ref = JaxBatchLoader(jax_split(ds), B, R, shuffle=True, seed=5, include_adj=include_adj,
                         feature_dtype=feature_dtype)
    assert len(ours) == len(ref) == 4
    got, want = list(ours.epoch(1, skip=2)), list(ref.epoch(1, skip=2))
    assert len(got) == len(want) == 2
    assert int(got[-1]["valid"].sum()) == 26 - 3 * B
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert ("adj_label" in g) == include_adj
        for k, v in w.items():
            assert tuple(g[k].shape) == v.shape, k
            if k in ("question", "num_boxes"):  # int32 in JAX, int64 as gather_batch's
                assert g[k].dtype == torch.int64
                np.testing.assert_array_equal(g[k].numpy(), v, err_msg=k)
            else:
                np.testing.assert_array_equal(bits(g[k]), bits(v), err_msg=k)
    if include_adj:  # the file's table, not labels built from the boxes
        assert any(b["adj_label"].any() for b in got)


def test_int8_goes_over_the_wire_as_bf16(roots):
    ds = port_split(roots[True], True)
    idx = np.arange(B)
    int8 = BatchLoader(ds, B, R, False, feature_dtype="int8").pack(idx)
    bf16 = BatchLoader(ds, B, R, False, feature_dtype="bfloat16").pack(idx)
    assert int8["features"].dtype == torch.bfloat16
    assert all(torch.equal(int8[k], bf16[k]) for k in bf16)


# ------------------------------------------------------------------ (d)
@pytest.mark.parametrize("feature_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "fixed36"])
def test_host_batch_equals_the_device_gather(roots, adaptive, feature_dtype):
    ds = port_split(roots[adaptive], adaptive, "semantic")
    loader = BatchLoader(ds, B, R, shuffle=True, include_adj=True, feature_dtype=feature_dtype)
    store = DeviceStore(ds, CPU, feature_dtype=feature_dtype)
    for idx in loader.epoch_indices(0):
        got = widen_features(loader.pack(idx))
        padded = np.full(B, -1, np.int32)
        padded[: len(idx)] = idx
        want = gather_batch(store, torch.from_numpy(padded), R)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(bits(got[k]), bits(v), err_msg=k)


# ------------------------------------------------------------------ (e)
def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "regat-prefetch"]


@pytest.fixture
def loader(roots):
    return BatchLoader(port_split(roots[True], True, "semantic"), B, R, shuffle=True,
                       include_adj=True, feature_dtype="bfloat16")


def _same(a, b):
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_prefetch_gives_the_loaders_batches(loader, depth):
    want = [widen_features(b) for b in loader.epoch(2, skip=1)]
    got = list(prefetch_to_device(loader, CPU, 2, skip=1, depth=depth))
    assert len(got) == len(want) == 3
    assert all(_same(g, w) for g, w in zip(got, want))
    assert got[0]["features"].dtype == torch.float32  # widened where gather_batch widens
    assert not _prefetch_threads()


def test_producer_ends_when_the_consumer_closes_mid_epoch(loader):
    stream = prefetch_to_device(loader, CPU, 0, depth=1)
    next(stream)
    assert _prefetch_threads()  # packing ahead, blocked on the full queue
    stream.close()
    assert not _prefetch_threads()


def test_producer_error_reaches_the_consumer(loader, monkeypatch):
    real, calls = loader.pack, []

    def pack(idx, out=None):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("pack failed")
        return real(idx, out)

    monkeypatch.setattr(loader, "pack", pack)
    stream = prefetch_to_device(loader, CPU, 0, depth=2)
    got = []
    with pytest.raises(RuntimeError, match="pack failed"):
        for batch in stream:
            got.append(batch)
    assert len(got) == 2 and not _prefetch_threads()


def test_prefetch_stress_with_a_short_switch_interval(loader):
    """Many prefetches, each dropped at a different point or run out, with
    the interpreter switching threads every microsecond: every batch seen
    is the loader's, and no thread outlives its iterator."""
    want = [widen_features(b) for b in loader.epoch(0)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for trial in range(12):
            stream = prefetch_to_device(loader, CPU, 0, depth=1 + trial % 3)
            for i, batch in enumerate(stream):
                assert _same(batch, want[i])
                if i == trial % 5:
                    break
            stream.close()
            assert not _prefetch_threads()
    finally:
        sys.setswitchinterval(old)
