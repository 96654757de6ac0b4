"""The port's sharded store (data/sharded_store.py) against the JAX
package's `ShardedDeviceStore` on a dp mesh of the virtual CPU devices, for
dp = 1, 2, 4, adaptive (semantic) and fixed-36 splits, exactly:

- the greedy image assignment, `sharded_layout` and
  `estimate_sharded_nbytes` (each feature dtype, with and without the
  semantic table);
- the global index batches of `epoch_indices`, plain and roi-bucketed, with
  and without shuffling, for two epochs, the step counts and bucket counts;
- one gathered batch per shard (features, boxes, question, box counts,
  valid, targets, the semantic adjacency) against the shard's segment of
  JAX's `build_sharded_gather`, at f32, bf16 and int8 tables;
- every entry visited once per epoch, `local_to_global` and `to_global`;
- the packed cache: the port's file is a hit for JAX (the same bytes) and
  JAX's for the port;
- `resolve_data_mode` with its sharded leg against JAX's on a grid of
  budgets around the replicated and per-shard estimates, at dp = 1, 2, 4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.config import Config as JaxConfig
from tf_vqa_regat_tpu.data import entries as jax_entries
from tf_vqa_regat_tpu.data import features as jax_features
from tf_vqa_regat_tpu.data import sharded_store as jss
from tf_vqa_regat_tpu.parallel.mesh import batch_sharding, make_mesh
from tf_vqa_regat_tpu.train.loop import resolve_data_mode as jax_resolve_data_mode
from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data import sharded_store as pss
from tf_vqa_regat_tpu_torch.data.store import estimate_nbytes, gather_batch
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.parallel.mesh import batch_slice
from tf_vqa_regat_tpu_torch.train.loop import resolve_data_mode

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
R, NUM_ANS, BUCKETS = 40, 11, [20, 40, 100]
DTYPES = ("float32", "bfloat16", "int8")


def jax_split(ds):
    s = ds.store
    store = jax_features.FeatureStore(
        adaptive=s.adaptive, features=s.features, normalized_bb=s.normalized_bb, bb=s.bb,
        pos_boxes=s.pos_boxes, semantic_adj=s.semantic_adj, spatial_adj=s.spatial_adj)
    ent = jax_entries.EntryTable(**{f.name: getattr(ds.entries, f.name)
                                    for f in dataclasses.fields(ds.entries)})
    return jax_features.VQADataset(
        name=ds.name, entries=ent, store=store, num_ans=ds.num_ans, label2ans=ds.label2ans,
        dictionary=ds.dictionary, relation_type=ds.relation_type, ntoken=ds.ntoken)


def _split(adaptive, seed=0, n_img=13, n_q=50):
    ds = synthetic_dataset(num_images=n_img, num_questions=n_q, v_dim=16, num_ans=NUM_ANS,
                           seed=seed, semantic=True, adaptive=adaptive)
    return dataclasses.replace(ds, relation_type="semantic")


SPLITS = {True: _split(True), False: _split(False)}
LAYOUT_IDS = ["adaptive", "fixed36"]


def _mesh(dp):
    return make_mesh(dp, 1, devices=jax.devices()[:dp])


@pytest.mark.parametrize("dp", [1, 2, 4])
@pytest.mark.parametrize("adaptive", [True, False], ids=LAYOUT_IDS)
def test_layout_and_estimate_equal_jax(adaptive, dp):
    ds = SPLITS[adaptive]
    jds = jax_split(ds)
    box = pss._image_lengths(ds)[1]
    got = pss._assign_images(box, dp)
    want = jss._assign_images(box, dp)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert pss.sharded_layout(ds, dp) == jss.sharded_layout(jds, dp)
    for dtype in DTYPES:
        for adj in (False, True):
            assert pss.estimate_sharded_nbytes(ds, adj, dtype, dp) == \
                jss.estimate_sharded_nbytes(jds, adj, dtype, dp), (dtype, adj)


@pytest.fixture(scope="module")
def stores():
    """(port shards, JAX store) per (layout, dp), f32 tables."""
    out = {}
    for adaptive, ds in SPLITS.items():
        for dp in (1, 2, 4):
            port = [pss.ShardedDeviceStore(ds, CPU, r, dp, include_adj=True) for r in range(dp)]
            out[adaptive, dp] = (port, jss.ShardedDeviceStore(jax_split(ds), _mesh(dp), True))
    return out


@pytest.mark.parametrize("dp", [1, 2, 4])
@pytest.mark.parametrize("adaptive", [True, False], ids=LAYOUT_IDS)
def test_epoch_streams_equal_jax(stores, adaptive, dp):
    port, ref = stores[adaptive, dp]
    B = 8
    for s in port:
        np.testing.assert_array_equal(s.local_entry_counts, ref.local_entry_counts)
        np.testing.assert_array_equal(s.local_to_global, ref.local_to_global)
        np.testing.assert_array_equal(s.entry_nbox, ref.entry_nbox)
        assert s.steps_per_epoch(B) == ref.steps_per_epoch(B)
        assert s.bucketed_batch_counts(B, BUCKETS) == ref.bucketed_batch_counts(B, BUCKETS)
    for epoch in (0, 1):
        for shuffle in (True, False):
            got = list(port[0].epoch_indices(epoch, B, shuffle, 7))
            want = list(ref.epoch_indices(epoch, B, shuffle, 7))
            assert len(got) == len(want) == port[0].steps_per_epoch(B)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            gotb = list(port[-1].epoch_indices_bucketed(epoch, B, BUCKETS, shuffle, 7))
            wantb = list(ref.epoch_indices_bucketed(epoch, B, BUCKETS, shuffle, 7))
            assert [R for R, _ in gotb] == [R for R, _ in wantb]
            for (_, g), (_, w) in zip(gotb, wantb):
                np.testing.assert_array_equal(g, w)
            # every entry once per epoch, through each shard's segment
            for batches in (got, [idx for _, idx in gotb]):
                seen = np.concatenate([port[0].to_global(idx) for idx in batches])
                assert sorted(seen[seen >= 0].tolist()) == list(range(port[0].num_entries))


def _jax_batch(ref, dp, idx, R_):
    gather = jax.jit(jss.build_sharded_gather(_mesh(dp), R_, NUM_ANS, ref.padding_idx))
    out = gather(ref.arrays, jax.device_put(idx, batch_sharding(_mesh(dp))))
    return {k: np.asarray(v) for k, v in jax.device_get(out).items()}


def _assert_batch(got, want):
    assert set(got) == set(want) | {"valid"} or set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        if k == "adj_label":
            w = w.astype(np.int32)
        np.testing.assert_array_equal(g.astype(w.dtype) if k != "valid" else g, w, err_msg=k)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dp", [2, 4])
def test_gathered_batches_equal_jax(dtype, dp):
    ds = SPLITS[True]
    port = [pss.ShardedDeviceStore(ds, CPU, r, dp, feature_dtype=dtype, include_adj=True)
            for r in range(dp)]
    ref = jss.ShardedDeviceStore(jax_split(ds), _mesh(dp), True, dtype)
    B = 4 * dp
    for idx in list(ref.epoch_indices(0, B, True, 3))[-2:]:  # a full and the tail batch
        want = _jax_batch(ref, dp, idx, R)
        for r, s in enumerate(port):
            got = gather_batch(s, torch.from_numpy(batch_slice(idx, r, dp)).long(), R)
            seg = {k: batch_slice(np.moveaxis(v, 0, -1), r, dp) for k, v in want.items()}
            seg = {k: np.moveaxis(v, -1, 0) for k, v in seg.items()}
            _assert_batch(got, seg)
    for s in port:  # another table partitioned as this store's images
        assert torch.equal(s.sharded_adj_table(ds.store.semantic_adj), s.images.adj)


def test_the_packed_cache_is_shared_with_jax(tmp_path):
    ds, dp = SPLITS[True], 2
    jds = jax_split(ds)
    for dtype in ("bfloat16", "int8"):
        port_dir, jax_dir = str(tmp_path / f"p-{dtype}"), str(tmp_path / f"j-{dtype}")
        ours = pss.ShardedDeviceStore(ds, CPU, 1, dp, feature_dtype=dtype, cache_dir=port_dir)
        plain = pss.ShardedDeviceStore(ds, CPU, 1, dp, feature_dtype=dtype)
        assert torch.equal(ours.images.features, plain.images.features)
        jss.ShardedDeviceStore(jds, _mesh(dp), False, dtype, jax_dir)
        mp, fp, sp = pss.ShardedDeviceStore.cache_paths(ds, port_dir, dtype, dp)
        jmp, jfp, jsp = pss.ShardedDeviceStore.cache_paths(ds, jax_dir, dtype, dp)
        with open(fp, "rb") as a, open(jfp, "rb") as b:
            assert a.read() == b.read()
        with open(mp) as a, open(jmp) as b:
            assert a.read() == b.read()
        if dtype == "int8":
            with open(sp, "rb") as a, open(jsp, "rb") as b:
                assert a.read() == b.read()
        # each reads the other's cache: a hit, the same rows
        hit = pss.ShardedDeviceStore(ds, CPU, 1, dp, feature_dtype=dtype, cache_dir=jax_dir)
        assert torch.equal(hit.images.features, plain.images.features)
        ref = jss.ShardedDeviceStore(jds, _mesh(dp), False, dtype, port_dir)
        feats = np.asarray(jax.device_get(ref.arrays["features"]))
        want = plain.images.features
        want = want.view(torch.int16).numpy().view(np.uint16) if dtype == "bfloat16" \
            else want.numpy()
        got = feats.reshape(dp, -1, feats.shape[-1])[1]
        np.testing.assert_array_equal(got.view(np.uint16) if dtype == "bfloat16" else got,
                                      want)


@pytest.mark.parametrize("adaptive", [True, False], ids=LAYOUT_IDS)
def test_resolve_data_mode_with_the_sharded_leg_equals_jax(adaptive):
    val, train = SPLITS[adaptive], _split(adaptive, seed=4, n_img=17, n_q=70)
    jval, jtrain = jax_split(val), jax_split(train)
    seen = set()
    for rt in ("implicit", "spatial", "semantic"):
        include_adj = rt != "implicit"
        for dtype in DTYPES:
            for dp in (1, 2, 4):
                ests = [estimate_nbytes(ds, include_adj, dtype) for ds in (train, val)]
                ests += [pss.estimate_sharded_nbytes(ds, include_adj and rt == "semantic",
                                                     dtype, dp) for ds in (train, val)]
                budgets = sorted({f * e + d for e in ests for f in (1, 2) for d in (-1, 0)})
                for b in budgets:
                    cfg = Config(feature_dtype=dtype, device_store_budget_gb=b / 1e9,
                                 relation_type=rt)
                    jcfg = JaxConfig(feature_dtype=dtype, device_store_budget_gb=b / 1e9,
                                     relation_type=rt)
                    for tr, jtr in ((train, jtrain), (None, None)):
                        got = resolve_data_mode(cfg, val, tr, include_adj, dp=dp)
                        assert got == jax_resolve_data_mode(jcfg, jval, jtr, include_adj, dp)
                        seen.add(got)
    assert seen == {"device", "sharded", "host"}
    forced = Config(data_mode="sharded", device_store_budget_gb=1e-9)
    assert resolve_data_mode(forced, val, train, True, dp=2) == "sharded"
