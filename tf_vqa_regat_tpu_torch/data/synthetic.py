"""Synthetic data with the real shapes (counterpart of
tf_vqa_regat_tpu/data/fixtures.py: `synthetic_dataset`, `write_fixture`,
`write_cp_vg_fixture`, `make_dictionary`, `_rand_boxes`).

Each function draws the same numbers in the same order from
`np.random.RandomState` as its JAX counterpart, so a seed gives the JAX
package's data array for array (CPU tests check). They exist because the
port runs without the JAX package, and fixtures.py imports h5py at module
top, which the GPU machine may not have.

- `synthetic_dataset`: an in-memory split (`--synthetic`), as a
  `VQADataset`. Two layouts, as JAX has them: adaptive (10-100 rois per
  image, flat [T, v] tables and per-image `pos_boxes` rows) and fixed-36
  (36 rois per image, [num_images, 36, v] tables). 2048-d features, 3,129
  answers; with `semantic`, a per-image [100, 100] table of semantic edge
  labels 0-15 too.
- `write_dataset` and `write_cp_vg`: a dataset on disk in the reference's
  layout (questions JSON, soft-target and answer-vocabulary pickles,
  image-id maps, dictionary, GloVe and TF-IDF files, VQA-CP and Visual
  Genome files), with each HDF5 feature file written in its converted form
  (data/features.py) instead: the directory data/convert.py makes of the
  HDF5 file JAX's `write_fixture` writes for the same arguments.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional, Tuple

import numpy as np

from tf_vqa_regat_tpu_torch.data.convert import table_meta, write_meta
from tf_vqa_regat_tpu_torch.data.dictionary import Dictionary
from tf_vqa_regat_tpu_torch.data.entries import EntryTable
from tf_vqa_regat_tpu_torch.data.features import (
    FeatureStore,
    VQADataset,
    converted_dir,
    split_stem,
)

_WORDS = (
    "what is the color of dog cat man woman car how many people are "
    "on in a red blue green left right 's bebe"
).split()


def make_dictionary() -> Dictionary:
    d = Dictionary()
    for w in _WORDS:
        d.add_word(w)
    return d


def _rand_boxes(rng, n, W=640.0, H=480.0):
    xy = rng.rand(n, 2) * [W * 0.7, H * 0.7]
    wh = rng.rand(n, 2) * [W * 0.3, H * 0.3] + 4.0
    bb = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    norm = np.zeros((n, 6), np.float32)
    norm[:, 0] = bb[:, 0] / W
    norm[:, 1] = bb[:, 1] / H
    norm[:, 2] = bb[:, 2] / W
    norm[:, 3] = bb[:, 3] / H
    norm[:, 4] = (bb[:, 2] - bb[:, 0] + 1) / W
    norm[:, 5] = (bb[:, 3] - bb[:, 1] + 1) / H
    return bb, norm


def _rand_tables(rng, num_images: int, v_dim: int, adaptive: bool, box_range: Tuple[int, int]):
    """(features, norm_bb, bb, pos_boxes or None): adaptive draws the box
    counts, the features, then the boxes image by image; fixed-36 every
    feature first, then the boxes image by image."""
    if adaptive:
        counts = rng.randint(box_range[0], box_range[1], size=num_images)
        total = int(counts.sum())
        feats = rng.randn(total, v_dim).astype(np.float32)
        bbs = np.zeros((total, 4), np.float32)
        norms = np.zeros((total, 6), np.float32)
        pos = np.zeros((num_images, 2), np.int64)
        off = 0
        for i, c in enumerate(counts):
            bb, nb = _rand_boxes(rng, c)
            bbs[off : off + c] = bb
            norms[off : off + c] = nb
            pos[i] = (off, off + c)
            off += c
        return feats, norms, bbs, pos
    feats = rng.randn(num_images, 36, v_dim).astype(np.float32)
    bbs = np.zeros((num_images, 36, 4), np.float32)
    norms = np.zeros((num_images, 36, 6), np.float32)
    for i in range(num_images):
        bbs[i], norms[i] = _rand_boxes(rng, 36)
    return feats, norms, bbs, None


def synthetic_dataset(
    num_images: int = 64,
    num_questions: int = 512,
    v_dim: int = 2048,
    num_ans: int = 3129,
    seed: int = 0,
    semantic: bool = False,
    name: str = "train",
    adaptive: bool = True,
) -> VQADataset:
    rng = np.random.RandomState(seed)
    d = make_dictionary()
    feats, norms, bbs, pos = _rand_tables(rng, num_images, v_dim, adaptive, (10, 101))
    store = FeatureStore(adaptive, feats, norms, bbs, pos_boxes=pos)
    if semantic:  # drawn here, between the boxes and the answers, as JAX does
        store.semantic_adj = rng.randint(0, 16, size=(num_images, 100, 100)).astype(np.int32)

    n_lab = rng.randint(1, 4, size=num_questions)
    offsets = np.zeros(num_questions + 1, np.int64)
    np.cumsum(n_lab, out=offsets[1:])
    labels = np.concatenate(
        [rng.choice(num_ans, size=k, replace=False) for k in n_lab]
    ).astype(np.int32)
    scores = rng.rand(int(offsets[-1])).astype(np.float32)
    q_tokens = rng.randint(0, d.ntoken, size=(num_questions, 14)).astype(np.int32)
    q_tokens[:, 11:] = d.padding_idx
    entries = EntryTable(
        question_ids=np.arange(num_questions, dtype=np.int64),
        image_ids=np.arange(num_questions, dtype=np.int64) % num_images,
        image_index=(np.arange(num_questions) % num_images).astype(np.int32),
        q_tokens=q_tokens,
        label_offsets=offsets,
        labels=labels,
        scores=scores,
        has_answers=True,
    )
    return VQADataset(
        name=name,
        entries=entries,
        store=store,
        num_ans=num_ans,
        label2ans=["ans%d" % i for i in range(num_ans)],
        dictionary=d,
        relation_type="semantic" if semantic else "implicit",
    )


def write_dataset(
    dataroot: str,
    num_images: int = 10,
    num_questions: int = 20,
    v_dim: int = 64,
    num_ans: int = 13,
    adaptive: bool = True,
    name: str = "train",
    seed: int = 0,
    semantic: bool = False,
    first_image_id: int = 1000,
    first_question_id: int = 0,
    box_range: Tuple[int, int] = (10, 30),
    spatial_seed: Optional[int] = None,
) -> None:
    """One split of the reference's on-disk layout with its features in the
    converted form: JAX `write_fixture`'s files for the same arguments, its
    HDF5 file replaced by what data/convert.py makes of it. `box_range` is
    the [low, high) of the adaptive box counts (JAX's fixture: 10-29; the
    real data: 10-100). With `spatial_seed`, the features also hold an
    `image_adj_matrix` of spatial edge labels 0-11 [num_images, 100, 100],
    drawn from that seed after everything else, so the other files stay
    the fixture's."""
    rng = np.random.RandomState(seed)
    for sub in ("Questions", "cache", "imgids", "glove", "tfidf"):
        os.makedirs(os.path.join(dataroot, sub), exist_ok=True)

    d = make_dictionary()
    d.dump_to_file(os.path.join(dataroot, "glove", "dictionary.pkl"))
    glove = rng.randn(d.ntoken, 300).astype(np.float32) * 0.1
    np.save(os.path.join(dataroot, "glove", "glove6b_init_300d.npy"), glove)
    with open(os.path.join(dataroot, "glove", "glove.6B.300d.txt"), "w") as fh:
        for w in _WORDS[:5]:
            fh.write(w + " " + " ".join("%.4f" % v for v in rng.randn(300) * 0.1) + "\n")

    label2ans = ["ans%d" % i for i in range(num_ans)]
    ans2label = {a: i for i, a in enumerate(label2ans)}
    with open(os.path.join(dataroot, "cache", "trainval_ans2label.pkl"), "wb") as fh:
        pickle.dump(ans2label, fh)
    with open(os.path.join(dataroot, "cache", "trainval_label2ans.pkl"), "wb") as fh:
        pickle.dump(label2ans, fh)

    image_ids = list(range(first_image_id, first_image_id + num_images))
    feats, norms, bbs, pos = _rand_tables(rng, num_images, v_dim, adaptive, box_range)
    arrays = {"image_features": feats, "image_bb": bbs, "spatial_features": norms}
    if pos is not None:
        arrays["pos_boxes"] = pos
    if semantic:
        arrays["semantic_adj_matrix"] = rng.randint(
            0, 16, size=(num_images, 100, 100)).astype(np.int32)
    with open(os.path.join(dataroot, "imgids",
                           "%s_imgid2idx.pkl" % split_stem(name, adaptive)), "wb") as fh:
        pickle.dump({img_id: i for i, img_id in enumerate(image_ids)}, fh)

    questions, targets = [], []
    for qoff in range(num_questions):
        qi = first_question_id + qoff
        img = image_ids[qoff % num_images]
        n_words = rng.randint(3, 10)
        words = [_WORDS[rng.randint(len(_WORDS))] for _ in range(n_words)]
        questions.append({"question_id": qi, "image_id": img, "question": " ".join(words) + "?"})
        n_lab = rng.randint(1, 4)
        labels = rng.choice(num_ans, size=n_lab, replace=False)
        scores = rng.choice([0.3, 0.6, 0.9, 1.0], size=n_lab)
        targets.append({"question_id": qi, "image_id": img, "labels": labels.tolist(),
                        "scores": scores.tolist()})
    qname = name + "2014" if name[:4] != "test" else name
    with open(os.path.join(dataroot, "Questions",
                           "v2_OpenEnded_mscoco_%s_questions.json" % qname), "w") as fh:
        json.dump({"questions": questions}, fh)
    with open(os.path.join(dataroot, "cache", "%s_target.pkl" % name), "wb") as fh:
        pickle.dump(targets, fh)

    n = d.ntoken  # TF-IDF blobs: identity over the base vocabulary
    inds = np.stack([np.arange(n), np.arange(n)], axis=1).astype(np.int64)
    np.save(os.path.join(dataroot, "tfidf", "indices.npy"), inds)
    np.save(os.path.join(dataroot, "tfidf", "values.npy"), np.ones(n, np.float32))

    if spatial_seed is not None:
        arrays["image_adj_matrix"] = np.random.RandomState(spatial_seed).randint(
            0, 12, size=(num_images, 100, 100)).astype(np.int32)
    out = converted_dir(dataroot, name, adaptive)
    os.makedirs(out, exist_ok=True)
    for key, arr in arrays.items():
        np.save(os.path.join(out, key + ".npy"), arr)
    write_meta(out, table_meta(split_stem(name, adaptive) + ".hdf5", arrays))


def write_cp_vg(dataroot: str, num_cp_questions: int = 10) -> None:
    """VQA-CP v2 and Visual Genome files over train and val splits written
    before (JAX `write_cp_vg_fixture`): CP questions over both splits'
    images, test2015 questions for the TF-IDF pass, and VG QA pairs over
    four train images and two val images."""
    with open(os.path.join(dataroot, "cache", "trainval_label2ans.pkl"), "rb") as fh:
        label2ans = pickle.load(fh)
    num_ans = len(label2ans)
    with open(os.path.join(dataroot, "imgids", "train_imgid2idx.pkl"), "rb") as fh:
        train_ids = sorted(pickle.load(fh))
    with open(os.path.join(dataroot, "imgids", "val_imgid2idx.pkl"), "rb") as fh:
        val_ids = sorted(pickle.load(fh))

    rng = np.random.RandomState(7)
    os.makedirs(os.path.join(dataroot, "cp_v2_questions"), exist_ok=True)
    os.makedirs(os.path.join(dataroot, "cache", "cp_v2_cache"), exist_ok=True)
    all_ids = train_ids + val_ids
    for split in ("train", "test"):
        qs, targets = [], []
        for qi in range(num_cp_questions):
            img = all_ids[rng.randint(len(all_ids))]
            words = [_WORDS[rng.randint(len(_WORDS))] for _ in range(5)]
            qid = (0 if split == "train" else 10**6) + qi
            qs.append({"question_id": qid, "image_id": img, "question": " ".join(words) + "?"})
            labels = rng.choice(num_ans, size=2, replace=False)
            targets.append({"question_id": qid, "image_id": img, "labels": labels.tolist(),
                            "scores": [1.0, 0.3]})
        # CP question files are flat JSON lists (no {"questions": ...} wrapper)
        with open(os.path.join(dataroot, "cp_v2_questions",
                               f"vqacp_v2_{split}_questions.json"), "w") as fh:
            json.dump(qs, fh)
        with open(os.path.join(dataroot, "cache", "cp_v2_cache", f"{split}_target.pkl"),
                  "wb") as fh:
            pickle.dump(targets, fh)

    test_qs = [
        {"question_id": 2 * 10**6 + i, "image_id": all_ids[i % len(all_ids)],
         "question": "what is the color of the dog?"}
        for i in range(5)
    ]
    with open(os.path.join(dataroot, "Questions",
                           "v2_OpenEnded_mscoco_test2015_questions.json"), "w") as fh:
        json.dump({"questions": test_qs}, fh)

    os.makedirs(os.path.join(dataroot, "visualGenome"), exist_ok=True)
    image_data, qas = [], []
    for i, coco in enumerate(train_ids[:4]):
        vg_id = 5000 + i
        image_data.append({"image_id": vg_id, "coco_id": coco})
        qas.append({"id": vg_id, "qas": [
            {"qa_id": 9000 + i, "question": "what is the color?",
             "answer": label2ans[i % num_ans]},
            {"qa_id": 9500 + i, "question": "what is this?", "answer": "not-in-vocab-answer"},
        ]})
    for i, coco in enumerate(val_ids[:2]):  # reachable only through --use_both's map
        vg_id = 6000 + i
        image_data.append({"image_id": vg_id, "coco_id": coco})
        qas.append({"id": vg_id, "qas": [
            {"qa_id": 9800 + i, "question": "what color is the cat?",
             "answer": label2ans[(i + 1) % num_ans]},
        ]})
    image_data.append({"image_id": 5999, "coco_id": None})  # non-COCO VG image
    with open(os.path.join(dataroot, "visualGenome", "image_data.json"), "w") as fh:
        json.dump(image_data, fh)
    with open(os.path.join(dataroot, "visualGenome", "question_answers.json"), "w") as fh:
        json.dump(qas, fh)
