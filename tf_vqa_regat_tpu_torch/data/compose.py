"""Dataset composition (counterpart of tf_vqa_regat_tpu/data/compose.py):
VQA-CP v2, the train+val concatenation of --use_both, and the Visual Genome
augmentation of --use_vg, in the layouts of the PyTorch original
(linjieli222/VQA_ReGAT dataset.py, dataset_cp_v2.py):

  VQA-CP v2:  questions  cp_v2_questions/vqacp_v2_{train,test}_questions.json
              (a flat JSON list, unlike VQA v2's {"questions": [...]}),
              targets    cache/cp_v2_cache/{train,test}_target.pkl,
              features   the COCO train2014 and val2014 stores merged (CP
              re-splits across both).
  use_both:   the train and val splits' entries over their merged stores.
  use_vg:     Visual Genome QA pairs over COCO images of the store, with
              in-vocabulary answers (score 1.0).

A merged store's image offsets follow JAX's: the second store's images
start after the first's (`pos_boxes` rows for adaptive, image indices for
fixed-36). Composing concatenates the feature tables, so memory-mapped
(--mmap_features) stores are refused.
"""

from __future__ import annotations

import json
import os
import pickle
import re as _re
from typing import Dict, Tuple

import numpy as np

from tf_vqa_regat_tpu_torch.data.dictionary import Dictionary, encode_question
from tf_vqa_regat_tpu_torch.data.entries import EntryTable, entry_table
from tf_vqa_regat_tpu_torch.data.features import (
    FeatureStore,
    VQADataset,
    load_feature_store,
    load_imgid2idx,
)


def merge_stores(a: FeatureStore, b: FeatureStore) -> Tuple[FeatureStore, int]:
    """(the two stores concatenated, the image-index offset of b's images)."""
    assert a.adaptive == b.adaptive
    if a.features_lazy or b.features_lazy:
        raise ValueError(
            "merge_stores requires materialized stores; reload without "
            "mmap_features to compose splits"
        )

    def cat(x, y):
        return None if x is None or y is None else np.concatenate([x, y], axis=0)

    merged = FeatureStore(
        adaptive=a.adaptive,
        features=cat(a.features, b.features),
        normalized_bb=cat(a.normalized_bb, b.normalized_bb),
        bb=cat(a.bb, b.bb),
        pos_boxes=cat(a.pos_boxes, None if b.pos_boxes is None
                      else b.pos_boxes + a.features.shape[0]),
        semantic_adj=cat(a.semantic_adj, b.semantic_adj),
        spatial_adj=cat(a.spatial_adj, b.spatial_adj),
    )
    return merged, a.num_images


def concat_entries(a: EntryTable, b: EntryTable, b_image_offset: int) -> EntryTable:
    return EntryTable(
        question_ids=np.concatenate([a.question_ids, b.question_ids]),
        image_ids=np.concatenate([a.image_ids, b.image_ids]),
        image_index=np.concatenate([a.image_index, b.image_index + b_image_offset]).astype(
            np.int32),
        q_tokens=np.concatenate([a.q_tokens, b.q_tokens], axis=0),
        label_offsets=np.concatenate([a.label_offsets, a.label_offsets[-1] + b.label_offsets[1:]]),
        labels=np.concatenate([a.labels, b.labels]),
        scores=np.concatenate([a.scores, b.scores]),
        has_answers=a.has_answers and b.has_answers,
    )


def concat_datasets(a: VQADataset, b: VQADataset, name: str) -> VQADataset:
    """--use_both: one dataset spanning both splits' entries and features."""
    store, offset = merge_stores(a.store, b.store)
    return VQADataset(
        name=name,
        entries=concat_entries(a.entries, b.entries, offset),
        store=store,
        num_ans=a.num_ans,
        label2ans=a.label2ans,
        dictionary=a.dictionary,
        relation_type=a.relation_type,
        ntoken=a.ntoken,
    )


def load_vqa_cp_base(dataroot: str, adaptive: bool, relation_types) -> Dict[str, object]:
    """The split-independent half of VQA-CP: the merged COCO train+val
    store, its image-id map and the answer vocabulary. Built once and passed
    to both load_vqa_cp_dataset calls, which then share one store."""
    with open(os.path.join(dataroot, "cache", "trainval_ans2label.pkl"), "rb") as fh:
        ans2label = pickle.load(fh)
    with open(os.path.join(dataroot, "cache", "trainval_label2ans.pkl"), "rb") as fh:
        label2ans = pickle.load(fh)
    store, offset = merge_stores(
        load_feature_store(dataroot, "train", adaptive, relation_types),
        load_feature_store(dataroot, "val", adaptive, relation_types),
    )
    img_id2idx = dict(load_imgid2idx(dataroot, "train", adaptive))
    for k, v in load_imgid2idx(dataroot, "val", adaptive).items():
        img_id2idx.setdefault(k, v + offset)
    return {"store": store, "img_id2idx": img_id2idx, "ans2label": ans2label,
            "label2ans": label2ans}


def load_vqa_cp_dataset(
    name: str,
    dictionary: Dictionary,
    relation_type: str,
    dataroot: str = "data",
    adaptive: bool = False,
    max_q_len: int = 14,
    store_relation_types=None,
    base: Dict[str, object] = None,
) -> VQADataset:
    """VQA-CP v2 split ('train' | 'test') over the merged COCO features;
    `base` shares one load_vqa_cp_base result across splits."""
    assert name in ("train", "test")
    if base is None:
        base = load_vqa_cp_base(dataroot, adaptive, store_relation_types or relation_type)
    img_id2idx = base["img_id2idx"]
    with open(os.path.join(dataroot, "cp_v2_questions", "vqacp_v2_%s_questions.json" % name)) as fh:
        raw = json.load(fh)
    questions = raw["questions"] if isinstance(raw, dict) else raw  # CP = flat list
    questions = sorted(questions, key=lambda x: x["question_id"])
    with open(os.path.join(dataroot, "cache", "cp_v2_cache", "%s_target.pkl" % name), "rb") as fh:
        answers = sorted(pickle.load(fh), key=lambda x: x["question_id"])
    assert len(questions) == len(answers)

    qids, iids, iidx, toks, label_list, score_list = [], [], [], [], [], []
    for q, a in zip(questions, answers):
        assert q["question_id"] == a["question_id"]
        assert q["image_id"] == a["image_id"]
        qids.append(q["question_id"])
        iids.append(q["image_id"])
        iidx.append(img_id2idx[q["image_id"]])
        toks.append(encode_question(dictionary, q["question"], max_q_len))
        label_list.append(np.asarray(a["labels"], np.int32).ravel())
        score_list.append(np.asarray(a["scores"], np.float32).ravel())
    return VQADataset(
        name="cp_" + name,
        entries=entry_table(qids, iids, iidx, toks, label_list, score_list, True, max_q_len),
        store=base["store"],
        num_ans=len(base["ans2label"]),
        label2ans=base["label2ans"],
        dictionary=dictionary,
        relation_type=relation_type,
    )


# Visual Genome answers take the official VQA answer normalization before the
# vocabulary lookup (as JAX's compose.py, from the well-known spec): an answer
# that still misses the vocabulary only drops its augmentation pair.
_VG_ARTICLES = {"a", "an", "the"}
_VG_MANUAL_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
_VG_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "didnt": "didn't", "doesnt": "doesn't",
    "dont": "don't", "hadnt": "hadn't", "hasnt": "hasn't", "havent": "haven't",
    "hed": "he'd", "hes": "he's", "howd": "how'd", "howll": "how'll",
    "hows": "how's", "im": "i'm", "ive": "i've", "isnt": "isn't",
    "itd": "it'd", "itll": "it'll", "lets": "let's", "maam": "ma'am",
    "mightve": "might've", "mustve": "must've", "shant": "shan't",
    "shed": "she'd", "shes": "she's", "shouldve": "should've",
    "shouldnt": "shouldn't", "thats": "that's", "thered": "there'd",
    "therere": "there're", "theres": "there's", "theyd": "they'd",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed": "we'd", "weve": "we've",
    "werent": "weren't", "whatll": "what'll", "whatre": "what're",
    "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've",
    "whod": "who'd", "wholl": "who'll", "whos": "who's", "whove": "who've",
    "whyll": "why'll", "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't", "yall": "y'all",
    "youd": "you'd", "youll": "you'll", "youre": "you're", "youve": "you've",
}
_VG_PUNCT = [
    ";", "/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]
_VG_PERIOD = _re.compile(r"(?!<=\d)(\.)(?!\d)")
_VG_COMMA_DIGITS = _re.compile(r"(\d)(\,)(\d)")


def _vg_process_punctuation(text: str) -> str:
    out = text
    for p in _VG_PUNCT:
        if (p + " " in text or " " + p in text) or (
            _VG_COMMA_DIGITS.search(text) is not None
        ):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _VG_PERIOD.sub("", out)


def _vg_process_digit_article(text: str) -> str:
    words = []
    for word in text.lower().split():
        word = _VG_MANUAL_MAP.get(word, word)
        if word not in _VG_ARTICLES:
            words.append(word)
    return " ".join(_VG_CONTRACTIONS.get(w, w) for w in words)


def preprocess_answer(answer: str) -> str:
    """lowercase, punctuation rules, article/digit-word normalization,
    contractions — then drop remaining commas."""
    answer = _vg_process_digit_article(_vg_process_punctuation(answer.lower()))
    return answer.replace(",", "")


def load_visual_genome_entries(
    dataroot: str,
    dictionary: Dictionary,
    ans2label: Dict[str, int],
    img_id2idx: Dict[int, int],
    max_q_len: int = 14,
) -> EntryTable:
    """--use_vg: VG QA pairs over COCO images present in `img_id2idx`, with
    in-vocabulary answers (score 1.0)."""
    with open(os.path.join(dataroot, "visualGenome", "image_data.json")) as fh:
        image_data = json.load(fh)
    vg_to_coco = {img["image_id"]: img["coco_id"] for img in image_data
                  if img.get("coco_id") is not None}
    with open(os.path.join(dataroot, "visualGenome", "question_answers.json")) as fh:
        vgq = json.load(fh)

    qids, iids, iidx, toks, labels = [], [], [], [], []
    for vg in vgq:
        coco_id = vg_to_coco.get(vg["id"] if "id" in vg else vg.get("image_id"))
        if coco_id is None or coco_id not in img_id2idx:
            continue
        for qa in vg["qas"]:
            answer = preprocess_answer(qa["answer"])
            if answer not in ans2label:
                continue
            qids.append(qa["qa_id"])
            iids.append(coco_id)
            iidx.append(img_id2idx[coco_id])
            toks.append(encode_question(dictionary, qa["question"], max_q_len))
            labels.append(ans2label[answer])
    return entry_table(qids, iids, iidx, toks,
                       [np.asarray([lab], np.int32) for lab in labels],
                       [np.ones(1, np.float32) for _ in labels], True, max_q_len)


def append_entries(ds: VQADataset, extra: EntryTable, name: str) -> VQADataset:
    """Extra entries, already indexed against ds.store, appended to ds."""
    return VQADataset(
        name=name,
        entries=concat_entries(ds.entries, extra, b_image_offset=0),
        store=ds.store,
        num_ans=ds.num_ans,
        label2ans=ds.label2ans,
        dictionary=ds.dictionary,
        relation_type=ds.relation_type,
        ntoken=ds.ntoken,
    )
