"""Question/answer entries of one split (counterpart of
tf_vqa_regat_tpu/data/entries.py): the questions JSON joined with the cached
soft-target pickle, sorted by question id, with the reference's alignment
asserts (reference dataset.py:22-151).

Entries are flat numpy columns (token ids, ragged label and score arrays).
An answerless test split (`test2015`, `test-dev2015`) reads no target
pickle and has no labels.
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from tf_vqa_regat_tpu_torch.data.dictionary import Dictionary, encode_question

COUNTING_ONLY = False  # reference dataset.py:22


def is_howmany(q: str, a: Optional[dict], label2ans) -> bool:
    """Trott et al. counting-question filter (reference dataset.py:26-43)."""
    ql = q.lower()
    if (
        "how many" in ql
        or ("number of" in ql and "number of the" not in ql)
        or "amount of" in ql
        or "count of" in ql
    ):
        return a is None or answer_filter(a, label2ans)
    return False


def answer_filter(answers: dict, label2ans, max_num: int = 10) -> bool:
    for ans in answers["labels"]:
        if label2ans[ans].isdigit() and max_num >= int(label2ans[ans]):
            return True
    return False


@dataclass
class EntryTable:
    """Column-oriented entries of one split."""

    question_ids: np.ndarray  # [N] int64
    image_ids: np.ndarray  # [N] int64
    image_index: np.ndarray  # [N] int32, into the feature table's images
    q_tokens: np.ndarray  # [N, 14] int32
    label_offsets: np.ndarray  # [N+1] int64, ragged soft targets
    labels: np.ndarray  # [sum] int32
    scores: np.ndarray  # [sum] float32
    has_answers: bool

    def __len__(self) -> int:
        return len(self.question_ids)


def assert_unique_labels(ent: EntryTable, num_ans: int) -> None:
    """Within an entry, answer labels must be unique: the device gather
    scatters scores with add, so a repeated label would count twice.
    Reference target pickles are duplicate-free by construction."""
    if len(ent.labels) == 0:
        return
    counts = np.diff(ent.label_offsets).astype(np.int64)
    rows = np.repeat(np.arange(len(ent), dtype=np.int64), counts)
    key = rows * np.int64(num_ans) + ent.labels
    if len(np.unique(key)) != len(key):
        raise ValueError(
            "duplicate answer labels within an entry: the add-scatter would "
            "count their scores twice — fix the target cache"
        )


def question_path(dataroot: str, name: str) -> str:
    """reference dataset.py:119-121"""
    suffix = name + "2014" if name[:4] != "test" else name
    return os.path.join(dataroot, "Questions/v2_OpenEnded_mscoco_%s_questions.json" % suffix)


def entry_table(
    qids: List[int], iids: List[int], iidx: List[int], toks: List[List[int]],
    label_list: List[np.ndarray], score_list: List[np.ndarray], has_answers: bool,
    max_q_len: int = 14,
) -> EntryTable:
    """The columns of per-entry lists; `q_tokens` keeps its [n, max_q_len]
    shape for an empty split."""
    offsets = np.zeros(len(qids) + 1, np.int64)
    np.cumsum([len(x) for x in label_list], out=offsets[1:])
    return EntryTable(
        question_ids=np.asarray(qids, np.int64),
        image_ids=np.asarray(iids, np.int64),
        image_index=np.asarray(iidx, np.int32),
        q_tokens=np.asarray(toks, np.int32).reshape(len(qids), max_q_len),
        label_offsets=offsets,
        labels=np.concatenate(label_list) if label_list else np.zeros((0,), np.int32),
        scores=np.concatenate(score_list) if score_list else np.zeros((0,), np.float32),
        has_answers=has_answers,
    )


def load_entries(
    dataroot: str,
    name: str,
    img_id2idx: Dict[int, int],
    label2ans: List[str],
    dictionary: Dictionary,
    max_q_len: int = 14,
) -> EntryTable:
    """Join and tokenize one split ('train' | 'val' | 'test-dev2015' | 'test2015')."""
    with open(question_path(dataroot, name)) as fh:
        questions = sorted(json.load(fh)["questions"], key=lambda x: x["question_id"])

    is_test = name[:4] == "test"
    answers: Optional[List[dict]] = None
    if not is_test:
        with open(os.path.join(dataroot, "cache", "%s_target.pkl" % name), "rb") as fh:
            answers = sorted(pickle.load(fh), key=lambda x: x["question_id"])
        assert len(questions) == len(answers), (
            f"{len(questions)} questions vs {len(answers)} answers"
        )

    qids, iids, iidx, toks, label_list, score_list = [], [], [], [], [], []
    for i, question in enumerate(questions):
        answer = answers[i] if answers is not None else None
        if answer is not None:
            assert question["question_id"] == answer["question_id"]
            assert question["image_id"] == answer["image_id"]
        if COUNTING_ONLY and not is_howmany(
            question["question"], answer, label2ans if answer is not None else None
        ):
            continue
        qids.append(question["question_id"])
        iids.append(question["image_id"])
        iidx.append(img_id2idx[question["image_id"]])
        toks.append(encode_question(dictionary, question["question"], max_q_len))
        if answer is not None:
            label_list.append(np.asarray(answer["labels"], np.int32).ravel())
            score_list.append(np.asarray(answer["scores"], np.float32).ravel())
        else:
            label_list.append(np.zeros((0,), np.int32))
            score_list.append(np.zeros((0,), np.float32))
    return entry_table(qids, iids, iidx, toks, label_list, score_list, not is_test, max_q_len)
