"""GloVe and TF-IDF word-embedding initialization, on the host, once
(counterpart of tf_vqa_regat_tpu/data/glove.py; reference dataset.py:363-417
and utils.py:93-112).

The side effect that matters: tokenizing the VQA (and Visual Genome)
questions with `add_word=True` extends the dictionary (19,901 -> 28,333
words on the real data) before the precomputed sparse TF-IDF matrix
[ntoken, ext_ntoken] is loaded; the GloVe rows of the extension words come
from the GloVe text file. The sparse-dense product runs once, through scipy.
The model stays sized to the pre-extension vocabulary (VQADataset.ntoken).
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from tf_vqa_regat_tpu_torch.data.dictionary import Dictionary
from tf_vqa_regat_tpu_torch.data.entries import question_path


def extend_dictionary_from_questions(
    names: Sequence[str],
    dictionary: Dictionary,
    dataroot: str = "./data",
    target: Sequence[str] = ("vqa", "vg"),
) -> None:
    """The add_word pass of tfidf_from_questions (reference dataset.py:369-401)."""
    if "vqa" in target:
        for name in names:
            assert name in ("train", "val", "test-dev2015", "test2015")
            with open(question_path(dataroot, name)) as fh:
                for q in json.load(fh)["questions"]:
                    dictionary.tokenize(q["question"], True)
    if "vg" in target:
        vg_path = os.path.join(dataroot, "visualGenome", "question_answers.json")
        if os.path.exists(vg_path):
            with open(vg_path) as fh:
                for vg in json.load(fh):
                    for q in vg["qas"]:
                        dictionary.tokenize(q["question"], True)
        else:
            # the reference crashes here; a VQA-only folder runs without the
            # VG file, and a TF-IDF matrix that needs its words then fails
            # load_tfidf's bounds check, which names this warning
            warnings.warn(
                f"tfidf: {vg_path} missing — dictionary NOT extended with "
                "Visual Genome questions (the reference requires it; "
                "fixtures don't ship it)"
            )


def load_tfidf(dataroot: str, ntoken: int, ext_ntoken: int) -> sp.csr_matrix:
    """The precomputed sparse TF-IDF weights (reference dataset.py:403-406),
    checked against the extended vocabulary's size."""
    inds = np.load(os.path.join(dataroot, "tfidf", "indices.npy"))
    vals = np.load(os.path.join(dataroot, "tfidf", "values.npy"))
    if len(inds) and int(inds[:, 1].max()) >= ext_ntoken:
        raise ValueError(
            f"tfidf indices span column {int(inds[:, 1].max())} but the "
            f"extended dictionary has only {ext_ntoken} words — usually "
            "visualGenome/question_answers.json was missing during the "
            "dictionary-extension pass (see the extend_dictionary warning)"
        )
    return sp.csr_matrix((vals, (inds[:, 0], inds[:, 1])), shape=(ntoken, ext_ntoken))


def create_glove_embedding_init(
    idx2word: Sequence[str], glove_file: str
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """GloVe text rows for the given words; a missing word stays zero
    (reference utils.py:93-112)."""
    word2emb: Dict[str, np.ndarray] = {}
    with open(glove_file, encoding="utf-8") as fh:
        entries = fh.readlines()
    emb_dim = len(entries[0].split(" ")) - 1
    weights = np.zeros((len(idx2word), emb_dim), np.float32)
    for entry in entries:
        vals = entry.split(" ")
        word2emb[vals[0]] = np.asarray(list(map(float, vals[1:])))
    for idx, word in enumerate(idx2word):
        if word in word2emb:
            weights[idx] = word2emb[word]
    return weights, word2emb


def tfidf_from_questions(
    names: Sequence[str],
    dictionary: Dictionary,
    dataroot: str = "./data",
    target: Sequence[str] = ("vqa", "vg"),
) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Extend the dictionary, load the sparse matrix, read the extension
    words' GloVe rows: (tfidf [N, ext], weights [ext - N, 300])."""
    N = len(dictionary)
    extend_dictionary_from_questions(names, dictionary, dataroot, target)
    tfidf = load_tfidf(dataroot, N, len(dictionary))
    glove_file = os.path.join(dataroot, "glove", "glove.6B.300d.txt")
    weights, _ = create_glove_embedding_init(dictionary.idx2word[N:], glove_file)
    return tfidf, weights
