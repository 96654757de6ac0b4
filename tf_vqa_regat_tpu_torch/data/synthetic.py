"""In-memory synthetic VQA split with the real shapes (counterpart of
tf_vqa_regat_tpu/data/fixtures.py: `synthetic_dataset`, `make_dictionary`,
`_rand_boxes`).

It draws the same numbers in the same order from `np.random.RandomState`, so
a seed gives the JAX package's split array for array (a CPU test checks).
It exists because the port runs without the JAX package, and fixtures.py
imports h5py at module top, which the GPU machine may not have. Two
layouts, as JAX has them: adaptive (10-100 rois per image, flat [T, v]
tables and per-image `pos_boxes` rows) and fixed-36 (36 rois per image,
[num_images, 36, v] tables). 2048-d features, 3,129 answers; with
`semantic`, a per-image [100, 100] table of semantic edge labels 0-15 too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from tf_vqa_regat_tpu_torch.data.dictionary import Dictionary

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


@dataclass
class EntryTable:
    """Column-oriented entries of one split (the JAX package's EntryTable)."""

    question_ids: np.ndarray  # [N] int64
    image_ids: np.ndarray  # [N] int64
    image_index: np.ndarray  # [N] int32, into pos_boxes
    q_tokens: np.ndarray  # [N, 14] int32
    label_offsets: np.ndarray  # [N+1] int64, ragged soft targets
    labels: np.ndarray  # [sum] int32
    scores: np.ndarray  # [sum] float32


@dataclass
class SyntheticDataset:
    """One split: entries plus the feature tables (the fields the JAX
    package keeps on `VQADataset` and its `FeatureStore`). Adaptive:
    features [total_boxes, v], boxes [total_boxes, 6 | 4] and `pos_boxes`;
    fixed-36: features [num_images, 36, v], boxes [num_images, 36, 6 | 4]
    and no `pos_boxes`."""

    name: str
    entries: EntryTable
    features: np.ndarray  # f32
    normalized_bb: np.ndarray  # f32
    bb: np.ndarray  # f32
    pos_boxes: Optional[np.ndarray]  # [num_images, 2] int64 (start, end) rows, adaptive
    num_ans: int
    label2ans: List[str]
    dictionary: Dictionary
    semantic_adj: Optional[np.ndarray] = None  # [num_images, 100, 100] int32
    adaptive: bool = True

    @property
    def ntoken(self) -> int:
        return self.dictionary.ntoken

    @property
    def padding_idx(self) -> int:
        return self.ntoken

    @property
    def v_dim(self) -> int:
        return self.features.shape[-1]


def synthetic_dataset(
    num_images: int = 64,
    num_questions: int = 512,
    v_dim: int = 2048,
    num_ans: int = 3129,
    seed: int = 0,
    semantic: bool = False,
    name: str = "train",
    adaptive: bool = True,
) -> SyntheticDataset:
    rng = np.random.RandomState(seed)
    d = make_dictionary()
    pos = None
    if adaptive:
        counts = rng.randint(10, 101, size=num_images)
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
    else:  # every feature first, then the boxes image by image
        feats = rng.randn(num_images, 36, v_dim).astype(np.float32)
        bbs = np.zeros((num_images, 36, 4), np.float32)
        norms = np.zeros((num_images, 36, 6), np.float32)
        for i in range(num_images):
            bbs[i], norms[i] = _rand_boxes(rng, 36)
    semantic_adj = None
    if semantic:  # drawn here, between the boxes and the answers, as JAX does
        semantic_adj = rng.randint(0, 16, size=(num_images, 100, 100)).astype(np.int32)

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
    )
    return SyntheticDataset(
        name=name,
        entries=entries,
        features=feats,
        normalized_bb=norms,
        bb=bbs,
        pos_boxes=pos,
        num_ans=num_ans,
        label2ans=["ans%d" % i for i in range(num_ans)],
        dictionary=d,
        semantic_adj=semantic_adj,
        adaptive=adaptive,
    )
