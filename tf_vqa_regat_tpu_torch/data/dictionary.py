"""Question vocabulary and the reference's tokenizer (counterpart of
tf_vqa_regat_tpu/data/dictionary.py).

Tokenize lowercases, drops commas and question marks, splits a possessive
's into its own token, and maps an unknown word to padding_idx - 1
(reference dataset.py:63-77); padding_idx == ntoken. With `add_word` it adds
every new word instead, which is how the TF-IDF init extends the vocabulary
(data/glove.py). The pickle is a plain `[word2idx, idx2word]`, the
reference's `glove/dictionary.pkl`, so a file written by either package
loads in the other. CPU tests hold all of it to the JAX package's.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional


class Dictionary:
    def __init__(
        self,
        word2idx: Optional[Dict[str, int]] = None,
        idx2word: Optional[List[str]] = None,
    ):
        self.word2idx: Dict[str, int] = word2idx if word2idx is not None else {}
        self.idx2word: List[str] = idx2word if idx2word is not None else []

    @property
    def ntoken(self) -> int:
        return len(self.word2idx)

    @property
    def padding_idx(self) -> int:
        return len(self.word2idx)

    def add_word(self, word: str) -> int:
        if word not in self.word2idx:
            self.idx2word.append(word)
            self.word2idx[word] = len(self.idx2word) - 1
        return self.word2idx[word]

    def tokenize(self, sentence: str, add_word: bool) -> List[int]:
        sentence = sentence.lower().replace(",", "").replace("?", "").replace("'s", " 's")
        words = sentence.split()
        if add_word:
            return [self.add_word(w) for w in words]
        return [self.word2idx.get(w, self.padding_idx - 1) for w in words]

    def dump_to_file(self, path: str) -> None:
        with open(path, "wb") as fh:
            pickle.dump([self.word2idx, self.idx2word], fh)

    @classmethod
    def load_from_file(cls, path: str) -> "Dictionary":
        with open(path, "rb") as fh:
            word2idx, idx2word = pickle.load(fh)
        return cls(word2idx, idx2word)

    def __len__(self) -> int:
        return len(self.idx2word)


def encode_question(dictionary: Dictionary, question: str, max_length: int = 14) -> List[int]:
    """Tokenize, clip to `max_length`, pad the back with padding_idx
    (reference dataset.py:250-264)."""
    tokens = dictionary.tokenize(question, False)[:max_length]
    return tokens + [dictionary.padding_idx] * (max_length - len(tokens))
