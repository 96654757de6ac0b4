"""Question vocabulary and the reference's tokenizer (counterpart of
tf_vqa_regat_tpu/data/dictionary.py, the part serving needs).

Tokenize lowercases, drops commas and question marks, splits a possessive
's into its own token, and maps an unknown word to padding_idx - 1
(reference dataset.py:63-77); padding_idx == ntoken. A CPU test holds it to
the JAX package's tokenizer.
"""

from __future__ import annotations

from typing import Dict, List


class Dictionary:
    def __init__(self):
        self.word2idx: Dict[str, int] = {}
        self.idx2word: List[str] = []

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

    def tokenize(self, sentence: str) -> List[int]:
        sentence = sentence.lower().replace(",", "").replace("?", "").replace("'s", " 's")
        return [self.word2idx.get(w, self.padding_idx - 1) for w in sentence.split()]


def encode_question(dictionary: Dictionary, question: str, max_length: int = 14) -> List[int]:
    """Tokenize, clip to `max_length`, pad the back with padding_idx
    (reference dataset.py:250-264)."""
    tokens = dictionary.tokenize(question)[:max_length]
    return tokens + [dictionary.padding_idx] * (max_length - len(tokens))
