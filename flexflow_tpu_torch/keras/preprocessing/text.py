"""Text preprocessing (counterpart: flexflow_tpu/keras/preprocessing/
text.py): the tokenizer and hashing utilities in plain Python, to the
keras API."""

from __future__ import annotations

import json
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np


def text_to_word_sequence(text: str,
                          filters: str = '!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n',
                          lower: bool = True, split: str = " ") -> List[str]:
    if lower:
        text = text.lower()
    table = str.maketrans({c: split for c in filters})
    return [w for w in text.translate(table).split(split) if w]


def one_hot(text: str, n: int, **kw) -> List[int]:
    """Hash each word into [1, n) (the keras 'one_hot' is hashing, not 1-hot)."""
    return hashing_trick(text, n, hash_function=None, **kw)


def hashing_trick(text: str, n: int, hash_function=None,
                  filters: str = '!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n',
                  lower: bool = True, split: str = " ") -> List[int]:
    if hash_function is None:
        # stable across processes (builtin hash is salted)
        import hashlib

        def hash_function(w):
            return int(hashlib.md5(w.encode()).hexdigest(), 16)
    seq = text_to_word_sequence(text, filters=filters, lower=lower, split=split)
    return [1 + (hash_function(w) % (n - 1)) for w in seq]


class Tokenizer:
    """Word-frequency tokenizer: fit_on_texts -> texts_to_sequences /
    sequences_to_matrix (binary/count/freq/tfidf modes). Index 0 is
    reserved; OOV token (if set) takes index 1."""

    def __init__(self, num_words: Optional[int] = None,
                 filters: str = '!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n',
                 lower: bool = True, split: str = " ",
                 char_level: bool = False, oov_token: Optional[str] = None):
        self.num_words = num_words
        self.filters = filters
        self.lower = lower
        self.split = split
        self.char_level = char_level
        self.oov_token = oov_token
        self.word_counts: "OrderedDict[str, int]" = OrderedDict()
        self.word_docs: Dict[str, int] = {}
        self.word_index: Dict[str, int] = {}
        self.index_word: Dict[int, str] = {}
        self.index_docs: Dict[int, int] = {}
        self.document_count = 0

    def _words(self, text):
        if self.char_level:
            return list(text.lower() if self.lower else text)
        return text_to_word_sequence(text, self.filters, self.lower, self.split)

    def fit_on_texts(self, texts: Sequence[str]) -> None:
        for text in texts:
            self.document_count += 1
            words = self._words(text)
            for w in words:
                self.word_counts[w] = self.word_counts.get(w, 0) + 1
            for w in set(words):
                self.word_docs[w] = self.word_docs.get(w, 0) + 1
        ranked = sorted(self.word_counts.items(), key=lambda kv: -kv[1])
        vocab = ([self.oov_token] if self.oov_token else []) + [w for w, _ in ranked]
        self.word_index = {w: i + 1 for i, w in enumerate(vocab)}
        self.index_word = {i: w for w, i in self.word_index.items()}
        self.index_docs = {self.word_index[w]: c for w, c in self.word_docs.items()
                           if w in self.word_index}

    def texts_to_sequences(self, texts: Sequence[str]) -> List[List[int]]:
        oov_i = self.word_index.get(self.oov_token) if self.oov_token else None
        out = []
        for text in texts:
            seq = []
            for w in self._words(text):
                i = self.word_index.get(w)
                if i is not None and (self.num_words is None or i < self.num_words):
                    seq.append(i)
                elif oov_i is not None:
                    seq.append(oov_i)
            out.append(seq)
        return out

    def sequences_to_matrix(self, sequences: Sequence[Sequence[int]],
                            mode: str = "binary") -> np.ndarray:
        if mode not in ("binary", "count", "freq", "tfidf"):
            raise ValueError(f"unknown mode {mode!r}")
        if not self.num_words and not self.word_index:
            raise ValueError("specify num_words or fit the tokenizer first")
        n = self.num_words or (len(self.word_index) + 1)
        x = np.zeros((len(sequences), n), np.float64)
        for r, seq in enumerate(sequences):
            counts: Dict[int, int] = {}
            for i in seq:
                if i < n:
                    counts[i] = counts.get(i, 0) + 1
            for i, c in counts.items():
                if mode == "binary":
                    x[r, i] = 1
                elif mode == "count":
                    x[r, i] = c
                elif mode == "freq":
                    x[r, i] = c / max(1, len(seq))
                else:  # tfidf
                    tf = 1 + np.log(c)
                    idf = np.log(1 + self.document_count /
                                 (1 + self.index_docs.get(i, 0)))
                    x[r, i] = tf * idf
        return x

    def to_json(self) -> str:
        return json.dumps({
            "class_name": "Tokenizer",
            "config": {
                "num_words": self.num_words, "filters": self.filters,
                "lower": self.lower, "split": self.split,
                "char_level": self.char_level, "oov_token": self.oov_token,
                "document_count": self.document_count,
                "word_counts": json.dumps(dict(self.word_counts)),
                "word_docs": json.dumps(self.word_docs),
                "word_index": json.dumps(self.word_index),
                "index_docs": json.dumps({str(k): v
                                          for k, v in self.index_docs.items()}),
            },
        })


def tokenizer_from_json(s: str) -> Tokenizer:
    cfg = json.loads(s)["config"]
    tk = Tokenizer(num_words=cfg["num_words"], filters=cfg["filters"],
                   lower=cfg["lower"], split=cfg["split"],
                   char_level=cfg["char_level"], oov_token=cfg["oov_token"])
    tk.document_count = cfg["document_count"]
    tk.word_counts = OrderedDict(json.loads(cfg["word_counts"]))
    tk.word_docs = json.loads(cfg["word_docs"])
    tk.word_index = json.loads(cfg["word_index"])
    tk.index_word = {i: w for w, i in tk.word_index.items()}
    tk.index_docs = {int(k): v for k, v in json.loads(cfg["index_docs"]).items()}
    return tk
