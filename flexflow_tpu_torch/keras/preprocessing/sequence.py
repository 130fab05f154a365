"""Sequence preprocessing (counterpart: flexflow_tpu/keras/preprocessing/
sequence.py): pad_sequences and friends in numpy, to the keras API."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def pad_sequences(sequences, maxlen: Optional[int] = None, dtype="int32",
                  padding: str = "pre", truncating: str = "pre",
                  value=0.0) -> np.ndarray:
    """Pad each sequence to the same length (keras semantics: default
    PRE-padding and PRE-truncation; returns (n, maxlen))."""
    if padding not in ("pre", "post"):
        raise ValueError(f"padding must be 'pre'/'post', got {padding!r}")
    if truncating not in ("pre", "post"):
        raise ValueError(f"truncating must be 'pre'/'post', got {truncating!r}")
    seqs = [list(s) for s in sequences]
    if maxlen is None:
        maxlen = max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), maxlen), value, dtype=dtype)
    for i, s in enumerate(seqs):
        if not s:
            continue
        trunc = s[-maxlen:] if truncating == "pre" else s[:maxlen]
        if padding == "post":
            out[i, :len(trunc)] = trunc
        else:
            out[i, -len(trunc):] = trunc
    return out


def make_sampling_table(size: int, sampling_factor: float = 1e-5) -> np.ndarray:
    """Word-rank -> keep-probability table for skipgram subsampling
    (Zipf-approximated word frequencies, the word2vec heuristic)."""
    gamma = 0.577
    rank = np.arange(size)
    rank[0] = 1
    inv_fq = rank * (np.log(rank) + gamma) + 0.5 - 1.0 / (12.0 * rank)
    f = sampling_factor * inv_fq
    return np.minimum(1.0, np.sqrt(f) + f)


def skipgrams(sequence: Sequence[int], vocabulary_size: int,
              window_size: int = 4, negative_samples: float = 1.0,
              shuffle: bool = True, categorical: bool = False,
              sampling_table: Optional[np.ndarray] = None,
              seed: Optional[int] = None) -> Tuple[List, List]:
    """(word, context) skipgram pairs with sampled negatives."""
    couples: List = []
    labels: List = []
    for i, wi in enumerate(sequence):
        if not wi:
            continue
        if sampling_table is not None:
            if sampling_table[wi] < np.random.random():
                continue
        window_start = max(0, i - window_size)
        window_end = min(len(sequence), i + window_size + 1)
        for j in range(window_start, window_end):
            if j != i and sequence[j]:
                couples.append([wi, sequence[j]])
                labels.append([0, 1] if categorical else 1)
    if negative_samples > 0 and couples:
        n_neg = int(len(labels) * negative_samples)
        words = [c[0] for c in couples]
        np.random.shuffle(words)
        couples += [[words[i % len(words)],
                     np.random.randint(1, vocabulary_size)]
                    for i in range(n_neg)]
        labels += [[1, 0] if categorical else 0] * n_neg
    if shuffle:
        if seed is None:
            seed = np.random.randint(0, 10 ** 6)
        rng = np.random.RandomState(seed)
        idx = rng.permutation(len(couples))
        couples = [couples[i] for i in idx]
        labels = [labels[i] for i in idx]
    return couples, labels


def _remove_long_seq(maxlen: int, seq, label):
    """Drop (sequence, label) pairs whose sequence exceeds maxlen."""
    new_seq, new_label = [], []
    for x, y in zip(seq, label):
        if len(x) < maxlen:
            new_seq.append(x)
            new_label.append(y)
    return new_seq, new_label
