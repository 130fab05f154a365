"""Dataset loaders (counterpart: flexflow_tpu/keras/datasets.py).

Nothing is downloaded: a loader reads a local copy (under $KERAS_DATA_DIR
or ~/.keras/datasets) or else makes deterministic synthetic data of the
same shapes and dtypes, the JAX package's, whose labels a model can learn.
"""

from __future__ import annotations

import os
import warnings

import numpy as np


def _synthetic(shape_x, n_classes, n, seed):
    """Deterministic synthetic images with LEARNABLE labels: each class has
    a fixed random prototype pattern mixed into its images, so models
    genuinely learn (train AND test accuracy rise above chance) and
    accuracy-asserting tests work against synthetic data too (FlexFlow's
    examples/python/keras/accuracy.py pattern needs real
    learnability, not random labels)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=(n, 1)).astype(np.int64)
    noise = rng.integers(0, 256, size=(n,) + shape_x).astype(np.float32)
    protos = np.random.default_rng(1234).normal(
        size=(n_classes,) + shape_x).astype(np.float32)
    x = noise + 45.0 * protos[y.reshape(-1)]
    return np.clip(x, 0, 255).astype(np.uint8), y


class _ImageDataset:
    shape = (3, 32, 32)
    classes = 10
    fname = "cifar10.npz"
    seed = 0

    @classmethod
    def load_data(cls, num_samples: int = 10000):
        for base in (os.environ.get("KERAS_DATA_DIR", ""),
                     os.path.expanduser("~/.keras/datasets")):
            p = os.path.join(base, cls.fname) if base else ""
            if p and os.path.exists(p):
                d = np.load(p)
                return ((d["x_train"][:num_samples], d["y_train"][:num_samples]),
                        (d["x_test"], d["y_test"]))
        warnings.warn(f"{cls.fname} not found locally; using synthetic data "
                      "(no network egress)")
        x, y = _synthetic(cls.shape, cls.classes, num_samples, cls.seed)
        xt, yt = _synthetic(cls.shape, cls.classes, max(64, num_samples // 10),
                            cls.seed + 1)
        return (x, y), (xt, yt)


class cifar10(_ImageDataset):
    shape = (3, 32, 32)
    fname = "cifar10.npz"


class mnist(_ImageDataset):
    shape = (28, 28)
    fname = "mnist.npz"


class reuters:
    """Reuters newswire topics (FlexFlow's python/flexflow/keras/datasets/
    reuters.py + the seq_reuters_mlp example). No egress: looks for a local
    reuters.npz; otherwise generates a deterministic synthetic corpus with
    LEARNABLE topics — each class draws its words from a class-specific
    Zipf-ish distribution, so the reuters MLP pipeline genuinely learns."""

    classes = 46

    @classmethod
    def load_data(cls, path: str = "reuters.npz", num_words=None,
                  skip_top: int = 0, maxlen=None, test_split: float = 0.2,
                  seed: int = 113, num_samples: int = 2000):
        for base in (os.environ.get("KERAS_DATA_DIR", ""),
                     os.path.expanduser("~/.keras/datasets")):
            p = os.path.join(base, path) if base else ""
            if p and os.path.exists(p):
                d = np.load(p, allow_pickle=True)
                xs, ys = list(d["x"]), d["y"].astype(np.int64)
                break
        else:
            warnings.warn("reuters.npz not found locally; using synthetic "
                          "corpus (no network egress)")
            rng = np.random.default_rng(seed)
            vocab = num_words or 1000
            # class-specific word banks: topic c prefers a 30-word cluster
            banks = np.random.default_rng(99).integers(
                4, vocab, size=(cls.classes, 30))
            xs, ys = [], []
            for i in range(num_samples):
                c = int(rng.integers(0, cls.classes))
                length = int(rng.integers(20, 120))
                topical = rng.choice(banks[c], size=length // 2)
                background = rng.integers(4, vocab, size=length - length // 2)
                words = np.concatenate([topical, background])
                rng.shuffle(words)
                xs.append([1] + words.tolist())  # 1 = start marker
                ys.append(c)
            ys = np.asarray(ys, np.int64)
        if num_words:
            xs = [[w for w in s if skip_top <= w < num_words] for s in xs]
        if maxlen:
            from flexflow_tpu_torch.keras.preprocessing.sequence import _remove_long_seq

            xs, ys = _remove_long_seq(maxlen, xs, ys)
            ys = np.asarray(ys, np.int64)
        # keras split semantics: train = leading (1 - test_split) fraction,
        # test = the tail
        n_train = len(xs) - int(len(xs) * test_split)
        return ((xs[:n_train], ys[:n_train]), (xs[n_train:], ys[n_train:]))

    @staticmethod
    def get_word_index(path: str = "reuters_word_index.json"):
        # synthetic corpus has no real words; expose a stable id mapping
        return {f"w{i}": i for i in range(4, 1000)}
