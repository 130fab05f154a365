"""Dataloader (counterpart: flexflow_tpu/runtime/dataloader.py).

`SingleDataLoader` keeps the dataset in host numpy arrays and yields one
batch at a time, shuffled by `np.random.default_rng(seed)` exactly as the
JAX package's loader shuffles, so both packages draw the same batches in
the same order. Only full batches are drawn (the JAX loader's default).
`group_microbatches` stacks N consecutive batches for gradient
accumulation, as the JAX package's does. The JAX loader's native gather
and prefetch thread are not ported: the caller moves each batch to the
device.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np


class SingleDataLoader:
    def __init__(self, xs: Sequence[np.ndarray], y: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        self.xs = [np.asarray(x) for x in xs]
        self.y = np.asarray(y)
        n = self.y.shape[0]
        for x in self.xs:
            if x.shape[0] != n:
                raise ValueError("all arrays must share the sample dim "
                                 f"({x.shape[0]} vs {n})")
        self.num_samples = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    @property
    def num_batches(self) -> int:
        return self.num_samples // self.batch_size

    def epoch(self) -> Iterator[Tuple[List[np.ndarray], np.ndarray]]:
        """One pass, shuffled when `shuffle` (one permutation per epoch)."""
        order = np.arange(self.num_samples)
        if self.shuffle:
            self.rng.shuffle(order)
        for b in range(self.num_batches):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield [x[idx] for x in self.xs], self.y[idx]


def _batch_shapes(xs, y):
    return tuple(np.asarray(x).shape for x in xs) + (np.asarray(y).shape,)


def group_microbatches(it, n: int):
    """Stack `n` consecutive (inputs, label) batches into (n, ...) arrays,
    one item per accumulating train step. A group that cannot be completed
    with batches of one shape is dropped: the trailing short group, and
    any group broken by a batch of another shape."""
    if n <= 1:
        yield from it
        return
    buf = []
    for xs, y in it:
        if buf and _batch_shapes(xs, y) != _batch_shapes(*buf[0]):
            buf = []  # a ragged batch: the partial group cannot stack
        buf.append((xs, y))
        if len(buf) == n:
            yield ([np.stack([b[0][i] for b in buf])
                    for i in range(len(buf[0][0]))],
                   np.stack([b[1] for b in buf]))
            buf = []
