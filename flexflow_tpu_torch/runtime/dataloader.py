"""Dataloader (counterpart: flexflow_tpu/runtime/dataloader.py).

`SingleDataLoader` keeps the dataset in host numpy arrays and yields one
batch at a time, shuffled by `np.random.default_rng(seed)` exactly as the
JAX package's loader shuffles, so both packages draw the same batches in
the same order. Only full batches are drawn (the JAX loader's default).
The JAX loader's native gather and prefetch thread are not ported: the
caller moves each batch to the device.
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
