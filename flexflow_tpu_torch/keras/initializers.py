"""Keras initializers (counterpart: flexflow_tpu/keras/initializers.py):
name-compatible wrappers over flexflow_tpu_torch.initializers."""

from __future__ import annotations

from flexflow_tpu_torch.initializers import (
    GlorotUniformInitializer,
    NormInitializer,
    UniformInitializer,
    ZeroInitializer,
)


class Initializer:
    @property
    def ffhandle(self):
        return self._ffhandle


class DefaultInitializer(Initializer):
    _ffhandle = None


class Zeros(Initializer):
    def __init__(self):
        self._ffhandle = ZeroInitializer()


class GlorotUniform(Initializer):
    def __init__(self, seed: int = 0):
        self.seed = seed
        self._ffhandle = GlorotUniformInitializer(seed)


class RandomUniform(Initializer):
    def __init__(self, minval=-0.05, maxval=0.05, seed=None):
        self.minval, self.maxval, self.seed = minval, maxval, seed
        self._ffhandle = UniformInitializer(seed or 0, minval, maxval)


class RandomNormal(Initializer):
    def __init__(self, mean=0.0, stddev=0.05, seed=None):
        self.mean, self.stddev, self.seed = mean, stddev, seed
        self._ffhandle = NormInitializer(seed or 0, mean, stddev)
