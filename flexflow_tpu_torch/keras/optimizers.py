"""Keras optimizer wrappers (counterpart: flexflow_tpu/keras/optimizers.py)
over SGDOptimizer and AdamOptimizer."""

from __future__ import annotations

from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer


class SGD:
    def __init__(self, learning_rate=0.01, lr=None, momentum=0.0,
                 nesterov=False, weight_decay=0.0, **kw):
        self.learning_rate = lr if lr is not None else learning_rate
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def to_ff(self):
        return SGDOptimizer(lr=self.learning_rate, momentum=self.momentum,
                            nesterov=self.nesterov,
                            weight_decay=self.weight_decay)


class Adam:
    def __init__(self, learning_rate=0.001, lr=None, beta_1=0.9, beta_2=0.999,
                 epsilon=1e-8, weight_decay=0.0, **kw):
        self.learning_rate = lr if lr is not None else learning_rate
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def to_ff(self):
        return AdamOptimizer(alpha=self.learning_rate, beta1=self.beta_1,
                             beta2=self.beta_2, epsilon=self.epsilon,
                             weight_decay=self.weight_decay)


def get(obj):
    if isinstance(obj, (SGD, Adam)):
        return obj
    if isinstance(obj, str):
        return {"sgd": SGD, "adam": Adam}[obj.lower()]()
    if isinstance(obj, (SGDOptimizer, AdamOptimizer)):
        class _Wrap:  # already a flexflow optimizer
            def __init__(self, o):
                self._o = o

            def to_ff(self):
                return self._o
        return _Wrap(obj)
    raise ValueError(f"unknown optimizer {obj!r}")
