"""Fused-activation helper for the dense lowering
(counterpart: flexflow_tpu/ops/activations.py).

gelu is the tanh approximation: the JAX package calls `jax.nn.gelu`, whose
default is `approximate=True`, while PyTorch's default is the erf form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ACTS = {
    None: lambda x: x,
    "none": lambda x: x,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "silu": F.silu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def apply_activation(name, x):
    if callable(name):
        return name(x)
    return _ACTS[name](x)
