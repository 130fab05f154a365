"""Operator vocabulary (counterpart: flexflow_tpu/ops/op_type.py).

The same names and values as the JAX package, so graphs built by either
package compare op for op. Only the ops this package lowers are listed
(ops/__init__.py registers them); the JAX enum holds the rest.
"""

from __future__ import annotations

import enum


class OperatorType(enum.Enum):
    DROPOUT = "dropout"
    LINEAR = "linear"
    LAYERNORM = "layer_norm"
    EW_ADD = "add"
    EMBEDDING = "embedding"
    MULTIHEAD_ATTENTION = "multihead_attention"

    def __repr__(self):  # terse for debug output
        return self.value
