"""Elementwise binary ops (counterpart: flexflow_tpu/ops/elementwise.py).

Only the add GPT-2 needs is lowered so far.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import register_op

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer


def _binary_infer(layer: "Layer"):
    a, b = layer.inputs[0].spec, layer.inputs[1].spec
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return [TensorSpec(tuple(shape), a.dtype)]


def _add_lower(layer: "Layer", inputs, weights, ctx):
    return [inputs[0] + inputs[1]]


register_op(OperatorType.EW_ADD, _binary_infer, _add_lower)
