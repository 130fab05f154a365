"""Reductions: reduce_sum/mean/max/min, mean, argmax/argmin and top_k
(counterpart: flexflow_tpu/ops/reduce_ops.py).

A reduction keeps its input's dtype, as `jnp.sum` and friends do (torch
would widen an integer sum to int64); an empty `axes` is the identity, as
in JAX (torch reads `dim=()` as every dim). argmax, argmin and top_k's
indices are int32; top_k returns the k largest of the last dim, largest
first.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.dtype import DataType
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import register_op

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer


def _reduce_shape(x: TensorSpec, axes, keepdims: bool):
    axes = sorted(a % x.ndim for a in axes)
    if keepdims:
        return tuple(1 if i in axes else d
                     for i, d in enumerate(x.shape)), axes
    return tuple(d for i, d in enumerate(x.shape) if i not in axes), axes


def _reduce_infer(layer: "Layer"):
    x = layer.inputs[0].spec
    shape, axes = _reduce_shape(x, layer.params["axes"],
                                layer.params.get("keepdims", False))
    layer.params["axes"] = tuple(axes)
    return [x.with_shape(shape)]


_RFN = {
    OperatorType.REDUCE_SUM: torch.sum,
    OperatorType.REDUCE_MEAN: torch.mean,
    OperatorType.REDUCE_MAX: torch.amax,
    OperatorType.REDUCE_MIN: torch.amin,
    OperatorType.MEAN: torch.mean,
}


def _reduce_lower(layer: "Layer", inputs, weights, ctx):
    x, axes = inputs[0], layer.params["axes"]
    if not axes:
        return [x]
    y = _RFN[layer.op_type](x, dim=axes,
                            keepdim=layer.params.get("keepdims", False))
    return [y.to(x.dtype)]


for _t in _RFN:
    register_op(_t, _reduce_infer, _reduce_lower)


def _arg_infer(layer: "Layer"):
    x = layer.inputs[0].spec
    axis = layer.params.get("axis", -1) % x.ndim
    layer.params["axis"] = axis
    shape = tuple(d for i, d in enumerate(x.shape) if i != axis)
    return [TensorSpec(shape, DataType.INT32)]


register_op(
    OperatorType.ARGMAX, _arg_infer,
    lambda l, i, w, c: [torch.argmax(i[0], dim=l.params["axis"])
                        .to(torch.int32)])
register_op(
    OperatorType.ARGMIN, _arg_infer,
    lambda l, i, w, c: [torch.argmin(i[0], dim=l.params["axis"])
                        .to(torch.int32)])


def _topk_infer(layer: "Layer"):
    x = layer.inputs[0].spec
    shape = x.shape[:-1] + (layer.params["k"],)
    return [x.with_shape(shape), TensorSpec(shape, DataType.INT32)]


def _topk_lower(layer: "Layer", inputs, weights, ctx):
    vals, idx = torch.topk(inputs[0], layer.params["k"], dim=-1)
    return [vals, idx.to(torch.int32)]


register_op(OperatorType.TOPK, _topk_infer, _topk_lower)
