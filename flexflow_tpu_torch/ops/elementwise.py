"""Elementwise unary and binary ops, scalar ops, cast, noop and input
(counterpart: flexflow_tpu/ops/elementwise.py).

Each op is one PyTorch call. gelu is the tanh approximation, as
`jax.nn.gelu` computes it by default; the comparisons return bool.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.dtype import DataType
from flexflow_tpu_torch.ops.op_type import BINARY_OPS, UNARY_OPS, OperatorType
from flexflow_tpu_torch.ops.registry import register_op

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer


_UNARY_FNS = {
    OperatorType.RELU: F.relu,
    OperatorType.IDENTITY: lambda x: x,
    OperatorType.SIGMOID: torch.sigmoid,
    OperatorType.TANH: torch.tanh,
    OperatorType.ELU: F.elu,
    OperatorType.GELU: lambda x: F.gelu(x, approximate="tanh"),
    OperatorType.EXP: torch.exp,
    OperatorType.LOG: torch.log,
    OperatorType.SIN: torch.sin,
    OperatorType.COS: torch.cos,
    OperatorType.SQRT: torch.sqrt,
    OperatorType.RSQRT: torch.rsqrt,
    OperatorType.SILU: F.silu,
    OperatorType.ERF: torch.erf,
}

# x op scalar
_SCALAR_FNS = {
    OperatorType.POW: torch.pow,
    OperatorType.SCALAR_MULTIPLY: torch.mul,
    OperatorType.SCALAR_ADD: torch.add,
    OperatorType.SCALAR_SUB: torch.sub,
    OperatorType.SCALAR_TRUE_DIV: torch.true_divide,
    OperatorType.SCALAR_FLOOR_DIV: torch.floor_divide,
}


def _unary_infer(layer: "Layer"):
    return [layer.inputs[0].spec]


def _unary_lower(layer: "Layer", inputs, weights, ctx):
    x, t = inputs[0], layer.op_type
    if t in _SCALAR_FNS:
        key = "exponent" if t is OperatorType.POW else "scalar"
        return [_SCALAR_FNS[t](x, layer.params[key])]
    return [_UNARY_FNS[t](x)]


for _t in UNARY_OPS:
    register_op(_t, _unary_infer, _unary_lower)


_BINARY_FNS = {
    OperatorType.EW_ADD: torch.add,
    OperatorType.EW_SUB: torch.sub,
    OperatorType.EW_MUL: torch.mul,
    OperatorType.EW_DIV: torch.true_divide,
    OperatorType.EW_MAX: torch.maximum,
    OperatorType.EW_MIN: torch.minimum,
    OperatorType.EW_EQUAL: torch.eq,
    OperatorType.EW_GREATER: torch.gt,
    OperatorType.EW_LESS: torch.lt,
}

_BOOL_OUT = {OperatorType.EW_EQUAL, OperatorType.EW_GREATER,
             OperatorType.EW_LESS}


def _binary_infer(layer: "Layer"):
    a, b = layer.inputs[0].spec, layer.inputs[1].spec
    shape = torch.broadcast_shapes(a.shape, b.shape)
    dtype = DataType.BOOL if layer.op_type in _BOOL_OUT else a.dtype
    return [TensorSpec(tuple(shape), dtype)]


def _binary_lower(layer: "Layer", inputs, weights, ctx):
    return [_BINARY_FNS[layer.op_type](inputs[0], inputs[1])]


for _t in BINARY_OPS:
    register_op(_t, _binary_infer, _binary_lower)


def _cast_infer(layer: "Layer"):
    return [layer.inputs[0].spec.with_dtype(
        DataType.from_any(layer.params["dtype"]))]


def _cast_lower(layer: "Layer", inputs, weights, ctx):
    return [inputs[0].to(DataType.from_any(layer.params["dtype"]).torch_dtype)]


register_op(OperatorType.CAST, _cast_infer, _cast_lower)
register_op(OperatorType.NOOP, _unary_infer, lambda l, i, w, c: [i[0]])
register_op(OperatorType.INPUT, _unary_infer, lambda l, i, w, c: [i[0]])
