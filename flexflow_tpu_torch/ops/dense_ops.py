"""Linear (dense) layer (counterpart: flexflow_tpu/ops/dense_ops.py).

The kernel is stored `(in, out)` as in the JAX package, so `x @ W` reads
the same in both; the product is a plain `torch.matmul`.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.ops.activations import apply_activation
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import register_op

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer


def _linear_infer(layer: "Layer"):
    (x,) = [t.spec for t in layer.inputs]
    out_dim = int(layer.params["out_dim"])
    layer.weight_specs = {"kernel": TensorSpec((x.shape[-1], out_dim), x.dtype)}
    if layer.params.get("use_bias", True):
        layer.weight_specs["bias"] = TensorSpec((out_dim,), x.dtype)
    return [x.with_shape(x.shape[:-1] + (out_dim,))]


def _linear_lower(layer: "Layer", inputs, weights, ctx):
    x = inputs[0]
    y = x @ weights["kernel"].to(x.dtype)
    if "bias" in weights:
        y = y + weights["bias"].to(y.dtype)
    return [apply_activation(layer.params.get("activation"), y)]


register_op(OperatorType.LINEAR, _linear_infer, _linear_lower)
