"""LayerNorm and Dropout (counterpart: flexflow_tpu/ops/norm_ops.py).

Layer norm takes its statistics and its affine in f32 (eps 1e-5 by
default) and casts back to the activation dtype, as the JAX lowering does.
Dropout is the identity in inference and at rate 0; in training at a
rate above 0 it raises, because its mask is not ported yet (it must never
act as a silent identity there).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import register_op

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer


def _ln_infer(layer: "Layer"):
    x = layer.inputs[0].spec
    axes = layer.params.get("axes")
    if axes is None:
        axes = [x.ndim - 1]
    layer.params["axes"] = tuple(sorted(a % x.ndim for a in axes))
    if layer.params.get("elementwise_affine", True):
        nshape = tuple(x.shape[a] for a in layer.params["axes"])
        layer.weight_specs = {"gamma": TensorSpec(nshape, x.dtype),
                              "beta": TensorSpec(nshape, x.dtype)}
    return [x]


def _ln_lower(layer: "Layer", inputs, weights, ctx):
    x = inputs[0]
    axes = layer.params["axes"]
    eps = layer.params.get("eps", 1e-5)
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.var(dim=axes, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if "gamma" in weights:
        bshape = [1] * x.ndim
        for a in axes:
            bshape[a] = x.shape[a]
        y = (y * weights["gamma"].float().reshape(bshape)
             + weights["beta"].float().reshape(bshape))
    return [y.to(x.dtype)]


register_op(OperatorType.LAYERNORM, _ln_infer, _ln_lower)


def _dropout_infer(layer: "Layer"):
    return [layer.inputs[0].spec]


def _dropout_lower(layer: "Layer", inputs, weights, ctx):
    if ctx.training and layer.params.get("rate", 0.0) > 0.0:
        raise NotImplementedError(
            f"{layer.name}: dropout (rate {layer.params['rate']}) in training "
            "is not ported yet; build the model with dropout 0")
    return [inputs[0]]


register_op(OperatorType.DROPOUT, _dropout_infer, _dropout_lower)
