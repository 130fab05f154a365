"""LayerNorm, softmax, log_softmax and Dropout (counterpart:
flexflow_tpu/ops/norm_ops.py).

Layer norm takes its statistics and its affine in f32 (eps 1e-5 by
default) and casts back to the activation dtype, as the JAX lowering does.
Dropout is the identity in inference and at rate 0; in training it keeps
each element with probability keep = 1 - rate, drawn as a bool mask from
the layer's key (`LoweringCtx.dropout_mask`), and returns
where(mask, x / keep, 0) in x's dtype, as the JAX lowering does.
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


def _softmax_infer(layer: "Layer"):
    return [layer.inputs[0].spec]


def _softmax_lower(layer: "Layer", inputs, weights, ctx):
    fn = (torch.log_softmax if layer.op_type is OperatorType.LOG_SOFTMAX
          else torch.softmax)
    return [fn(inputs[0], dim=layer.params.get("axis", -1))]


register_op(OperatorType.SOFTMAX, _softmax_infer, _softmax_lower)
register_op(OperatorType.LOG_SOFTMAX, _softmax_infer, _softmax_lower)


def _dropout_infer(layer: "Layer"):
    return [layer.inputs[0].spec]


def apply_dropout(x, layer: "Layer", ctx, rate: float):
    """where(mask, x / keep, 0) in x's dtype, the mask drawn for `layer`."""
    keep = 1.0 - rate
    mask = ctx.dropout_mask(layer, x.shape, keep, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _dropout_lower(layer: "Layer", inputs, weights, ctx):
    x = inputs[0]
    rate = layer.params.get("rate", 0.5)
    if not ctx.training or rate <= 0.0:
        return [x]
    return [apply_dropout(x, layer, ctx, rate)]


register_op(OperatorType.DROPOUT, _dropout_infer, _dropout_lower)
