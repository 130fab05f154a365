"""Conv2D, Pool2D, Flat and BatchNorm, NCHW with OIHW kernels
(counterpart: flexflow_tpu/ops/conv_ops.py).

The conv is `F.conv2d` (cuDNN on the card), its kernel cast to the
input's dtype, then the bias and the fused activation. Pooling pads
explicitly (max with -inf, avg with 0) and then pools without padding, so
any padding is taken as JAX's `reduce_window` takes it; avg divides by
kh*kw, pads included (`count_include_pad=True`).

Batch norm is written out as the JAX lowering writes it, not through
`F.batch_norm`, whose conventions differ: statistics in f32, the output
back in the input's dtype; in training the batch mean and the BIASED
variance normalize, and the running stats `{name}/mean`, `{name}/var`
(in `ctx.new_state`, f32, outside autograd) become momentum * old +
(1 - momentum) * batch, momentum 0.9 by default (F.batch_norm's momentum
is the weight of the new value, and its running variance is unbiased). In
inference the running stats normalize (0 and 1 before any step).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.ops.activations import apply_activation
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import register_op

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer


def _out_hw(h, w, p):
    kh, kw = p["kernel_h"], p["kernel_w"]
    sh, sw = p["stride_h"], p["stride_w"]
    ph, pw = p["padding_h"], p["padding_w"]
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(f"conv/pool output collapsed: {(oh, ow)}")
    return oh, ow


def _conv2d_infer(layer: "Layer"):
    x = layer.inputs[0].spec  # (N, C, H, W)
    p = layer.params
    n, c, h, w = x.shape
    groups = p.get("groups", 1)
    if c % groups:
        raise ValueError(f"{layer.name}: {c} channels in {groups} groups")
    oc = p["out_channels"]
    oh, ow = _out_hw(h, w, p)
    layer.weight_specs = {"kernel": TensorSpec(
        (oc, c // groups, p["kernel_h"], p["kernel_w"]), x.dtype)}
    if p.get("use_bias", True):
        layer.weight_specs["bias"] = TensorSpec((oc,), x.dtype)
    return [x.with_shape((n, oc, oh, ow))]


def _conv2d_lower(layer: "Layer", inputs, weights, ctx):
    x = inputs[0]
    p = layer.params
    y = F.conv2d(x, weights["kernel"].to(x.dtype),
                 stride=(p["stride_h"], p["stride_w"]),
                 padding=(p["padding_h"], p["padding_w"]),
                 groups=p.get("groups", 1))
    if "bias" in weights:
        y = y + weights["bias"].to(y.dtype)[None, :, None, None]
    return [apply_activation(p.get("activation"), y)]


def _conv2d_flops(layer: "Layer"):
    o = layer.outputs[0].spec  # N, OC, OH, OW
    p = layer.params
    cin_per_group = layer.inputs[0].spec.shape[1] // p.get("groups", 1)
    return 2.0 * o.num_elements * cin_per_group * p["kernel_h"] * p["kernel_w"]


register_op(OperatorType.CONV2D, _conv2d_infer, _conv2d_lower, _conv2d_flops)


def _pool2d_infer(layer: "Layer"):
    x = layer.inputs[0].spec
    n, c, h, w = x.shape
    oh, ow = _out_hw(h, w, layer.params)
    return [x.with_shape((n, c, oh, ow))]


def _pool2d_lower(layer: "Layer", inputs, weights, ctx):
    x = inputs[0]
    p = layer.params
    kernel = (p["kernel_h"], p["kernel_w"])
    stride = (p["stride_h"], p["stride_w"])
    pads = (p["padding_w"], p["padding_w"], p["padding_h"], p["padding_h"])
    if p.get("pool_type", "max") == "max":
        fill = (float("-inf") if x.is_floating_point()
                else torch.iinfo(x.dtype).min)
        y = F.max_pool2d(F.pad(x, pads, value=fill), kernel, stride)
    else:
        # count_include_pad=True matches the reference's cuDNN default
        y = F.avg_pool2d(F.pad(x, pads, value=0.0), kernel, stride)
    return [apply_activation(p.get("activation"), y)]


register_op(OperatorType.POOL2D, _pool2d_infer, _pool2d_lower)


def _flat_infer(layer: "Layer"):
    x = layer.inputs[0].spec
    return [x.with_shape((x.shape[0], x.num_elements // x.shape[0]))]


register_op(OperatorType.FLAT, _flat_infer,
            lambda l, i, w, c: [i[0].reshape(i[0].shape[0], -1)])


def _bn_infer(layer: "Layer"):
    x = layer.inputs[0].spec  # NCHW (or NC for 2-d input)
    c = x.shape[1]
    layer.weight_specs = {"gamma": TensorSpec((c,), x.dtype),
                          "beta": TensorSpec((c,), x.dtype)}
    return [x]


def _bn_lower(layer: "Layer", inputs, weights, ctx):
    x = inputs[0]
    eps = layer.params.get("eps", 1e-5)
    momentum = layer.params.get("momentum", 0.9)
    axes = tuple(i for i in range(x.ndim) if i != 1)
    bshape = [1] * x.ndim
    bshape[1] = x.shape[1]
    mean_key, var_key = f"{layer.name}/mean", f"{layer.name}/var"
    xf = x.float()
    if ctx.training:
        mean = xf.mean(dim=axes)
        var = xf.var(dim=axes, unbiased=False)
        with torch.no_grad():
            rm = ctx.state.get(mean_key)
            rv = ctx.state.get(var_key)
            rm = torch.zeros_like(mean) if rm is None else rm
            rv = torch.ones_like(var) if rv is None else rv
            ctx.new_state[mean_key] = (momentum * rm
                                       + (1 - momentum) * mean.detach())
            ctx.new_state[var_key] = (momentum * rv
                                      + (1 - momentum) * var.detach())
    else:
        c = x.shape[1]
        mean = ctx.state.get(mean_key)
        var = ctx.state.get(var_key)
        mean = (torch.zeros(c, device=x.device) if mean is None
                else mean.float())
        var = torch.ones(c, device=x.device) if var is None else var.float()
    y = (xf - mean.reshape(bshape)) * torch.rsqrt(var.reshape(bshape) + eps)
    y = (y * weights["gamma"].float().reshape(bshape)
         + weights["beta"].float().reshape(bshape))
    if layer.params.get("relu", False):
        y = F.relu(y)
    return [y.to(x.dtype)]


def _bn_init_state(layer: "Layer", device):
    """The running stats as the lowering takes a missing key: mean 0,
    var 1, f32."""
    c = layer.inputs[0].spec.shape[1]
    return {f"{layer.name}/mean": torch.zeros(c, device=device),
            f"{layer.name}/var": torch.ones(c, device=device)}


register_op(OperatorType.BATCHNORM, _bn_infer, _bn_lower,
            init_state=_bn_init_state)
