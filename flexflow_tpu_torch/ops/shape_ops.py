"""Shape and movement ops: reshape, transpose, concat, split, reverse, pad,
slice, gather, expand, constant, where and masked_fill
(counterpart: flexflow_tpu/ops/shape_ops.py).

A constant is made on the run's device (`LoweringCtx.device`) with the
dtype JAX gives it (64-bit values narrow to 32 bits, as with x64 off);
under the mixed policy a floating constant takes the compute dtype, so it
does not promote its bf16 neighbours back to f32.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, List

import numpy as np
import torch
import torch.nn.functional as F

from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.dtype import DataType
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import register_op

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer


def _reshape_infer(layer: "Layer"):
    x = layer.inputs[0].spec
    shape = list(layer.params["shape"])
    if shape.count(-1) > 1:
        raise ValueError("at most one -1 in reshape")
    if -1 in shape:
        known = math.prod(d for d in shape if d != -1)
        shape[shape.index(-1)] = x.num_elements // known
    if math.prod(shape) != x.num_elements:
        raise ValueError(f"reshape {x.shape} -> {shape} element mismatch")
    layer.params["shape"] = tuple(shape)
    return [x.with_shape(shape)]


register_op(OperatorType.RESHAPE, _reshape_infer,
            lambda l, i, w, c: [i[0].reshape(l.params["shape"])])


def _transpose_infer(layer: "Layer"):
    x = layer.inputs[0].spec
    perm = tuple(p % x.ndim for p in layer.params["perm"])
    layer.params["perm"] = perm
    return [x.with_shape(tuple(x.shape[p] for p in perm))]


register_op(OperatorType.TRANSPOSE, _transpose_infer,
            lambda l, i, w, c: [i[0].permute(l.params["perm"])])


def _concat_infer(layer: "Layer"):
    specs = [t.spec for t in layer.inputs]
    axis = layer.params["axis"] % specs[0].ndim
    layer.params["axis"] = axis
    shape = list(specs[0].shape)
    shape[axis] = sum(s.shape[axis] for s in specs)
    return [specs[0].with_shape(shape)]


register_op(OperatorType.CONCAT, _concat_infer,
            lambda l, i, w, c: [torch.cat(i, dim=l.params["axis"])])


def _split_infer(layer: "Layer"):
    x = layer.inputs[0].spec
    axis = layer.params["axis"] % x.ndim
    layer.params["axis"] = axis
    sizes: List[int] = list(layer.params["sizes"])
    if sum(sizes) != x.shape[axis]:
        raise ValueError(f"split sizes {sizes} != dim {x.shape[axis]}")
    out = []
    for s in sizes:
        shape = list(x.shape)
        shape[axis] = s
        out.append(x.with_shape(shape))
    return out


register_op(OperatorType.SPLIT, _split_infer,
            lambda l, i, w, c: list(torch.split(i[0], list(l.params["sizes"]),
                                                dim=l.params["axis"])))


def _flip_dims(axis):
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


register_op(OperatorType.REVERSE, lambda l: [l.inputs[0].spec],
            lambda l, i, w, c: [torch.flip(i[0],
                                           _flip_dims(l.params["axis"]))])


def _pad_infer(layer: "Layer"):
    x = layer.inputs[0].spec
    pads = layer.params["pads"]  # [(lo, hi)] * ndim
    shape = tuple(d + lo + hi for d, (lo, hi) in zip(x.shape, pads))
    return [x.with_shape(shape)]


def _pad_lower(layer: "Layer", inputs, weights, ctx):
    # F.pad lists (lo, hi) from the last dim back
    flat = [p for lo_hi in reversed(layer.params["pads"]) for p in lo_hi]
    return [F.pad(inputs[0], flat, value=layer.params.get("value", 0))]


register_op(OperatorType.PAD, _pad_infer, _pad_lower)


def _slice_infer(layer: "Layer"):
    x = layer.inputs[0].spec
    starts, limits = layer.params["starts"], layer.params["limits"]
    return [x.with_shape(tuple(hi - lo for lo, hi in zip(starts, limits)))]


register_op(OperatorType.SLICE, _slice_infer,
            lambda l, i, w, c: [i[0][tuple(
                slice(lo, hi) for lo, hi in zip(l.params["starts"],
                                                l.params["limits"]))]])


def _gather_infer(layer: "Layer"):
    data, index = layer.inputs[0].spec, layer.inputs[1].spec
    # torch.gather semantics along `dim` (reference: src/ops/gather.cc)
    return [data.with_shape(index.shape)]


register_op(OperatorType.GATHER, _gather_infer,
            lambda l, i, w, c: [torch.gather(i[0], l.params["dim"],
                                             i[1].long())])


def _expand_infer(layer: "Layer"):
    """torch.Tensor.expand semantics: -1 keeps the dim; size-1 dims
    broadcast; new leading dims may be added."""
    x = layer.inputs[0].spec
    sizes = list(layer.params["sizes"])
    lead = len(sizes) - x.ndim
    if lead < 0:
        raise ValueError(f"expand to fewer dims: {x.shape} -> {sizes}")
    shape = []
    for i, s in enumerate(sizes):
        if i < lead:
            shape.append(s if s != -1 else 1)
        else:
            d = x.shape[i - lead]
            shape.append(d if s == -1 else s)
    layer.params["sizes"] = tuple(shape)
    return [x.with_shape(shape)]


register_op(OperatorType.EXPAND, _expand_infer,
            lambda l, i, w, c: [i[0].expand(l.params["sizes"])])


def _constant_infer(layer: "Layer"):
    v = np.asarray(layer.params["value"])
    return [TensorSpec(tuple(v.shape), DataType.from_any(v.dtype))]


# JAX with x64 off holds 64-bit arrays in 32 bits
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def _constant_lower(layer: "Layer", inputs, weights, ctx):
    v = np.asarray(layer.params["value"])
    v = v.astype(_NARROW.get(v.dtype, v.dtype))
    t = torch.from_numpy(np.ascontiguousarray(v)).to(ctx.device)
    if ctx.compute_dtype is not None and t.is_floating_point():
        t = t.to(ctx.compute_dtype)
    return [t]


register_op(OperatorType.CONSTANT, _constant_infer, _constant_lower)


def _where_infer(layer: "Layer"):
    cond, a, b = [t.spec for t in layer.inputs]
    shape = torch.broadcast_shapes(cond.shape, a.shape, b.shape)
    return [a.with_shape(tuple(shape))]


register_op(OperatorType.WHERE, _where_infer,
            lambda l, i, w, c: [torch.where(i[0].bool(), i[1], i[2])])


def _masked_fill_infer(layer: "Layer"):
    x, mask = layer.inputs[0].spec, layer.inputs[1].spec
    return [x.with_shape(tuple(torch.broadcast_shapes(x.shape, mask.shape)))]


def _masked_fill_lower(layer: "Layer", inputs, weights, ctx):
    x, mask = inputs
    fill = torch.tensor(layer.params["value"], dtype=x.dtype, device=x.device)
    return [torch.where(mask.bool(), fill, x)]


register_op(OperatorType.MASKED_FILL, _masked_fill_infer, _masked_fill_lower)
