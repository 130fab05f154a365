"""Linear (dense) layer and batched matmul (counterpart:
flexflow_tpu/ops/dense_ops.py).

The kernel is stored `(in, out)` as in the JAX package, so `x @ W` reads
the same in both; the product is a plain `torch.matmul`. `batch_matmul`
is `torch.matmul(a, b)` after the seq-length truncation: with the
config's `seq_length` captured at build time (`params["seq_length"]`),
the dims `a_seq_length_dim` / `b_seq_length_dim` are cut to it at shape
inference and sliced to it at run time.

Over a mesh `weight_matmul` takes `x @ W` onto each rank's rows itself
where x is sharded on a dim between its first and its last (a sequence
shard) and W is replicated: DTensor's rule for a 3-d `@` flattens the
leading dims, and torch 2.11's refuses to flatten a sharded dim 1. Each
rank multiplies its rows; W's gradient is a pending sum over the dims x
is sharded on. Every other case is DTensor's own `@`.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

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


def weight_matmul(x, w):
    """x @ w for activations x and a weight w (plain tensors or DTensors;
    the module docstring)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not (isinstance(x, DTensor) and isinstance(w, DTensor)
            and any(isinstance(p, Shard) and 0 < p.dim % x.ndim < x.ndim - 1
                    for p in x.placements)
            and all(p.is_replicate() for p in w.placements)
            and not any(p.is_partial() or (isinstance(p, Shard)
                                           and p.dim % x.ndim == x.ndim - 1)
                        for p in x.placements)):
        return x @ w
    gpl = [Partial() if isinstance(p, Shard) else Replicate()
           for p in x.placements]
    y = x.to_local() @ w.to_local(grad_placements=gpl)
    return DTensor.from_local(y, x.device_mesh, x.placements,
                              run_check=False)


def _linear_lower(layer: "Layer", inputs, weights, ctx):
    x = inputs[0]
    y = weight_matmul(x, weights["kernel"].to(x.dtype))
    if "bias" in weights:
        y = y + weights["bias"].to(y.dtype)
    return [apply_activation(layer.params.get("activation"), y)]


def _linear_flops(layer: "Layer"):
    x = layer.inputs[0].spec
    return 2.0 * x.num_elements * layer.params["out_dim"]


register_op(OperatorType.LINEAR, _linear_infer, _linear_lower, _linear_flops)


def _bmm_trunc_shapes(layer: "Layer", ash, bsh):
    """The shapes after the seq-length truncation (reference batch_matmul
    a/b_seq_length_dim and FFIterationConfig.seq_length)."""
    sl = layer.params.get("seq_length") or 0
    ash, bsh = list(ash), list(bsh)
    if sl > 0:
        ad = layer.params.get("a_seq_length_dim", -1)
        bd = layer.params.get("b_seq_length_dim", -1)
        if ad >= 0 and ash[ad] > sl:
            ash[ad] = sl
        if bd >= 0 and bsh[bd] > sl:
            bsh[bd] = sl
    return tuple(ash), tuple(bsh)


def _bmm_infer(layer: "Layer"):
    a, b = [t.spec for t in layer.inputs]
    ash, bsh = _bmm_trunc_shapes(layer, a.shape, b.shape)
    if ash[:-2] != bsh[:-2] or ash[-1] != bsh[-2]:
        raise ValueError(f"batch_matmul shape mismatch {a} @ {b}")
    return [a.with_shape(ash[:-1] + (bsh[-1],))]


def _bmm_lower(layer: "Layer", inputs, weights, ctx):
    a, b = inputs
    ash, bsh = _bmm_trunc_shapes(layer, a.shape, b.shape)
    if tuple(a.shape) != ash:
        a = a[tuple(slice(0, s) for s in ash)]
    if tuple(b.shape) != bsh:
        b = b[tuple(slice(0, s) for s in bsh)]
    return [torch.matmul(a, b)]


def _bmm_flops(layer: "Layer"):
    a, b = [t.spec for t in layer.inputs]
    return 2.0 * a.num_elements * b.shape[-1]


register_op(OperatorType.BATCHMATMUL, _bmm_infer, _bmm_lower, _bmm_flops)
