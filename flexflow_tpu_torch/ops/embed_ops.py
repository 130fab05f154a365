"""Embedding lookup (counterpart: flexflow_tpu/ops/embed_ops.py).

Out-of-range ids are clamped into the table, as the JAX package's
`jnp.take(..., mode="clip")` does: serving feeds position ids past the
table once prompt + new tokens outrun `seq`, and those must stay finite
rather than index out of range.
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


def _emb_infer(layer: "Layer"):
    x = layer.inputs[0].spec
    p = layer.params
    out_dim = p["out_dim"]
    dtype = DataType.from_any(p.get("dtype", "float32"))
    layer.weight_specs = {"kernel": TensorSpec((p["num_entries"], out_dim), dtype)}
    if p.get("aggr", "none") == "none":
        return [TensorSpec(x.shape + (out_dim,), dtype)]
    return [TensorSpec(x.shape[:-1] + (out_dim,), dtype)]


def _emb_lower(layer: "Layer", inputs, weights, ctx):
    table = weights["kernel"]
    ids = inputs[0].long().clamp(0, table.shape[0] - 1)
    y = table[ids]
    aggr = layer.params.get("aggr", "none")
    if aggr == "sum":
        y = torch.sum(y, dim=-2)
    elif aggr == "avg":
        y = torch.mean(y, dim=-2)
    return [y]


register_op(OperatorType.EMBEDDING, _emb_infer, _emb_lower)
