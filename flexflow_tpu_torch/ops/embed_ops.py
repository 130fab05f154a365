"""Embedding lookup (counterpart: flexflow_tpu/ops/embed_ops.py).

Out-of-range ids are clamped into the table, as the JAX package's
`jnp.take(..., mode="clip")` does: serving feeds position ids past the
table once prompt + new tokens outrun `seq`, and those must stay finite
rather than index out of range.

Over a mesh a DTensor table is looked up on each rank's blocks
(`_mesh_lookup`), the plain lookup on local tensors: a replicated table
serves the rank's own ids (its gradient a pending sum over the ranks
that hold other ids), a table sharded over its rows serves the ids in
its rows and zeros elsewhere, summed over the row shards (JAX's
attribute-parallel embedding), one sharded over its features serves
those features.
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


def _mesh_lookup(table, ids):
    """table[clamp(ids)] for a DTensor `table` on each rank's blocks (the
    module docstring); `ids` a DTensor or a plain tensor every rank
    holds."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    n, out_nd = table.shape[0], ids.ndim + 1
    ids_pl, out_pl, grad_pl = [], [], []
    for tp, ip in zip(table.placements, ids.placements):
        if isinstance(tp, Shard):
            # a shard of the rows sums over the shards; of the features
            # keeps them apart
            ids_pl.append(Replicate())
            out_pl.append(Partial() if tp.dim == 0 else Shard(out_nd - 1))
            grad_pl.append(tp)
        else:
            keep = ip if isinstance(ip, Shard) else Replicate()
            ids_pl.append(keep)
            out_pl.append(keep)
            grad_pl.append(Partial() if isinstance(keep, Shard)
                           else Replicate())
    idl = ids.redistribute(mesh, ids_pl).to_local().long().clamp(0, n - 1)
    tl = table.to_local(grad_placements=grad_pl)
    coord, lo, rows = mesh.get_coordinate(), 0, n
    for j, tp in enumerate(table.placements):
        if isinstance(tp, Shard) and tp.dim == 0:
            rows //= mesh.size(j)
            lo += coord[j] * rows
    if rows == n:
        out = tl[idl]
    else:
        loc = idl - lo
        hit = (loc >= 0) & (loc < rows)
        out = torch.where(hit[..., None], tl[loc.clamp(0, rows - 1)], 0)
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def _emb_lower(layer: "Layer", inputs, weights, ctx):
    from torch.distributed.tensor import DTensor

    table = weights["kernel"]
    if isinstance(table, DTensor):
        y = _mesh_lookup(table, inputs[0])
    else:
        y = table[inputs[0].long().clamp(0, table.shape[0] - 1)]
    aggr = layer.params.get("aggr", "none")
    if aggr == "sum":
        y = torch.sum(y, dim=-2)
    elif aggr == "avg":
        y = torch.mean(y, dim=-2)
    return [y]


def _emb_flops(layer: "Layer"):
    return float(layer.outputs[0].spec.num_elements)


register_op(OperatorType.EMBEDDING, _emb_infer, _emb_lower, _emb_flops)
