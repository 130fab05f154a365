"""Explicit parallel ops: Repartition / Combine / Replicate / Reduction /
AllToAll / FusedParallel (counterpart: flexflow_tpu/ops/parallel_ops.py).

A parallel op is a resharding request: the search (search/substitution.py)
inserts them into its working graph, `requested_dims` says what layout
each asks for, and compile overlays that layout on the op's output (JAX
`_overlay_parallel_ops`). Over a mesh each lowers to the DTensor
redistribution of its input to that layout, with JAX's semantics:

  repartition(t, dim, axis)   shard `dim` over `axis` (a local slice)
  combine(t, dim, axis)       take `axis` off `dim` (all-gather)
  replicate(t)                replicate every dim (all-gather)
  reduction(t, axis)          the incoming layout with any pending sum
                              resolved (all-reduce of partial results)
  all_to_all(t, src, dst, a)  move `a` from dim src to dim dst
  fused_parallel(t, dims)     straight to the final layout

A layout `constrainable` refuses leaves the input as it is, as a refused
constraint does in JAX. On one device, or on a tensor that is not a
DTensor, each is the identity.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional

from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import register_op

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer


def _identity_infer(layer: "Layer"):
    return [layer.inputs[0].spec]


def _redistribute_lower(layer, inputs, weights, ctx):
    from torch.distributed.tensor import DTensor

    from flexflow_tpu_torch.parallel.sharding import (constrainable, dims_of,
                                                      placements)

    x, mesh = inputs[0], ctx.mesh
    if mesh is None or not isinstance(x, DTensor):
        return [x]
    dims = requested_dims(layer, dims_of(x.placements, mesh, x.ndim))
    axes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    pl = placements(dims, mesh) if constrainable(dims, tuple(x.shape),
                                                 axes) else None
    if pl is None:
        return [x]
    return [x.redistribute(mesh, pl)]


for _t in (OperatorType.REPARTITION, OperatorType.COMBINE,
           OperatorType.REPLICATE, OperatorType.REDUCTION,
           OperatorType.ALLTOALL, OperatorType.FUSED_PARALLEL):
    register_op(_t, _identity_infer, _redistribute_lower)


def requested_dims(layer: "Layer", current: Optional[List] = None
                   ) -> Optional[List]:
    """The output DimSharding this parallel op requests, given the incoming
    dims (None entries = replicated)."""
    nd = layer.inputs[0].spec.ndim
    dims = list(current) if current and len(current) == nd else [None] * nd
    t = layer.op_type
    p = layer.params
    if t is OperatorType.REPARTITION:
        dims[p["dim"] % nd] = p["axis"]
    elif t is OperatorType.COMBINE:
        d = p["dim"] % nd
        cur = dims[d]
        if cur == p["axis"]:
            dims[d] = None
        elif isinstance(cur, tuple):
            dims[d] = tuple(a for a in cur if a != p["axis"]) or None
    elif t is OperatorType.REPLICATE:
        dims = [None] * nd
    elif t is OperatorType.REDUCTION:
        pass  # layout opinion only: keep incoming dims
    elif t is OperatorType.ALLTOALL:
        src, dst = p["src_dim"] % nd, p["dst_dim"] % nd
        dims[src] = None
        dims[dst] = p["axis"]
    elif t is OperatorType.FUSED_PARALLEL:
        dims = list(p["dims"])
    return dims
