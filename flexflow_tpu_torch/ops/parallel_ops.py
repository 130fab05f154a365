"""Explicit parallel ops: Repartition / Combine / Replicate / Reduction /
AllToAll / FusedParallel (counterpart: flexflow_tpu/ops/parallel_ops.py).

A parallel op is a resharding request: the search (search/substitution.py)
inserts them into its working graph, and `requested_dims` says what
layout each asks for. On one device there is nothing to move, so each
lowers to the identity, as a one-device mesh makes of them in JAX. Their
collectives run once the port executes over several GPUs.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional

from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import register_op

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer


def _identity_infer(layer: "Layer"):
    return [layer.inputs[0].spec]


def _identity_lower(layer, inputs, weights, ctx):
    return [inputs[0]]


for _t in (OperatorType.REPARTITION, OperatorType.COMBINE,
           OperatorType.REPLICATE, OperatorType.REDUCTION,
           OperatorType.ALLTOALL, OperatorType.FUSED_PARALLEL):
    register_op(_t, _identity_infer, _identity_lower)


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
