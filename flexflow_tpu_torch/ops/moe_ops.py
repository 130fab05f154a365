"""MoE ops: group_by (dispatch), experts, aggregate (combine) and cache
(counterpart: flexflow_tpu/ops/moe_ops.py).

Capacity-factor routing with static shapes, as in the JAX package:
group_by writes a dense (n_experts, capacity, d) dispatch buffer and the
per-(token, choice) slot positions, -1 where a choice overflowed its
expert's capacity `cap = max(1, ceil(alpha * k * batch / n_experts))`;
`experts` is one batched per-expert dense; aggregate gathers each choice's
expert output back and weights it by its gate.

Nothing here reads a count back to the host (no `nonzero`, `.item()` or
boolean indexing), so a K-step CUDA graph can capture the ops:

- the positions are `cumsum(one_hot) * one_hot - 1` and a max over the
  experts, in int32 (JAX's dtype and tie order), the one-hot taken by a
  comparison with `arange`;
- the tokens are written with `index_put` (no accumulation) into a
  `cap + 1` buffer whose last slot takes the overflowed tokens and is
  sliced off, as JAX's `.at[].set(mode="drop")` into the same buffer: an
  overflowed token's gradient is then exactly 0;
- a dropped pair reads slot 0 of its expert with gate weight 0, so the
  gather's backward adds exact zeros there: every buffer row gets at most
  one nonzero term, and two backward passes agree bitwise.

The expert product is `torch.einsum` (a batched matmul), which JAX leaves
to XLA outside any Pallas kernel.

Expert parallelism over a mesh (the `ep:{axis}` strategy: the dispatch
buffer's and the experts' dim 0 on one axis of P ranks, each rank owning
E / P experts) computes what world 1 computes, JAX's global capacity and
drops included, on each rank's tokens:
- group_by (`_group_by_ep`): the positions are global: each rank adds to
  its own cumsum the tokens of each expert in the batch shards before its
  own (one c10d all-gather of E counts). Each rank writes its tokens into
  a dense (E, cap, d) buffer; when the tokens are sharded over the expert
  axis, one c10d `all_to_all_single` sends each owner its experts' rows
  and the owner sums what it received (`_ScatterToOwners`; the slots are
  disjoint); when they are replicated over it, each rank keeps its own
  experts' rows. A batch axis besides sums the buffer by a c10d
  all-reduce. The buffer comes out sharded over the expert axis.
- experts run on the rank's own experts (its `kernel` block).
- aggregate (`_aggregate_ep`): the owners' outputs come back by one
  `all_to_all_single` (`_GatherFromOwners`), and each rank combines its
  tokens' choices as world 1 does.
The backward of each all-to-all is the transposed all-to-all; the
gradients left partial over a batch axis are declared so (DTensor's
`Partial`) and summed where DTensor next needs them. The expert weights'
gradients stay with their owners.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import torch

from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.dtype import DataType
from flexflow_tpu_torch.ops.activations import apply_activation
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import register_op

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer


def _group_by_infer(layer: "Layer"):
    data, assign = layer.inputs[0].spec, layer.inputs[1].spec
    n_experts = layer.params["n_experts"]
    alpha = layer.params.get("alpha", 1.0)
    b, k = assign.shape
    cap = max(1, int(math.ceil(alpha * k * b / n_experts)))
    layer.params["capacity"] = cap
    return [
        TensorSpec((n_experts, cap, data.shape[-1]), data.dtype),
        TensorSpec((b, k), DataType.INT32),
    ]


def _ep_axis(layer: "Layer", ctx):
    """The expert axis of an expert-parallel group_by: the mesh axis its
    strategy shards the dispatch buffer's dim 0 over (held to its guard
    at compile), None off a mesh or without one."""
    sh = ctx.mesh_sharding(layer)
    dims = sh.output_dims(0) if sh is not None else None
    return dims[0] if dims else None


def _positions(flat, n_experts: int, cap: int, offset=None):
    """Each (token, choice)'s slot in its expert, counted from `offset`
    (E,) tokens of that expert before this batch (global order), and its
    validity."""
    experts = torch.arange(n_experts, dtype=torch.int32, device=flat.device)
    oh = (flat[:, None] == experts[None, :]).to(torch.int32)  # (b*k, E)
    # each (token, choice)'s rank among its expert's, -1 in other columns
    pos = torch.cumsum(oh, dim=0, dtype=torch.int32) * oh - 1
    if offset is not None:
        pos = pos + offset[None, :] * oh
    pos_own = pos.max(dim=1).values
    return pos_own, pos_own < cap


def _dispatch(data, flat, pos_own, valid, n_experts: int, cap: int, k: int):
    """The dense (E, cap, d) buffer of these tokens: each valid choice at
    its slot, the overflowed ones in a `cap + 1`-th slot sliced off."""
    b = data.shape[0]
    slot = torch.where(valid, pos_own, torch.full_like(pos_own, cap))
    # token i once per choice, (b*k, d) in (token, choice) order, as a
    # view and a copy (no repeat count read back)
    tokens = data[:, None, :].expand(b, k, data.shape[-1]).reshape(b * k, -1)
    buf = data.new_zeros((n_experts, cap + 1, data.shape[-1]))
    buf = buf.index_put((flat.long(), slot.long()), tokens)
    return buf[:, :cap]


def _group_by_lower(layer: "Layer", inputs, weights, ctx):
    data, assign = inputs
    axis = _ep_axis(layer, ctx)
    if axis is not None:
        return _group_by_ep(layer, data, assign, ctx, axis)
    n_experts = layer.params["n_experts"]
    cap = layer.params["capacity"]
    b, k = assign.shape
    flat = assign.reshape(-1).to(torch.int32)  # (b*k,)
    pos_own, valid = _positions(flat, n_experts, cap)
    positions = torch.where(valid, pos_own,
                            torch.full_like(pos_own, -1)).reshape(b, k)
    return [_dispatch(data, flat, pos_own, valid, n_experts, cap, k),
            positions]


# ------------------------------------------------ expert parallelism
def _a2a_sum(t, mesh, axis: str):
    """(E, ...) per rank -> (E/P, ...): each owner's rows from every rank
    of the axis, summed (one even `all_to_all_single`)."""
    import torch.distributed as dist

    from flexflow_tpu_torch.runtime.distributed import axis_group, axis_size

    p = axis_size(mesh, axis)
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=axis_group(mesh, axis))
    return out.view(p, t.shape[0] // p, *t.shape[1:]).sum(0)


def _a2a_gather(t, mesh, axis: str):
    """(E/P, ...) per rank -> (E, ...): every owner's rows on every rank
    of the axis (one even `all_to_all_single` of P copies)."""
    import torch.distributed as dist

    from flexflow_tpu_torch.runtime.distributed import axis_group, axis_size

    p = axis_size(mesh, axis)
    send = t.unsqueeze(0).expand(p, *t.shape).contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=axis_group(mesh, axis))
    return out.view(p * t.shape[0], *t.shape[1:])


class _ScatterToOwners(torch.autograd.Function):
    """Tokens sharded over the expert axis: each rank's dense (E, cap, d)
    buffer to the experts' owners, summed there; the backward is the
    transposed all-to-all."""

    @staticmethod
    def forward(ctx, buf, mesh, axis):
        ctx.ring = (mesh, axis)
        return _a2a_sum(buf, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _a2a_gather(g, *ctx.ring), None, None


class _GatherFromOwners(torch.autograd.Function):
    """Every owner's expert outputs on every rank of the expert axis; the
    backward sends each owner its rows' gradients and sums them when the
    tokens are sharded over the axis, and keeps this rank's own rows when
    they are replicated over it (each rank's gradient is then the whole
    one)."""

    @staticmethod
    def forward(ctx, y, mesh, axis, tokens_sharded):
        ctx.ring = (mesh, axis, tokens_sharded)
        return _a2a_gather(y, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        from flexflow_tpu_torch.runtime.distributed import (axis_index,
                                                            axis_size)

        mesh, axis, sharded = ctx.ring
        if sharded:
            return _a2a_sum(g, mesh, axis), None, None, None
        n = g.shape[0] // axis_size(mesh, axis)
        i = axis_index(mesh, axis)
        return g[i * n:(i + 1) * n], None, None, None


def _batch_layout(x, mesh):
    """`x`'s shards of its batch dim (dim 0), Replicate on every other
    mesh dim; a plain tensor every rank holds is Replicate."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return [Replicate()] * mesh.ndim
    return [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]


def _local(x, mesh, pl, grad_pl=None):
    """`x` (a DTensor, or a plain tensor every rank holds) as this rank's
    block under placements `pl`."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, pl).to_local(grad_placements=grad_pl)


class _AllReduceSum(torch.autograd.Function):
    """The sum over a batch axis's ranks (c10d all-reduce); each rank then
    holds the whole value, whose gradient reaches every addend as it is."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _shard_offsets(counts, mesh, batch_dims):
    """(E,) int32: each expert's tokens in the batch shards before this
    rank's, in global row order: the counts of every rank gathered (one
    c10d all-gather), summed over the ranks of this rank's batch group
    whose shard comes first."""
    import numpy as np
    import torch.distributed as dist

    world = dist.get_world_size()
    allc = torch.empty((world * counts.numel(),), dtype=counts.dtype,
                       device=counts.device)
    dist.all_gather_into_tensor(allc, counts.contiguous())
    allc = allc.view(world, -1)
    ranks = mesh.mesh.cpu().numpy()

    def shard(c):
        """The batch shard at mesh coordinate c (they nest in mesh
        order), or None off this rank's batch group."""
        if any(c[j] != me[j] for j in range(ranks.ndim)
               if j not in batch_dims):
            return None
        o = 0
        for j in batch_dims:
            o = o * ranks.shape[j] + int(c[j])
        return o

    me = np.argwhere(ranks == dist.get_rank())[0]
    mine = shard(me)
    earlier = [(s is not None and s < mine) for s in
               (shard(np.argwhere(ranks == r)[0]) for r in range(world))]
    mask = torch.tensor(earlier, dtype=torch.int32, device=counts.device)
    return (allc * mask[:, None]).sum(0).to(torch.int32)


def _group_by_ep(layer: "Layer", data, assign, ctx, axis: str):
    """group_by under `ep:{axis}` (the module docstring)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = ctx.mesh
    names = list(mesh.mesh_dim_names)
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes: {names})")
    xj = names.index(axis)
    n_experts = layer.params["n_experts"]
    cap = layer.params["capacity"]
    bpl = _batch_layout(data, mesh)
    batch_dims = [j for j, p in enumerate(bpl) if isinstance(p, Shard)]
    sharded = xj in batch_dims
    # replicated over the expert axis, each rank's backward covers its own
    # experts' slots only: the tokens' gradient is a sum over the axis
    gpl = [Partial() if (j == xj and not sharded) else p
           for j, p in enumerate(bpl)]
    dl = _local(data, mesh, bpl, gpl)
    al = _local(assign, mesh, bpl)
    b, k = al.shape
    flat = al.reshape(-1).to(torch.int32)
    offset = None
    if batch_dims:
        # by comparison, not bincount, which reads its size back to the
        # host
        experts = torch.arange(n_experts, dtype=torch.int32,
                               device=flat.device)
        counts = (flat[:, None] == experts).sum(0, dtype=torch.int32)
        offset = _shard_offsets(counts, mesh, batch_dims)
    pos_own, valid = _positions(flat, n_experts, cap, offset)
    buf = _dispatch(dl, flat, pos_own, valid, n_experts, cap, k)
    p = mesh.size(xj)
    if sharded:
        buf = _ScatterToOwners.apply(buf, mesh, axis)
    else:
        i = mesh.get_local_rank(axis)
        buf = buf[i * (n_experts // p):(i + 1) * (n_experts // p)]
    for j in batch_dims:
        if j != xj:  # the other batch shards' tokens of these experts
            buf = _AllReduceSum.apply(buf, mesh.get_group(j))
    positions = torch.where(valid, pos_own,
                            torch.full_like(pos_own, -1)).reshape(b, k)
    out_pl = [Shard(0) if j == xj else Replicate() for j in range(mesh.ndim)]
    return [DTensor.from_local(buf, mesh, out_pl, run_check=False),
            DTensor.from_local(positions, mesh, bpl, run_check=False)]


register_op(OperatorType.GROUP_BY, _group_by_infer, _group_by_lower)


def _experts_infer(layer: "Layer"):
    x = layer.inputs[0].spec  # (E, cap, d)
    p = layer.params
    e, cap, d = x.shape
    out_dim = p["out_dim"]
    layer.weight_specs = {"kernel": TensorSpec((e, d, out_dim), x.dtype)}
    if p.get("use_bias", True):
        layer.weight_specs["bias"] = TensorSpec((e, out_dim), x.dtype)
    return [x.with_shape((e, cap, out_dim))]


def _expert_dims(t):
    """The mesh dims on which a DTensor shards its dim 0 (the experts),
    [] for anything else."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return []
    return [j for j, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim == 0]


def _experts_lower(layer: "Layer", inputs, weights, ctx):
    x = inputs[0]
    if _expert_dims(weights["kernel"]):
        # expert parallelism: this rank's experts on its block
        from torch.distributed.tensor import DTensor, Replicate, Shard

        kern = weights["kernel"]
        mesh, ej = kern.device_mesh, _expert_dims(kern)
        pl = [Shard(0) if j in ej else Replicate() for j in range(mesh.ndim)]
        xl = _local(x, mesh, pl)
        y = torch.einsum("ecd,edo->eco", xl,
                         kern.redistribute(mesh, pl).to_local().to(xl.dtype))
        if "bias" in weights:
            bl = weights["bias"].redistribute(mesh, pl).to_local()
            y = y + bl.to(y.dtype)[:, None, :]
        y = apply_activation(layer.params.get("activation"), y)
        return [DTensor.from_local(y, mesh, pl, run_check=False)]
    y = torch.einsum("ecd,edo->eco", x, weights["kernel"].to(x.dtype))
    if "bias" in weights:
        y = y + weights["bias"].to(y.dtype)[:, None, :]
    return [apply_activation(layer.params.get("activation"), y)]


def _experts_flops(layer: "Layer"):
    x = layer.inputs[0].spec
    return 2.0 * x.num_elements * layer.params["out_dim"]


register_op(OperatorType.EXPERTS, _experts_infer, _experts_lower,
            _experts_flops)


def _aggregate_infer(layer: "Layer"):
    gates, assign, positions, exp = [t.spec for t in layer.inputs]
    b, k = gates.shape
    return [TensorSpec((b, exp.shape[-1]), exp.dtype)]


def _combine(gates, assign, positions, exp):
    valid = positions >= 0
    slot = torch.where(valid, positions, torch.zeros_like(positions))
    gathered = exp[assign.long(), slot.long()]  # (b, k, dout)
    w = torch.where(valid, gates, torch.zeros_like(gates)).to(exp.dtype)
    return torch.einsum("bk,bkd->bd", w, gathered)


def _aggregate_ep(gates, assign, positions, exp):
    """aggregate over experts sharded on a mesh axis (the module
    docstring): the owners' outputs by one all-to-all, then this rank's
    tokens combined."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = exp.device_mesh
    (xj,) = _expert_dims(exp)
    axis = mesh.mesh_dim_names[xj]
    bpl = _batch_layout(gates, mesh)
    sharded = isinstance(bpl[xj], Shard)
    # the owners' gradient from this rank's tokens only: a sum over the
    # other batch axes, declared pending
    gpl = [Shard(0) if j == xj else
           (Partial() if isinstance(p, Shard) else Replicate())
           for j, p in enumerate(bpl)]
    epl = [Shard(0) if j == xj else Replicate() for j in range(mesh.ndim)]
    yl = _local(exp, mesh, epl, gpl)
    full = _GatherFromOwners.apply(yl, mesh, axis, sharded)
    out = _combine(_local(gates, mesh, bpl), _local(assign, mesh, bpl),
                   _local(positions, mesh, bpl), full)
    return DTensor.from_local(out, mesh, bpl, run_check=False)


def _aggregate_lower(layer: "Layer", inputs, weights, ctx):
    gates, assign, positions, exp = inputs
    if len(_expert_dims(exp)) == 1:
        return [_aggregate_ep(gates, assign, positions, exp)]
    return [_combine(gates, assign, positions, exp)]


register_op(OperatorType.AGGREGATE, _aggregate_infer, _aggregate_lower)
# aggregate_spec (the speculative-assignment variant used with cache):
# the same combine on the forward path
register_op(OperatorType.AGGREGATE_SPEC, _aggregate_infer, _aggregate_lower)


def _cache_infer(layer: "Layer"):
    return [layer.inputs[0].spec]


def _cache_lower(layer: "Layer", inputs, weights, ctx):
    # a pass-through that keeps the last training input in the
    # non-trainable state, as the JAX lowering does
    x = inputs[0]
    if ctx.training:
        ctx.new_state[f"{layer.name}/cached"] = x.detach()
    return [x]


def _cache_init_state(layer: "Layer", device):
    """The state key the training lowering writes, zero (a captured step
    reads and writes a fixed buffer)."""
    spec = layer.inputs[0].spec
    return {f"{layer.name}/cached": torch.zeros(
        spec.shape, dtype=spec.dtype.torch_dtype, device=device)}


register_op(OperatorType.CACHE, _cache_infer, _cache_lower,
            init_state=_cache_init_state)
