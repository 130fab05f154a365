"""FORK_JOIN, the inter-op-placement composite (counterpart:
flexflow_tpu/ops/fork_join.py).

A fork-join layer holds one sub-graph per branch (`layer.branches`, a
list of (sub_layers, branch_input, branch_output), built by
`FFModel.fork_join` or by `compiler/passes.fuse_fork_joins`); the branch
outputs are joined by add or by a last-dim concat. The search chooses its
placement like any other op: `dp` runs every branch on every device,
`inter:{axis}` puts branch i on index i of a mesh axis, and
`inter:{axis}:{g0}-{g1}-...` divides the axis unequally among the
branches (search/candidates.py).

Weight naming: congruent branches (the same sub-layer names and weight
shapes, position by position) store each sub-weight stacked, one
`stk.{sub}.{w}` of shape (k, ...) whose slice i is branch i's; otherwise
branch i's sub-layer L weight w is `b{i}.{L}.{w}` on the fork-join layer.

Without a mesh, or when the strategy places nothing, every branch runs
on every rank, one after the other, and the outputs are joined: the JAX
lowering's replicated path. Over a mesh where the strategy places it
(`_fj_placed`, JAX `fork_join.py:175-210`), a rank runs only its branch
(parallel/interop.py): stacked weights under `inter:{axis}`
(`place_branches_stacked`, each rank holding its branch's slice),
per-branch weights under it (`place_branches`), and the groups of
`inter:{axis}:{g0}-...` (`place_branches_grouped`). The compile holds the
placement to its guards first (compiler/compile.py
`_check_mesh_strategy`).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List

import torch

from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import LoweringCtx, get_op_def, register_op

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer


def _branch_layers(layer: "Layer", bi: int) -> List["Layer"]:
    return layer.branches[bi][0]


# ops whose lowering writes LoweringCtx.new_state: a placed execution
# cannot carry their state out of the per-device body
_STATEFUL_OPS = frozenset({OperatorType.BATCHNORM, OperatorType.CACHE})


def inter_placeable(layer: "Layer") -> bool:
    """True when this fork_join can execute under inter:{axis} placement:
    equal branch output shapes and no stateful sub-ops."""
    sigs = {(tuple(out.spec.shape), out.spec.dtype)
            for (_l, _b, out) in layer.branches}
    if len(sigs) != 1:
        return False
    return not any(l.op_type in _STATEFUL_OPS
                   for (ls, _b, _o) in layer.branches for l in ls)


def grouped_placeable(layer: "Layer") -> bool:
    """True when this fork_join can execute under unequal group placement
    (`inter:{axis}:{g0}-{g1}-...`): only stateful sub-ops are excluded."""
    return not any(l.op_type in _STATEFUL_OPS
                   for (ls, _b, _o) in layer.branches for l in ls)


def branch_flops(layer: "Layer") -> List[float]:
    """Per-branch flop counts: the load-balance weights of the resource
    division (search/candidates._best_groups)."""
    return [sum(get_op_def(l.op_type).flop_count(l) for l in ls)
            for (ls, _b, _o) in layer.branches]


def branch_weight_bytes(layer: "Layer") -> List[int]:
    return [sum(s.size_bytes for l in ls for s in l.weight_specs.values())
            for (ls, _b, _o) in layer.branches]


def congruent_branches(layer: "Layer") -> bool:
    """True when every branch has the same sub-layer names and weight
    shapes and dtypes, position by position: the case whose weights are
    stored stacked."""
    def sig(layers):
        return tuple((l.name, tuple(sorted(
            (w, s.shape, s.dtype) for w, s in l.weight_specs.items())))
            for l in layers if l.weight_specs)

    sigs = {sig(ls) for (ls, _b, _o) in layer.branches}
    return len(sigs) == 1 and any(s for s in sigs)


def _fj_infer(layer: "Layer") -> List[TensorSpec]:
    if not layer.branches:
        raise ValueError("fork_join layer has no branches attached "
                         "(build via FFModel.fork_join)")
    join = layer.params["join"]
    x = layer.inputs[0].spec
    out_specs = [out.spec for (_layers, _bx, out) in layer.branches]
    base = out_specs[0]
    for s in out_specs[1:]:
        if s.ndim != base.ndim or (join == "add" and s.shape != base.shape):
            raise ValueError(f"fork_join branch shapes differ: {out_specs}")
        if join == "concat" and s.shape[:-1] != base.shape[:-1]:
            raise ValueError(f"fork_join concat branches must agree on all "
                             f"dims but the last: {out_specs}")
    if base.shape[0] != x.shape[0]:
        raise ValueError("fork_join branches must preserve the batch dim")
    layer.weight_specs = {}
    if congruent_branches(layer):
        k = len(layer.branches)
        for l in layer.branches[0][0]:
            for w, spec in l.weight_specs.items():
                layer.weight_specs[f"stk.{l.name}.{w}"] = TensorSpec(
                    (k,) + tuple(spec.shape), spec.dtype)
    else:
        for bi, (layers, _bx, _out) in enumerate(layer.branches):
            for l in layers:
                for w, spec in l.weight_specs.items():
                    layer.weight_specs[f"b{bi}.{l.name}.{w}"] = spec
    if join == "add":
        return [base]
    last = sum(s.shape[-1] for s in out_specs)
    return [base.with_shape(base.shape[:-1] + (last,))]


def _branch_weight_dicts(layer: "Layer", weights: Dict) -> List[Dict[str, Dict]]:
    """The flat prefixed weight dict split back into per-branch
    {sub_layer_name: {wname: tensor}}; a stacked weight gives branch i its
    slice i (a view: the gradient reaches the stacked param)."""
    out: List[Dict[str, Dict]] = []
    for bi in range(len(layer.branches)):
        d: Dict[str, Dict] = {}
        for k, v in weights.items():
            if k.startswith("stk."):
                lname, wname = k[4:].split(".", 1)
                d.setdefault(lname, {})[wname] = v[bi]
            elif k.startswith(f"b{bi}."):
                # split at the first dot: a nested fork_join's own weight
                # names hold dots ("b0.inner.b0.i1.kernel")
                lname, wname = k[len(f"b{bi}."):].split(".", 1)
                d.setdefault(lname, {})[wname] = v
        out.append(d)
    return out


def stacked_weight_trees(layer: "Layer", weights: Dict):
    """{sub_layer: {wname: (k, ...) tensor}} for stacked storage, or None
    when this layer keeps per-branch weights."""
    stk = {k: v for k, v in weights.items() if k.startswith("stk.")}
    if not stk:
        return None
    tree: Dict[str, Dict] = {}
    for k, v in stk.items():
        lname, wname = k[4:].split(".", 1)
        tree.setdefault(lname, {})[wname] = v
    return tree


def _run_branch(layer: "Layer", bi: int, x, wdict, ctx: LoweringCtx):
    layers, bx, bout = layer.branches[bi]
    env = {bx.guid: x}
    for l in layers:
        ins = [env[t.guid] for t in l.inputs]
        outs = get_op_def(l.op_type).lower(l, ins, wdict.get(l.name, {}), ctx)
        for t, o in zip(l.outputs, outs):
            env[t.guid] = o
    return env[bout.guid]


def _fj_placed(layer: "Layer", x, weights, ctx: LoweringCtx, axis: str,
               groups):
    """The placed lowering: each rank runs its branch on local tensors
    (parallel/interop.py), the sub-layers lowered on a context without
    the mesh."""
    import dataclasses

    from flexflow_tpu_torch.parallel import interop

    sub = dataclasses.replace(ctx, mesh=None, strategy=None)
    k, join = len(layer.branches), layer.params["join"]

    def fn(bi):
        return lambda xv, wd: _run_branch(layer, bi, xv, wd, sub)
    fns = [fn(b) for b in range(k)]
    if groups:
        # weights replicated; a stacked one gives each branch its slice
        gs = tuple(int(g) for g in groups.split("-"))
        out_dims = [out.spec.shape[-1] for (_ls, _bx, out) in layer.branches]
        return interop.place_branches_grouped(
            ctx.mesh, axis, fns, x, _branch_weight_dicts(layer, weights),
            join, gs, out_dims, layer.outputs[0].spec.ndim)
    stacked = stacked_weight_trees(layer, weights)
    if stacked is not None:
        return interop.place_branches_stacked(ctx.mesh, axis, fns, x,
                                              stacked, join)
    return interop.place_branches(ctx.mesh, axis, fns, x,
                                  _branch_weight_dicts(layer, weights), join)


def _fj_lower(layer: "Layer", inputs, weights, ctx: LoweringCtx):
    x = inputs[0]
    sh = ctx.mesh_sharding(layer)
    if sh is not None and "placement" in sh.attrs:
        return [_fj_placed(layer, x, weights, ctx, sh.attrs["placement"],
                           sh.attrs.get("placement_groups"))]
    wdicts = _branch_weight_dicts(layer, weights)
    ys = [_run_branch(layer, bi, x, wd, ctx) for bi, wd in enumerate(wdicts)]
    if layer.params["join"] == "add":
        out = ys[0]
        for y in ys[1:]:
            out = out + y
        return [out]
    return [torch.cat(ys, dim=-1)]


def _fj_flops(layer: "Layer") -> float:
    total = 0.0
    for bi in range(len(layer.branches)):
        for l in _branch_layers(layer, bi):
            total += get_op_def(l.op_type).flop_count(l)
    return total


def _fj_init_state(layer: "Layer", device):
    """The state the branches' stateful sub-ops write (their keys, as
    their own lowerings name them)."""
    out = {}
    for ls, _bx, _o in layer.branches:
        for l in ls:
            init = get_op_def(l.op_type).init_state
            if init is not None:
                out.update(init(l, device))
    return out


register_op(OperatorType.FORK_JOIN, _fj_infer, _fj_lower, _fj_flops,
            init_state=_fj_init_state)
