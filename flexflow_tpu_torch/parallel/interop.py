"""Inter-operator (branch) placement on disjoint ranks (counterpart:
flexflow_tpu/parallel/interop.py).

A mesh axis chosen for placement gives each branch of a fork-join its own
ranks, and a rank runs ONLY its branch, on local tensors (the JAX package
switches on `lax.axis_index` inside a `shard_map`). The batch rows keep
their shards on the batch axes (JAX's `_batch_pspec`: "node" and "data",
never the placement axis); rows that x holds sharded over the placement
axis itself are first gathered over it (c10d all-gather), so every rank
of the axis sees the rows its group computes, and the output comes back
in x's layout. The join happens outside the branch, by c10d calls over
the placement axis: an all-reduce for `add`, an all-gather for `concat`,
and for unequal groups one all-reduce of zero-padded blocks, which
assembles the batch slices and joins in the same collective.

The backward is JAX's explicit VJP (`interop.py:36-42`): each rank
recomputes its branch and pulls its gradients back; dX is summed over the
placement axis (an all-reduce, or a reduce-scatter where x's rows were
gathered); each branch weight's gradient is the sum over exactly the
ranks that ran it. Weights are DTensors (or tensors every rank holds):
- `place_branches_stacked` (congruent branches): one (k, ...) leaf a
  sub-weight, sharded over the placement axis, so each rank holds only
  its branch's slice; its gradient stays sharded and sums only over the
  batch axes (DTensor's `Partial`, resolved where the update reads it);
- `place_branches`, `place_branches_grouped`: replicated weights whose
  gradients are pending sums over the placement and batch axes.
`divide_workers` is JAX's waterfill of workers among branches.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.utils._pytree as pytree


def _mesh_axes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _batch_dims(mesh, axis: str, batch_len: int, batch_axes=None) -> list:
    """The mesh dims the branch bodies shard the batch over: JAX's
    `_batch_pspec` (node and data jointly when their product divides the
    batch, else the first that divides; never the placement axis)."""
    shape = _mesh_axes(mesh)
    names = list(mesh.mesh_dim_names)
    if batch_axes is not None:
        db = [a for a in batch_axes if a in shape and a != axis
              and batch_len % shape[a] == 0]
    else:
        cand = [a for a in ("node", "data") if a in shape and a != axis]
        deg = 1
        for a in cand:
            deg *= shape[a]
        if len(cand) > 1 and batch_len % deg == 0:
            db = cand
        else:
            db = next(([a] for a in cand if batch_len % shape[a] == 0), [])
    return [names.index(a) for a in db]


def _as_dtensor(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _x_layout(x, mesh, axis: str, bdims: list):
    """x's placements in the bodies: Shard(0) on the batch dims, and on
    the placement axis where x already has it and no batch dim comes after
    it in mesh order (its rows are then gathered by c10d); Replicate on
    every other dim. Returns (placements, gathered)."""
    from torch.distributed.tensor import Replicate, Shard

    xj = list(mesh.mesh_dim_names).index(axis)
    p = x.placements[xj]
    gathered = (isinstance(p, Shard) and p.dim == 0
                and all(j < xj for j in bdims))
    pl = [Shard(0) if (j in bdims or (j == xj and gathered)) else Replicate()
          for j in range(mesh.ndim)]
    return pl, gathered


def _grad_layout(mesh, axis: str, bdims: list, stacked: bool) -> list:
    """A weight leaf's gradient placements: its own shard of the branch
    dim on the placement axis (stacked) or a pending sum there; pending
    sums over the batch dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    xj = list(mesh.mesh_dim_names).index(axis)
    return [(Shard(0) if stacked else Partial()) if j == xj else
            (Partial() if j in bdims else Replicate())
            for j in range(mesh.ndim)]


def _all_gather_rows(t, group, n: int):
    import torch.distributed as dist

    t = t.contiguous()
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out


class _Placed(torch.autograd.Function):
    """This rank's branch between the placement axis's collectives (the
    module docstring). `spec` holds the branch, the join and the rows."""

    @staticmethod
    def forward(ctx, spec, x, *ws):
        import torch.distributed as dist

        ctx.spec = spec
        xf = (_all_gather_rows(x, spec["group"], spec["n"])
              if spec["gathered"] else x)
        ctx.save_for_backward(xf, *ws)
        lo, hi = spec["rows"](xf.shape[0])
        y = spec["fn"](xf[lo:hi], list(ws))
        join = spec["join"]
        if join == "concat":
            parts = _all_gather_rows(y[None], spec["group"], spec["n"])
            out = torch.cat(list(parts), dim=-1)
        else:
            if join == "grouped":
                buf = y.new_zeros((xf.shape[0],) + tuple(y.shape[1:-1])
                                  + (spec["d_join"],))
                off = spec["feat_off"]
                buf[lo:hi, ..., off:off + y.shape[-1]] = y
                y = buf
            out = y.contiguous()
            dist.all_reduce(out, group=spec["group"])
        if spec["gathered"]:
            i, m = spec["index"], x.shape[0]
            out = out[i * m:(i + 1) * m].contiguous()
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        spec = ctx.spec
        xf, *ws = ctx.saved_tensors
        if spec["gathered"]:
            g = _all_gather_rows(g, spec["group"], spec["n"])
        lo, hi = spec["rows"](xf.shape[0])
        if spec["join"] == "concat":
            d = g.shape[-1] // spec["n_branches"]
            dy = g[..., spec["branch"] * d:(spec["branch"] + 1) * d]
        elif spec["join"] == "grouped":
            off, dout = spec["feat_off"], spec["out_dim"]
            dy = g[lo:hi, ..., off:off + dout]
        else:
            dy = g
        with torch.enable_grad():
            xr = xf[lo:hi].detach().requires_grad_()
            wr = [w.detach().requires_grad_() for w in ws]
            y = spec["fn"](xr, wr)
            grads = torch.autograd.grad(y, [xr] + wr, dy.contiguous(),
                                        allow_unused=True)
        dx = torch.zeros_like(xf)
        dx[lo:hi] = grads[0]
        if spec["gathered"]:
            out = torch.empty((xf.shape[0] // spec["n"],) + tuple(xf.shape[1:]),
                              dtype=dx.dtype, device=dx.device)
            dist.reduce_scatter_tensor(out, dx, group=spec["group"])
            dx = out
        else:
            dist.all_reduce(dx, group=spec["group"])
        dws = [torch.zeros_like(w) if gw is None else gw
               for w, gw in zip(ws, grads[1:])]
        return (None, dx, *dws)


def _check(mesh, axis: str, join: str) -> None:
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r} (axes: "
                         f"{_mesh_axes(mesh) if mesh is not None else {}})")
    if join not in ("add", "concat"):
        raise ValueError(f"unsupported join {join!r}")


def _run(mesh, axis, x, leaves, grad_pl, spec, bdims):
    """x and the weight leaves to local blocks, `_Placed`, and the output
    back as a DTensor in x's body layout."""
    from torch.distributed.tensor import DTensor

    from flexflow_tpu_torch.runtime.distributed import (axis_group,
                                                        axis_index,
                                                        axis_size)

    x = _as_dtensor(x, mesh)
    pl, gathered = _x_layout(x, mesh, axis, bdims)
    xl = x.redistribute(mesh, pl).to_local()
    wl = [w.to_local(grad_placements=grad_pl) for w in leaves]
    spec.update(group=axis_group(mesh, axis), n=axis_size(mesh, axis),
                index=axis_index(mesh, axis), gathered=gathered)
    out = _Placed.apply(spec, xl, *wl)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def _replicated_leaves(branch_weights, mesh):
    """The weights' leaves as Replicate DTensors, and the unflatten."""
    from torch.distributed.tensor import Replicate

    leaves, tree = pytree.tree_flatten(list(branch_weights))
    leaves = [_as_dtensor(w, mesh).redistribute(
        mesh, [Replicate()] * mesh.ndim) for w in leaves]
    return leaves, tree


def place_branches(mesh, axis: str, branch_fns: List[Callable], x,
                   branch_weights: Sequence, join: str,
                   batch_axes: Optional[Sequence[str]] = None):
    """Run branch i of `branch_fns` on index i of mesh axis `axis` only:
    branch_fns[i](x_local, branch_weights[i] as local tensors) -> y_local,
    all of one shape; `join` "add" sums them, "concat" concatenates them
    on the last dim. x and the weights are DTensors or tensors every rank
    holds; returns a DTensor."""
    k = len(branch_fns)
    _check(mesh, axis, join)
    n = _mesh_axes(mesh)[axis]
    if n != k:
        raise ValueError(
            f"inter-op placement needs axis size == n_branches "
            f"({axis}={n} vs {k} branches)")
    from flexflow_tpu_torch.runtime.distributed import axis_index

    bi = axis_index(mesh, axis)
    bdims = _batch_dims(mesh, axis, x.shape[0], batch_axes)
    leaves, tree = _replicated_leaves(branch_weights, mesh)
    gpl = _grad_layout(mesh, axis, bdims, stacked=False)

    def fn(xv, wl):
        return branch_fns[bi](xv, pytree.tree_unflatten(wl, tree)[bi])

    spec = dict(fn=fn, join=join, branch=bi, n_branches=k,
                rows=lambda m: (0, m))
    return _run(mesh, axis, x, leaves, gpl, spec, bdims)


def place_branches_stacked(mesh, axis: str, branch_fns: List[Callable], x,
                           stacked_weights, join: str,
                           batch_axes: Optional[Sequence[str]] = None):
    """The owned-weight variant: `stacked_weights` is a pytree of (k, ...)
    leaves, leaf [i] branch i's, sharded over the placement axis so each
    rank stores only its branch's slice. branch_fns[i](x_local, the local
    slice's tree)."""
    from torch.distributed.tensor import Replicate, Shard

    k = len(branch_fns)
    _check(mesh, axis, join)
    n = _mesh_axes(mesh)[axis]
    if n != k:
        raise ValueError(
            f"inter-op placement needs axis size == n_branches "
            f"({axis}={n} vs {k} branches)")
    from flexflow_tpu_torch.runtime.distributed import axis_index

    bi = axis_index(mesh, axis)
    xj = list(mesh.mesh_dim_names).index(axis)
    bdims = _batch_dims(mesh, axis, x.shape[0], batch_axes)
    leaves, tree = pytree.tree_flatten(stacked_weights)
    wpl = [Shard(0) if j == xj else Replicate() for j in range(mesh.ndim)]
    leaves = [_as_dtensor(w, mesh).redistribute(mesh, wpl) for w in leaves]
    gpl = _grad_layout(mesh, axis, bdims, stacked=True)

    def fn(xv, wl):
        return branch_fns[bi](xv, pytree.tree_unflatten([w[0] for w in wl],
                                                        tree))

    spec = dict(fn=fn, join=join, branch=bi, n_branches=k,
                rows=lambda m: (0, m))
    return _run(mesh, axis, x, leaves, gpl, spec, bdims)


def divide_workers(costs: Sequence[float], n: int) -> List[int]:
    """Optimal division of n workers among branches for the makespan
    max_b(costs[b] / g[b]): one worker each, then each next worker to the
    branch with the largest per-worker cost (JAX's waterfill; the search
    uses the divisor-constrained `search/candidates._best_groups`)."""
    k = len(costs)
    if n < k:
        raise ValueError(f"need at least one worker per branch ({n} < {k})")
    g = [1] * k
    for _ in range(n - k):
        b = max(range(k), key=lambda i: costs[i] / g[i])
        g[b] += 1
    return g


def place_branches_grouped(mesh, axis: str, branch_fns: List[Callable], x,
                           branch_weights: Sequence, join: str,
                           group_sizes: Sequence[int],
                           out_dims: Sequence[int], out_ndim: int,
                           batch_axes: Optional[Sequence[str]] = None):
    """Unequal division: branch b owns a contiguous group of
    `group_sizes[b]` indices of the axis (their sum its size), and the
    ranks of a group split its batch rows g_b ways. Each rank writes its
    rows of its branch into a zero-padded block of the joined output (the
    branch's feature offset, its rows' offset), and one all-reduce over
    the axis assembles them. Weights replicated. `out_dims[b]` is branch
    b's last-dim width (all equal for "add")."""
    k = len(branch_fns)
    _check(mesh, axis, join)
    n = _mesh_axes(mesh)[axis]
    if sum(group_sizes) != n:
        raise ValueError(f"group sizes {list(group_sizes)} sum to "
                         f"{sum(group_sizes)} but axis {axis} has size {n}")
    from flexflow_tpu_torch.runtime.distributed import axis_index

    starts = [sum(group_sizes[:b]) for b in range(k)]
    c = axis_index(mesh, axis)
    b = max(j for j in range(k) if c >= starts[j])
    row = c - starts[b]
    bdims = _batch_dims(mesh, axis, x.shape[0], batch_axes)
    b_local = x.shape[0]
    for j in bdims:
        b_local //= mesh.size(j)
    for g in group_sizes:
        if b_local % g:
            raise ValueError(
                f"per-device batch {b_local} not divisible by group size {g} "
                f"(groups {list(group_sizes)})")
    d_join = out_dims[0] if join == "add" else sum(out_dims)
    feat_off = 0 if join == "add" else sum(out_dims[:b])
    leaves, tree = _replicated_leaves(branch_weights, mesh)
    gpl = _grad_layout(mesh, axis, bdims, stacked=False)

    def fn(xv, wl):
        return branch_fns[b](xv, pytree.tree_unflatten(wl, tree)[b])

    def rows(m):
        per = m // group_sizes[b]
        return row * per, (row + 1) * per

    spec = dict(fn=fn, join="grouped", branch=b, n_branches=k, rows=rows,
                d_join=d_join, feat_off=feat_off, out_dim=out_dims[b])
    return _run(mesh, axis, x, leaves, gpl, spec, bdims)
