"""Per-op sharding candidates (counterpart: flexflow_tpu/search/candidates.py).

Each op family enumerates Candidate layouts over the mesh axes; the DP
(search/dp.py) picks one per op, and reshard costs at the edges price the
implied parallel ops (reference: `generate_all_pcg_xfers`,
src/runtime/substitution.cc:1726-1868, and `register_all_machine_views`,
src/runtime/graph.cc:2329-2360).

Axis convention: the axis named "data" (with "node" across nodes) is the
batch axis, always used for batch-dim sharding when divisible (pure data
parallelism is the always-present baseline candidate). The other axes
("model", ...) are enumerated for tensor/attribute parallelism, gated by
enable_parameter_parallel / enable_attribute_parallel.

Expert parallelism shards the MoE ops over a mesh axis (`ep:{axis}`);
a fork-join composite gets `inter:{axis}` (branch i on axis index i) and
grouped `inter:{axis}:{g0}-{g1}-...` (an unequal division of the axis,
`_best_groups`) beside `dp`. The port executes either replicated on its
one device; the candidates price the searched machine.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer

from flexflow_tpu_torch.ops.op_type import (
    BINARY_OPS,
    OperatorType,
    PARALLEL_OPS,
    UNARY_OPS,
)
from flexflow_tpu_torch.ops.registry import get_op_def
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.parallel.sharding import DimSharding
from flexflow_tpu_torch.search import cost_model as cm
from flexflow_tpu_torch.search import memo


@dataclasses.dataclass
class Candidate:
    """One way to place an op: wanted input layouts, produced output/weight
    layouts, and the cost terms that don't live on graph edges."""

    name: str
    in_dims: List[List[DimSharding]]
    out_dims: List[List[DimSharding]]
    weight_dims: Dict[str, List[DimSharding]]
    compute_degree: int = 1
    extra_comm: float = 0.0  # collectives inherent to this placement (s)
    # GEMM-width efficiency: a shard narrower than machine.mxu_min_dim
    # leaves the tensor cores part idle
    eff: float = 1.0
    # fraction of the (per-device) weight bytes actually STREAMED from HBM
    # each step: < 1 when a device touches only part of the resident weights
    weight_stream_frac: float = 1.0
    # passthrough: identity layout op — adopts whatever layout arrives (minus
    # drop_axis) with zero cost. Used by engine-inserted Replicate/Reduction
    # marker nodes so they never force a gather of the batch sharding.
    passthrough: bool = False
    drop_axis: Optional[str] = None
    # forward-only share of extra_comm (s): extra_comm prices the training
    # step (fwd+bwd); serving cost fns run forward-only programs, so ring
    # rotation and flash-infeasibility penalties must not charge the bwd
    # passes there. None = no fwd/bwd split known; use extra_comm.
    extra_comm_fwd: Optional[float] = None

    def memo_key(self) -> tuple:
        """Hashable identity of this placement (tier-2 interning)."""
        return (self.name,
                tuple(memo.freeze_dims(d) for d in self.in_dims),
                tuple(memo.freeze_dims(d) for d in self.out_dims),
                tuple(sorted((w, memo.freeze_dims(d))
                             for w, d in self.weight_dims.items())),
                self.compute_degree, self.extra_comm, self.eff,
                self.weight_stream_frac, self.passthrough, self.drop_axis,
                self.extra_comm_fwd)

    def op_time(self, layer: "Layer", machine: MachineSpec) -> float:
        # interned by (op params key, placement, machine): structural twins
        # (GPT-2 blocks) and repeated DP frontier states share one
        # evaluation. fork_join costs read layer.branches (not in
        # params_key), so composites always take the direct path.
        if memo.enabled() and not layer.branches:
            key = (layer.params_key(),
                   memo.freeze_weight_specs(layer.weight_specs),
                   self.memo_key(), memo.machine_fingerprint(machine))
            t = memo.get("op_time", key)
            if t is not memo.MISS:
                return t
            return memo.put("op_time", key, self._op_time(layer, machine))
        return self._op_time(layer, machine)

    def flops_bytes(self, layer: "Layer", machine: MachineSpec):
        """(total fwd flops, per-device HBM bytes, effective degree) of this
        placement — the roofline inputs of _op_time: activations divide by
        the compute degree, weights stream per replica (each device reads
        its own shard, scaled by weight_stream_frac)."""
        od = get_op_def(layer.op_type)
        act_bytes = (sum(i.spec.size_bytes for i in layer.inputs)
                     + sum(o.spec.size_bytes for o in layer.outputs))
        w_bytes = self.weight_stream_frac * sum(
            cm.shard_bytes(s, self.weight_dims.get(w, []), machine)
            for w, s in layer.weight_specs.items())
        deg = max(1.0, self.compute_degree * self.eff)
        return od.flop_count(layer), act_bytes / deg + w_bytes, deg

    def _op_time(self, layer: "Layer", machine: MachineSpec) -> float:
        flops, hbm, deg = self.flops_bytes(layer, machine)
        t = cm.compute_time(flops, hbm, machine, deg, bytes_predivided=True)
        t += self.extra_comm
        t += cm.grad_sync_time(layer.weight_specs, self.weight_dims, machine,
                               _batch_axes(machine))
        return t

    def weight_mem_bytes(self, layer: "Layer", machine: MachineSpec,
                         opt_mem: "Optional[cm.OptMemSpec]" = None) -> int:
        # per-device, persistent weight state; activation memory is tracked
        # as a live set by the DP (search/dp.py). Legacy accounting
        # (opt_mem=None — direct search_graph callers): weights x4 (param,
        # grad, 2 f32 moments). With an OptMemSpec: param + grad at the
        # weight dtype, plus the optimizer's ACTUAL moments — counted and
        # sized by its state_dtype (bf16 Adam moments were previously
        # charged as f32) and divided by the ZeRO data-axis degree where
        # the runtime shards them (cost_model.zero_divisor mirrors the
        # compile-side placement rule).
        m = 0
        for w, spec in layer.weight_specs.items():
            dims = self.weight_dims.get(w, [])
            sb = cm.shard_bytes(spec, dims, machine)
            if opt_mem is None:
                m += 4 * sb
                continue
            shard_elems = sb // max(1, spec.dtype.itemsize)
            moment_bytes = opt_mem.moments * shard_elems * opt_mem.state_itemsize
            m += 2 * sb + moment_bytes // cm.zero_divisor(
                spec, dims, machine, opt_mem.zero_axes)
        return m


def compiled_candidate(layer: "Layer", strategy, machine: MachineSpec,
                       batch_sizes) -> "Candidate":
    """The sharding candidate matching the COMPILED strategy's weight
    layout + attrs for this layer (falls back to dp when nothing matches):
    what CompiledModel prices for predicted_step_time and memory_stats."""
    cands = layer_candidates(layer, machine, batch_sizes)
    sh = strategy.op_shardings.get(layer.name)

    def norm(dims):
        return [None if d in (None, []) else
                (d if isinstance(d, str) else tuple(d))
                for d in (dims or [])]

    if sh is not None:
        want_w = {w: norm(d) for w, d in sh.weights.items()}
        want_attrs = dict(sh.attrs or {})
        # attrs disambiguate candidates with identical weight layouts
        # (a grouped inter: placement keeps weights replicated like dp);
        # fall back to the first layout-only match in the same scan
        layout_match = None
        for c in cands:
            if c.passthrough or \
                    {w: norm(d) for w, d in c.weight_dims.items()} != want_w:
                continue
            if candidate_attrs(c) == want_attrs:
                return c
            layout_match = layout_match or c
        if layout_match is not None:
            return layout_match
    return cands[0]


def candidate_attrs(cand: "Candidate") -> Dict[str, str]:
    """Strategy attrs a chosen candidate implies: inter:{axis} -> fork_join
    branch placement; sp_ring:{axis} -> ring-attention sequence
    parallelism (carried in the strategy; one device applies neither)."""
    if cand.name.startswith("inter:"):
        parts = cand.name.split(":")
        attrs = {"placement": parts[1]}
        if len(parts) > 2:  # unequal groups: "inter:model:3-1"
            attrs["placement_groups"] = parts[2]
        return attrs
    if cand.name.startswith("sp_ring:"):
        return {"seq_parallel": cand.name.split(":", 1)[1]}
    return {}


def _batch_axes(machine: MachineSpec) -> List[str]:
    """Axes the batch dim rides: "data" plus the multi-node sample axis
    ("node", --nodes in compile.py) when present — nodes split samples,
    they don't replicate them."""
    axes = [a for a in ("node", "data") if a in machine.mesh_axes]
    if axes:
        return axes
    return [next(iter(machine.mesh_axes))] if machine.mesh_axes else []


def _model_axes(machine: MachineSpec) -> List[str]:
    b = set(_batch_axes(machine))
    return [a for a in machine.mesh_axes if a not in b and machine.mesh_axes[a] > 1]


def _dp_dims(shape, machine: MachineSpec, batch_sizes) -> List[DimSharding]:
    dims: List[DimSharding] = [None] * len(shape)
    if not shape or shape[0] not in batch_sizes:
        return dims
    axes = _batch_axes(machine)
    deg = 1
    for a in axes:
        deg *= machine.mesh_axes[a]
    if len(axes) > 1 and shape[0] % deg == 0:
        dims[0] = tuple(axes)  # batch over node AND data
        return dims
    for ax in axes:
        if shape[0] % machine.mesh_axes[ax] == 0:
            dims[0] = ax
            break
    return dims


def _ddeg(dims, machine):
    return cm.dims_degree(dims, machine)


def _best_groups(costs, n: int, b_local: int):
    """Best division of n axis indices among len(costs) branches
    minimizing max_b(costs[b] / g_b), each g_b dividing the per-device
    batch. Exhaustive over divisor-valued compositions (k is small, n at
    most the axis size). Returns (makespan_rel, group_sizes) or None."""
    k = len(costs)
    divs = [d for d in range(1, n + 1) if b_local % d == 0]
    if n < k or not divs:
        return None
    best = None

    def rec(i, left, acc):
        nonlocal best
        if i == k - 1:
            if left in divs:
                g = acc + [left]
                mk = max(c / gi for c, gi in zip(costs, g))
                if best is None or mk < best[0]:
                    best = (mk, g)
            return
        for d in divs:
            if d <= left - (k - 1 - i):
                rec(i + 1, left - d, acc + [d])

    rec(0, n, [])
    return best


def layer_candidates(layer: "Layer", machine: MachineSpec, batch_sizes,
                     enable_parameter: bool = True,
                     enable_attribute: bool = True) -> List[Candidate]:
    """Candidate placements for one layer — interned by (op params key,
    machine, knobs) so the substitution loop's repeated DP runs and
    structural twins enumerate each op family once (search/memo.py, tier 2).
    Candidates are immutable after construction; callers get a fresh list
    over the shared objects. fork_join composites key on layer.branches
    (absent from params_key), so they always rebuild."""
    if memo.enabled() and layer.op_type is not OperatorType.FORK_JOIN:
        key = (layer.params_key(),
               memo.freeze_weight_specs(layer.weight_specs),
               frozenset(batch_sizes), enable_parameter, enable_attribute,
               memo.machine_fingerprint(machine))
        cands = memo.get("candidates", key)
        if cands is memo.MISS:
            cands = memo.put("candidates", key, _layer_candidates(
                layer, machine, batch_sizes, enable_parameter,
                enable_attribute))
        return list(cands)
    return _layer_candidates(layer, machine, batch_sizes, enable_parameter,
                             enable_attribute)


def _layer_candidates(layer: "Layer", machine: MachineSpec, batch_sizes,
                      enable_parameter: bool = True,
                      enable_attribute: bool = True) -> List[Candidate]:
    t = layer.op_type
    ispecs = [x.spec for x in layer.inputs]
    ospecs = [o.spec for o in layer.outputs]
    dp_in = [_dp_dims(s.shape, machine, batch_sizes) for s in ispecs]
    dp_out = [_dp_dims(s.shape, machine, batch_sizes) for s in ospecs]
    repl_w = {w: [None] * s.ndim for w, s in layer.weight_specs.items()}
    dp = Candidate("dp", dp_in, dp_out, dict(repl_w),
                   compute_degree=max(_ddeg(dp_out[0], machine) if dp_out else 1, 1))
    cands = [dp]
    maxes = _model_axes(machine) if enable_parameter else []

    if t is OperatorType.LINEAR:
        x, o = ispecs[0], ospecs[0]
        for m in maxes:
            dm = machine.mesh_axes[m]
            base = max(1, dp.compute_degree)
            if o.shape[-1] % dm == 0:
                od = [list(dp_out[0][:-1]) + [m]]
                cands.append(Candidate(
                    f"tp_col:{m}", dp_in, od,
                    {"kernel": [None, m], **({"bias": [m]} if "bias" in repl_w else {})},
                    compute_degree=base * dm,
                    eff=min(1.0, (o.shape[-1] // dm) / machine.mxu_min_dim)))
            if x.shape[-1] % dm == 0:
                ind = [list(dp_in[0][:-1]) + [m]]
                out_bytes = cm.shard_bytes(o, dp_out[0], machine)
                cands.append(Candidate(
                    f"tp_row:{m}", ind, dp_out,
                    {"kernel": [m, None], **({"bias": [None]} if "bias" in repl_w else {})},
                    compute_degree=base * dm,
                    extra_comm=cm.all_reduce_time(out_bytes, (m,), machine),
                    eff=min(1.0, (x.shape[-1] // dm) / machine.mxu_min_dim)))

    elif t is OperatorType.MULTIHEAD_ATTENTION:
        heads = layer.params["num_heads"]
        for m in maxes:
            dm = machine.mesh_axes[m]
            if heads % dm:
                continue
            wd = {w: [None, m] for w in ("wq", "wk", "wv")}
            wd["wo"] = [m, None]
            for b in ("bq", "bk", "bv"):
                if b in repl_w:
                    wd[b] = [m]
            if "bo" in repl_w:
                wd["bo"] = [None]
            out_bytes = cm.shard_bytes(ospecs[0], dp_out[0], machine)
            embed = layer.params["embed_dim"]
            cands.append(Candidate(
                f"tp_heads:{m}", dp_in, dp_out, wd,
                compute_degree=max(1, dp.compute_degree) * dm,
                extra_comm=cm.all_reduce_time(out_bytes, (m,), machine),
                eff=min(1.0, (embed // dm) / machine.mxu_min_dim)))
        # sequence parallelism: ring attention over a mesh axis (the JAX
        # package's kernels/ring_attention.py; its lowering comes with the
        # multi-GPU slice). q/k/v/out sharded on the seq dim; k/v shards
        # rotate (P-1) hops around the ring. Scope:
        # self-attention shapes (sq == sk; the ring's causal offsets assume
        # one chunk length) and no forced impl="xla".
        q, kspec = ispecs[0], ispecs[1]
        seq, seq_k = q.shape[1], kspec.shape[1]
        head_d = layer.params["embed_dim"] // max(1, heads)
        if not layer.params.get("add_bias_kv") and \
                not layer.params.get("add_zero_attn") and \
                not layer.params.get("dropout") and \
                layer.params.get("impl", "auto") != "xla" and \
                seq == seq_k == ispecs[2].shape[1]:
            for m in maxes:
                dm = machine.mesh_axes[m]
                if seq % dm:
                    continue
                sdims = [[dp_in[0][0], m, None]] * 3
                sout = [[dp_out[0][0], m, None]]
                kv_chunk = cm.shard_bytes(kspec, sdims[1], machine)
                # fwd: k+v rotate (dm-1) times; bwd (custom VJP second ring
                # pass): k, v, dk, dv rotate dm times each
                ring_fwd = 2.0 * (dm - 1) * kv_chunk / machine.axis_bw(m)
                ring_comm = (ring_fwd
                             + 4.0 * dm * kv_chunk / machine.axis_bw(m))
                cands.append(Candidate(
                    f"sp_ring:{m}", sdims, sout, dict(repl_w),
                    compute_degree=max(1, dp.compute_degree) * dm,
                    extra_comm=ring_comm, extra_comm_fwd=ring_fwd))
        # where the flash kernels can't cover the shape, non-ring
        # candidates pay the full (sq, sk) logits materialization through
        # HBM (3x for fwd+bwd). The gate is this package's CUDA kernels'
        # (kernels/flash_attention.py), which has no cap on seq, unlike the
        # JAX package's VMEM budget; dropout is priced by shape alone, as
        # in JAX, though both lowerings leave flash under dropout > 0.
        from flexflow_tpu_torch.kernels.flash_attention import \
            flash_supported

        isz = q.dtype.itemsize
        flash_ok = flash_supported(
            seq, seq_k, head_d, q.dtype.torch_dtype,
            causal=bool(layer.params.get("causal")),
            batch_heads=q.shape[0] * heads)
        if not flash_ok:
            logits_bytes = q.shape[0] * heads * seq * seq_k * max(4, isz)
            for c in cands:
                if not c.name.startswith("sp_ring:"):
                    pen_fwd = (1.0 * 2.0 * logits_bytes
                               / max(1, c.compute_degree) / machine.hbm_bw)
                    c.extra_comm_fwd = (c.extra_comm if c.extra_comm_fwd
                                        is None else c.extra_comm_fwd) + pen_fwd
                    c.extra_comm += 3.0 * pen_fwd

    elif t is OperatorType.EMBEDDING:
        tbl = layer.weight_specs["kernel"]
        for m in maxes:
            dm = machine.mesh_axes[m]
            if tbl.shape[0] % dm == 0:
                out_bytes = cm.shard_bytes(ospecs[0], dp_out[0], machine)
                cands.append(Candidate(
                    f"row:{m}", dp_in, dp_out, {"kernel": [m, None]},
                    compute_degree=max(1, dp.compute_degree) * dm,
                    extra_comm=cm.all_reduce_time(out_bytes, (m,), machine)))
            if tbl.shape[1] % dm == 0 and ospecs[0].shape[-1] % dm == 0:
                od = [list(dp_out[0][:-1]) + [m]]
                cands.append(Candidate(
                    f"col:{m}", dp_in, od, {"kernel": [None, m]},
                    compute_degree=max(1, dp.compute_degree) * dm,
                    eff=min(1.0, (tbl.shape[1] // dm) / machine.mxu_min_dim)))

    elif t is OperatorType.EXPERTS:
        e = ispecs[0].shape[0]
        for m in maxes:
            dm = machine.mesh_axes[m]
            if e % dm:
                continue
            ind = [[m, None, None]]
            od = [[m, None, None]]
            wd = {"kernel": [m, None, None]}
            if "bias" in repl_w:
                wd["bias"] = [m, None]
            cands.append(Candidate(f"ep:{m}", ind, od, wd, compute_degree=dm))

    elif t is OperatorType.GROUP_BY:
        e = ospecs[0].shape[0]
        for m in maxes:
            dm = machine.mesh_axes[m]
            if e % dm:
                continue
            od = [[m, None, None], dp_out[1]]
            cands.append(Candidate(
                f"ep:{m}", dp_in, od, {}, compute_degree=1,
                extra_comm=cm.all_to_all_time(
                    cm.shard_bytes(ospecs[0], [m, None, None], machine),
                    (m,), machine)))

    elif t is OperatorType.CONV2D and enable_attribute:
        x, o = ispecs[0], ospecs[0]
        for m in maxes:
            dm = machine.mesh_axes[m]
            # attribute parallel on H (reference P3); halo = (kernel_h-1) rows
            if o.shape[2] % dm == 0 and x.shape[2] % dm == 0:
                ind = [[dp_in[0][0], None, m, None]]
                od = [[dp_out[0][0], None, m, None]]
                batch_shard = x.shape[0] // max(1, _ddeg([dp_in[0][0]], machine))
                halo_bytes = (layer.params["kernel_h"] - 1) * batch_shard \
                    * x.shape[1] * x.shape[3] * x.dtype.itemsize
                cands.append(Candidate(
                    f"attr_h:{m}", ind, od, dict(repl_w),
                    compute_degree=max(1, dp.compute_degree) * dm,
                    extra_comm=halo_bytes / machine.axis_bw(m)))
            # output-channel TP
            if o.shape[1] % dm == 0:
                od = [[dp_out[0][0], m, None, None]]
                wd = {"kernel": [m, None, None, None]}
                if "bias" in repl_w:
                    wd["bias"] = [m]
                cands.append(Candidate(
                    f"tp_oc:{m}", dp_in, od, wd,
                    compute_degree=max(1, dp.compute_degree) * dm))

    elif t is OperatorType.FORK_JOIN:
        # inter-op placement: branch i on mesh-axis index i; compute
        # divides by the axis size (balanced branches run at once on
        # disjoint devices) and the join's collective (all-reduce for
        # add, all-gather for concat) is the price; dp runs every branch
        # on every device
        k = layer.params["n_branches"]
        join = layer.params["join"]
        from flexflow_tpu_torch.ops.fork_join import (branch_flops,
                                                      branch_weight_bytes,
                                                      congruent_branches,
                                                      grouped_placeable,
                                                      inter_placeable)

        stacked = congruent_branches(layer)
        b_local = (ispecs[0].shape[0] // max(1, _ddeg([dp_in[0][0]], machine))
                   if ispecs and ispecs[0].ndim else 1)
        # only where the batch shards over the batch axes: a replicated
        # batch cannot run the placed branches (JAX's crash gate)
        batch_shards = (not ispecs or not ispecs[0].ndim
                        or dp_in[0][0] is not None)
        for m in (maxes if batch_shards else ()):
            n = machine.mesh_axes[m]
            out_bytes = cm.shard_bytes(ospecs[0], dp_out[0], machine)
            if n == k and inter_placeable(layer):
                comm = (cm.all_reduce_time(out_bytes, (m,), machine)
                        if join == "add"
                        else cm.all_gather_time(out_bytes, (m,), machine))
                if stacked:
                    # stacked (k, ...) weights sharded over the placement
                    # axis: memory, streaming and the grad all-reduce all
                    # divide by k
                    wd = {w: [m] for w in layer.weight_specs}
                    frac = 1.0
                else:
                    # heterogeneous branches: replicated, each device
                    # streams only its branch's share
                    wd = dict(repl_w)
                    frac = 1.0 / k
                cands.append(Candidate(
                    f"inter:{m}", dp_in, dp_out, wd,
                    compute_degree=max(1, dp.compute_degree) * k,
                    extra_comm=comm,
                    weight_stream_frac=frac))
            elif n > k and grouped_placeable(layer):
                # unequal division: branch b owns g_b axis indices and
                # batch-shards g_b ways inside its group; weights replicate
                costs = [max(f, 1.0) for f in branch_flops(layer)]
                best = _best_groups(costs, n, b_local)
                if best is None:
                    continue
                makespan_rel, gsz = best
                speedup = sum(costs) / max(makespan_rel, 1e-30)
                wb = branch_weight_bytes(layer)
                frac = (max(wb) / sum(wb)) if sum(wb) else 1.0
                # one all-reduce of the joined output over the axis
                comm = cm.all_reduce_time(out_bytes, (m,), machine)
                cands.append(Candidate(
                    f"inter:{m}:{'-'.join(map(str, gsz))}",
                    dp_in, dp_out, dict(repl_w),
                    compute_degree=max(1, dp.compute_degree) * speedup,
                    extra_comm=comm,
                    weight_stream_frac=frac))

    elif t in UNARY_OPS or t in (OperatorType.DROPOUT, OperatorType.CAST,
                                 OperatorType.SOFTMAX, OperatorType.LOG_SOFTMAX):
        # propagate a feature-dim shard so TP chains stay sharded
        x = ispecs[0]
        for m in maxes:
            dm = machine.mesh_axes[m]
            if x.ndim >= 2 and x.shape[-1] % dm == 0 and t not in (
                    OperatorType.SOFTMAX, OperatorType.LOG_SOFTMAX):
                d = [list(dp_in[0][:-1]) + [m]]
                cands.append(Candidate(f"follow:{m}", d, d, {},
                                       compute_degree=max(1, dp.compute_degree) * dm,
                                       eff=min(1.0, (x.shape[-1] // dm) / machine.mxu_min_dim)))

    elif t in BINARY_OPS:
        x = ospecs[0]
        for m in maxes:
            dm = machine.mesh_axes[m]
            if x.ndim >= 2 and x.shape[-1] % dm == 0:
                d = [list(dp_out[0][:-1]) + [m]]
                cands.append(Candidate(f"follow:{m}", [d[0], d[0]], d, {},
                                       compute_degree=max(1, dp.compute_degree) * dm,
                                       eff=min(1.0, (x.shape[-1] // dm) / machine.mxu_min_dim)))

    elif t in PARALLEL_OPS:
        from flexflow_tpu_torch.ops.parallel_ops import requested_dims

        # Reduction (and engine-inserted axis-scoped Replicate) are layout
        # markers: they adopt the incoming layout (Replicate guarantees the
        # named axis is unused, i.e. replicated-over). The DP handles these
        # as passthrough so they never gather the batch sharding.
        if t is OperatorType.REDUCTION or (
                t is OperatorType.REPLICATE and "axis" in layer.params):
            return [Candidate("passthrough", [], [], {}, passthrough=True,
                              drop_axis=layer.params.get("axis"))]
        # other parallel ops: the requested layout IS the candidate; pricing
        # happens at the incoming edge (reshard incoming→requested), the op
        # itself is free — so in_dims = out_dims = requested.
        dims = requested_dims(layer)
        return [Candidate("requested", [list(dims)], [list(dims)], {},
                          compute_degree=1)]

    return cands
