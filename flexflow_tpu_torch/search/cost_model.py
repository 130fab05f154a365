"""Analytic cost model (counterpart: flexflow_tpu/search/cost_model.py).

Closed-form, as in the JAX package; the machine's numbers
(parallel/machine.py) are a GPU's:

  compute time  = max(flops / tensor-core rate, HBM bytes / HBM bw)  (roofline)
  all_gather    = (k-1)/k * full_bytes / axis_bw
  all_reduce    = 2 * (k-1)/k * bytes / axis_bw     (reduce-scatter + all-gather)
  all_to_all    = (k-1)/k * shard_bytes / axis_bw
  axes that cross nodes use dcn_bw instead of the NVLink rate.

Per-op measured costs (search/measure.py) replace the roofline term when
the search runs with `measured=True` or `profiling`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.parallel.sharding import DimSharding
from flexflow_tpu_torch.search import memo


@dataclasses.dataclass(frozen=True)
class OptMemSpec:
    """What the optimizer REALLY costs per parameter — the search's memory
    model for persistent weight state (params + grads + moments). The
    legacy accounting (opt_mem=None throughout the search) charged every
    weight 4x its own bytes: param + grad + two f32 moments. This spec
    replaces that with the optimizer's actual shape: `moments` moment
    tensors stored at `state_itemsize` bytes/elem (bf16 Adam moments are 2,
    not 4), divided by the ZeRO data-axis degree when `zero_axes` is set
    (zero_divisor mirrors compiler/compile.py `_zero_moment_dims`, the
    JAX package's placement rule)."""

    moments: int = 2
    state_itemsize: int = 4
    zero_axes: Tuple[str, ...] = ()

    def fingerprint(self) -> tuple:
        return (self.moments, self.state_itemsize, self.zero_axes)


def opt_mem_spec(optimizer, cfg, machine: MachineSpec) -> Optional[OptMemSpec]:
    """Build the search's optimizer-memory model from the compile-time
    optimizer + config. None (no optimizer known) keeps the legacy 4x
    accounting so direct search_graph callers are unaffected."""
    if optimizer is None:
        return None
    zero_axes: Tuple[str, ...] = ()
    if getattr(cfg, "zero_sharding", "off") != "off":
        from flexflow_tpu_torch.search.candidates import _batch_axes

        zero_axes = tuple(a for a in _batch_axes(machine)
                          if machine.mesh_axes.get(a, 1) > 1)
    return OptMemSpec(moments=optimizer.moment_count(),
                      state_itemsize=optimizer.moment_itemsize(),
                      zero_axes=zero_axes)


def zero_divisor(spec: TensorSpec, dims: Sequence[DimSharding],
                 machine: MachineSpec, zero_axes: Sequence[str]) -> int:
    """Degree the ZeRO runtime actually divides this weight's moments by.
    MIRRORS compiler/compile.py _zero_moment_dims: the moments take the
    weight's own layout plus the full data-axis degree on the FIRST
    unsharded dim it divides; a weight with no such dim keeps replicated
    moments (divisor 1), and a weight already sharded over a data axis
    gains nothing."""
    if not zero_axes:
        return 1
    nd = spec.ndim
    dims = list(dims or [])
    dims += [None] * (nd - len(dims))
    used = {a for d in dims for a in _axes_of(d)}
    if used & set(zero_axes):
        return 1
    deg = axis_degree(zero_axes, machine)
    if deg <= 1:
        return 1
    for i in range(nd):
        if not _axes_of(dims[i]) and spec.shape[i] % deg == 0:
            return deg
    return 1


def _axes_of(d: DimSharding) -> tuple:
    if d is None:
        return ()
    return (d,) if isinstance(d, str) else tuple(d)


def dims_degree(dims: Sequence[DimSharding], machine: MachineSpec) -> int:
    deg = 1
    for d in dims or ():
        for a in _axes_of(d):
            deg *= machine.mesh_axes.get(a, 1)
    return deg


def shard_bytes(spec: TensorSpec, dims: Sequence[DimSharding], machine: MachineSpec) -> int:
    return spec.size_bytes // max(1, dims_degree(dims, machine))


def axis_degree(axes, machine: MachineSpec) -> int:
    deg = 1
    for a in axes:
        deg *= machine.mesh_axes.get(a, 1)
    return deg


def _hier_gather_time(full_bytes: float, axes, machine: MachineSpec) -> float:
    """Hierarchical multi-axis all-gather: one ring stage per axis, each
    sending the accumulated shard (k_i - 1) hops at that axis's effective
    bandwidth (reference NetworkedMachineModel's routed multi-hop cost,
    machine_model.cc — here closed-form per torus axis). Axes are staged
    fastest-first (DCN last), which is both the optimal schedule and a
    CANONICAL order — the cost must not depend on set-iteration order of
    the caller (string hashing is per-process randomized).
    Reduces to (k-1)/k * bytes / bw for a single axis."""
    k_total = axis_degree(axes, machine)
    if k_total <= 1:
        return 0.0
    staged = sorted((a for a in axes if machine.mesh_axes.get(a, 1) > 1),
                    key=lambda a: -machine.axis_bw_eff(a))
    shard = full_bytes / k_total
    t = 0.0
    for a in staged:
        k = machine.mesh_axes[a]
        t += (k - 1) * shard / machine.axis_bw_eff(a)
        shard *= k
    return t


def all_gather_time(full_bytes: float, axes, machine: MachineSpec) -> float:
    return _hier_gather_time(full_bytes, axes, machine)


def reduce_scatter_time(bytes_: float, axes, machine: MachineSpec) -> float:
    # ring reduce-scatter moves the same (k-1)/k * bytes as an all-gather,
    # in the opposite direction
    return _hier_gather_time(bytes_, axes, machine)


def all_reduce_time(bytes_: float, axes, machine: MachineSpec) -> float:
    # reduce-scatter down + all-gather up, each hierarchical
    return reduce_scatter_time(bytes_, axes, machine) \
        + all_gather_time(bytes_, axes, machine)


def all_to_all_time(shard_bytes_: float, axes, machine: MachineSpec) -> float:
    k = axis_degree(axes, machine)
    if k <= 1:
        return 0.0
    bw = min(machine.axis_bw_eff(a) for a in axes if machine.mesh_axes.get(a, 1) > 1)
    return (k - 1) / k * shard_bytes_ / bw


def roofline_split(flops: float, hbm_bytes: float, machine: MachineSpec,
                   degree: float = 1, bytes_predivided: bool = False
                   ) -> Tuple[float, float]:
    """The two legs of the per-chip roofline for 1/degree of one training
    step's work over an op: (t_flop, t_mem). fwd+bwd ≈ 3x fwd flops
    (reference simulator models fwd and bwd tasks separately; the 3x is the
    standard dense-training ratio); HBM traffic ≈ 2x the forward bytes.
    When bytes_predivided, hbm_bytes is already the per-device traffic.
    compute_time takes the max."""
    d = max(1.0, degree)
    eff_flops = machine.flops / machine.mxu_flop_overhead
    t_flop = 3.0 * flops / d / eff_flops
    t_mem = 2.0 * hbm_bytes / (1.0 if bytes_predivided else d) / machine.hbm_bw
    return t_flop, t_mem


def compute_time(flops: float, hbm_bytes: float, machine: MachineSpec,
                 degree: float = 1, bytes_predivided: bool = False) -> float:
    """Roofline on one chip: max of the compute and memory legs (see
    roofline_split)."""
    t_flop, t_mem = roofline_split(flops, hbm_bytes, machine, degree,
                                   bytes_predivided)
    return max(t_flop, t_mem)


def op_roofline(layer, cand, machine: MachineSpec) -> Dict[str, float]:
    """Per-op roofline facts for one (layer, candidate placement): the
    machine-bound minimum time of the op's fwd+bwd work, which leg binds,
    and the MFU ceiling the roofline permits (1.0 when compute-bound at
    peak, < 1 when HBM bandwidth caps it), so measured_mfu / mfu_ceiling
    separates scheduling loss from roofline loss. attribution.py joins it
    with each op's measured time."""
    flops, hbm_bytes, degree = cand.flops_bytes(layer, machine)
    t_flop, t_mem = roofline_split(flops, hbm_bytes, machine, degree,
                                   bytes_predivided=True)
    t = max(t_flop, t_mem)
    # flops/s the roofline bound sustains, over the device's PEAK (not the
    # overhead-derated rate the bound itself uses)
    dev_flops = 3.0 * flops / max(1.0, degree)
    return {
        "flops": flops,
        "device_flops": dev_flops,
        "hbm_bytes": hbm_bytes,
        "degree": degree,
        "roofline_s": t,
        "t_flop_s": t_flop,
        "t_mem_s": t_mem,
        "bound": "bandwidth" if t_mem > t_flop else "compute",
        "mfu_ceiling": (dev_flops / (t * machine.flops)) if t > 0 else 0.0,
    }


def overlapped_step_cost(comp: float, comm: float, machine: MachineSpec) -> float:
    """One layer's contribution under compute/comm overlap (the closed-form
    stand-in for the reference's event-driven concurrent replay,
    simulator.h:785-827): collectives issued on their own stream hide
    behind up to machine.overlap_frac of the consumer's pure compute; only
    the residual serializes. overlap_frac=0 degenerates to additive
    costing. The fraction is not measured on a GPU yet (it needs two)."""
    return comp + max(0.0, comm - machine.overlap_frac * comp)


def reshard_time(spec: TensorSpec, src: Sequence[DimSharding],
                 dst: Sequence[DimSharding], machine: MachineSpec) -> float:
    """Cost of moving a tensor from layout src to dst — the price of a
    parallel op (Repartition/Combine/Replicate/AllToAll) on this machine.

    Interned by (tensor geometry, src, dst, machine) — the DP's edge costs
    are the hottest call in the search and structural twins re-price the
    same transitions constantly (search/memo.py, tier 2)."""
    if memo.enabled():
        key = (spec.ndim, spec.size_bytes, memo.freeze_dims(src),
               memo.freeze_dims(dst), memo.machine_fingerprint(machine))
        t = memo.get("reshard", key)
        if t is not memo.MISS:
            return t
        return memo.put("reshard", key, _reshard_time(spec, src, dst, machine))
    return _reshard_time(spec, src, dst, machine)


def _reshard_time(spec: TensorSpec, src: Sequence[DimSharding],
                  dst: Sequence[DimSharding], machine: MachineSpec) -> float:
    nd = spec.ndim
    src = list(src or [None] * nd) + [None] * (nd - len(src or []))
    dst = list(dst or [None] * nd) + [None] * (nd - len(dst or []))
    if [_axes_of(a) for a in src] == [_axes_of(a) for a in dst]:
        return 0.0
    t = 0.0
    moved_axes = set()
    src_all = {a for d in src for a in _axes_of(d)}
    dst_all = {a for d in dst for a in _axes_of(d)}
    for i in range(nd):
        sa, da = set(_axes_of(src[i])), set(_axes_of(dst[i]))
        # axis moved to a different dim → all_to_all over that axis
        for a in sa - da:
            if a in dst_all:
                t += all_to_all_time(shard_bytes(spec, src, machine), (a,), machine)
                moved_axes.add(a)
    # axes fully removed (not present anywhere in dst) → all_gather
    gone = src_all - dst_all - moved_axes
    if gone:
        t += all_gather_time(spec.size_bytes / max(1, dims_degree(
            [None if set(_axes_of(d)) <= gone else d for d in src], machine)),
            tuple(gone), machine)
    # axes newly added where tensor was replicated → local slice (free)
    return t


# ------------------------------------------------------- pipeline costing
def p2p_time(bytes_: float, machine: MachineSpec, axis: str = "pipe") -> float:
    """One neighbor-hop point-to-point transfer (a stage-boundary
    activation or its gradient crossing the pipe axis, JAX
    `cost_model.py:362-369`): no (k-1)/k factor, the tensor moves once
    over one link. A machine without a "pipe" bandwidth takes its chip's
    link rate: on the H100 preset that is NVLink 4's 450 GB/s one way from
    the data sheet, which has not been measured on NVLink (the port's
    pipeline has run on one card only)."""
    return bytes_ / machine.axis_bw(axis)


def pipeline_schedule(schedule: str, num_stages: int, num_micro: int):
    """Tick grid of a pipeline schedule: a list of ticks, each a list of
    (stage, phase, microbatch) with phase "F" or "B". Ops in one tick run
    concurrently (each stage at most once a tick); F(s,m) follows
    F(s-1,m) and B(s,m) follows F(s,m) and B(s+1,m). Built from
    `pipeline_order`, the one schedule definition the search prices, the
    simulator replays and the executor (parallel/pipeline.py) runs.

      gpipe: every stage runs all M forwards, then all M backwards (M
             stashed inputs a stage).
      1f1b:  stage s warms up with S-1-s forwards, then alternates one
             backward and one forward (at most S stashed inputs), the
             same (S-1)/(M+S-1) bubble."""
    S, M = num_stages, num_micro
    order = pipeline_order(schedule, S, M)
    done: Dict[Tuple[str, int, int], int] = {}
    idx = [0] * S
    ticks = []
    while any(idx[s] < len(order[s]) for s in range(S)):
        row = []
        for s in range(S):
            if idx[s] >= len(order[s]):
                continue
            ph, m = order[s][idx[s]]
            if ph == "F":
                ok = s == 0 or done.get(("F", s - 1, m), 10 ** 9) < len(ticks)
            else:
                ok = done.get(("F", s, m), 10 ** 9) < len(ticks) and (
                    s == S - 1
                    or done.get(("B", s + 1, m), 10 ** 9) < len(ticks))
            if ok:
                row.append((s, ph, m))
        if not row:
            raise RuntimeError("pipeline schedule deadlocked "
                               f"({schedule}, S={S}, M={M})")
        for s, ph, m in row:
            done[(ph, s, m)] = len(ticks)
            idx[s] += 1
        ticks.append(row)
    return ticks


def pipeline_order(schedule: str, num_stages: int, num_micro: int):
    """Each stage's op order: {stage: [(phase, microbatch), ...]}. A stage
    is one serial resource; the schedule is this order plus the data
    dependencies F(s,m) -> F(s+1,m) -> ... -> B(s+1,m) -> B(s,m)."""
    S, M = num_stages, num_micro
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    order: Dict[int, list] = {}
    for s in range(S):
        if schedule == "gpipe":
            ops = [("F", m) for m in range(M)] + [("B", m) for m in range(M)]
        else:
            warm = min(S - 1 - s, M)
            ops = [("F", m) for m in range(warm)]
            nf, nb = warm, 0
            while nb < M:
                if nf < M:
                    ops.append(("F", nf))
                    nf += 1
                ops.append(("B", nb))
                nb += 1
        order[s] = ops
    return order


def pipeline_timeline(schedule: str, num_micro: int,
                      fwd_times: Sequence[float],
                      bwd_times: Sequence[float],
                      p2p: float = 0.0):
    """Event-driven replay of a schedule on per-stage serial timelines: an
    op starts at max(stage free, producer finish + p2p hop); returns
    (makespan, {(phase, stage, micro): (start, end)}). Stages are not
    lockstepped: a tick-grid max would charge 1f1b's F/B interleaving for
    a duration mismatch that asynchronous stages never pay."""
    S = len(fwd_times)
    order = pipeline_order(schedule, S, num_micro)
    fin: Dict[Tuple[str, int, int], float] = {}
    events: Dict[Tuple[str, int, int], Tuple[float, float]] = {}
    avail = [0.0] * S
    idx = [0] * S
    pending = sum(len(o) for o in order.values())
    while pending:
        progressed = False
        for s in range(S):
            while idx[s] < len(order[s]):
                ph, m = order[s][idx[s]]
                if ph == "F":
                    dep = 0.0 if s == 0 else fin.get(("F", s - 1, m))
                else:
                    up = 0.0 if s == S - 1 else fin.get(("B", s + 1, m))
                    mine = fin.get(("F", s, m))
                    dep = None if (up is None or mine is None) \
                        else max(up, mine)
                if dep is None:
                    break  # producer not scheduled yet: the next sweep
                start = max(avail[s], dep + (p2p if dep > 0.0 else 0.0))
                dur = fwd_times[s] if ph == "F" else bwd_times[s]
                fin[(ph, s, m)] = start + dur
                events[(ph, s, m)] = (start, start + dur)
                avail[s] = start + dur
                idx[s] += 1
                pending -= 1
                progressed = True
        if not progressed:
            raise RuntimeError(f"pipeline schedule deadlocked ({schedule})")
    return max(avail), events


def pipeline_span(schedule: str, num_micro: int, fwd_times: Sequence[float],
                  bwd_times: Sequence[float], p2p: float = 0.0) -> float:
    return pipeline_timeline(schedule, num_micro, fwd_times, bwd_times,
                             p2p)[0]


def pipeline_bubble(schedule: str, num_micro: int, fwd_times: Sequence[float],
                    bwd_times: Sequence[float], p2p: float = 0.0) -> float:
    """Idle share of the S x span stage-time area of the replay: 1 -
    work / (S * span); for balanced stages the closed form (S-1)/(M+S-1)
    under both schedules (1f1b's gain is in-flight memory)."""
    S = len(fwd_times)
    span = pipeline_span(schedule, num_micro, fwd_times, bwd_times, p2p)
    if span <= 0.0:
        return 0.0
    work = num_micro * sum(fwd_times[s] + bwd_times[s] for s in range(S))
    return max(0.0, 1.0 - work / (S * span))


def pipeline_bubble_fraction(schedule: str, num_stages: int,
                             num_micro: int) -> float:
    """Closed-form bubble of a balanced pipeline, (S-1)/(M+S-1), for
    gpipe and 1f1b alike."""
    S, M = num_stages, num_micro
    if S <= 1 or M <= 0:
        return 0.0
    return (S - 1) / (M + S - 1)


def pipeline_inflight_acts(schedule: str, num_stages: int,
                           num_micro: int) -> int:
    """Peak stashed boundary inputs a stage holds: M under gpipe, min(S, M)
    under 1f1b."""
    return num_micro if schedule == "gpipe" else min(num_stages, num_micro)


def pipeline_phase_times(stage_costs: Sequence[float]):
    """Per-phase durations of the schedule the executor runs, from whole
    stage step costs (1x forward + 2x backward, compute_time's 3x
    convention): the forward slot is c/3; the backward slot is a full c,
    since it recomputes the stage forward from the stashed input; the
    last stage's forward slot is free (its loss and gradient share one
    forward in the backward slot). Kept in lockstep with
    parallel/pipeline.py's executor."""
    fwd = [c / 3.0 for c in stage_costs]
    bwd = [float(c) for c in stage_costs]
    fwd[-1] = 0.0
    return fwd, bwd


def pipeline_step_time(fwd_times: Sequence[float], bwd_times: Sequence[float],
                       boundary_bytes: Sequence[float], machine: MachineSpec,
                       schedule: str, num_micro: int) -> float:
    """Predicted wall time of one pipeline update (M microbatches): the
    replay's makespan plus every boundary crossing as a neighbor-hop P2P
    (the activation forward and its gradient back, once a microbatch a
    boundary)."""
    t = pipeline_span(schedule, num_micro, list(fwd_times), list(bwd_times))
    t += sum(2.0 * num_micro * p2p_time(b, machine) for b in boundary_bytes)
    return t


# --------------------------------------------------------- remat costing
# Per-layer rematerialization policies the DP searches over:
# policy -> (recompute_frac, keep_frac).
#   recompute_frac — extra time the backward pays, as a fraction of the
#     op's 3x-roofline step cost. "full" re-runs the layer forward once
#     (= c/3 of the fwd+bwd cost); "dots" keeps matmul outputs and re-runs
#     only the cheap elementwise tail (compiler/lowering.py's selective
#     checkpoint), ~a quarter of a forward.
#   keep_frac — fraction of the layer's BACKWARD-stash residency that
#     survives until the backward pass. The DP's live-activation
#     accounting charges a forward value (mult 1) plus a backward stash
#     (mult act_mult-1, normally 1): "none" keeps the whole stash,
#     "dots" roughly half (dot outputs saved, elementwise recomputed),
#     "full" none of it — only the layer INPUT (already charged as the
#     producer's output) is saved.
REMAT_POLICY_SPECS: Dict[str, Tuple[float, float]] = {
    "none": (0.0, 1.0),
    "dots": (1.0 / 12.0, 0.5),
    "full": (1.0 / 3.0, 0.0),
}


def remat_recompute_time(op_time_s: float, policy: str) -> float:
    """Extra backward-pass time a remat policy adds to one op: the
    recompute fraction of its (3x-roofline) step cost."""
    return REMAT_POLICY_SPECS[policy][0] * op_time_s


def remat_act_mult(policy: str, act_mult: float) -> float:
    """Effective live-bytes multiplier for a remat'd layer's outputs: the
    forward value (1) plus the surviving fraction of the backward stash
    (act_mult - 1). none: act_mult unchanged; full: 1 (value only);
    dots: halfway. Inference (act_mult=1) is a fixed point — remat can't
    save memory where no stash exists."""
    return 1.0 + REMAT_POLICY_SPECS[policy][1] * (act_mult - 1.0)


def grad_sync_time(weight_specs: Dict[str, TensorSpec],
                   weight_dims: Dict[str, List[DimSharding]],
                   machine: MachineSpec, batch_axes: Sequence[str],
                   zero: bool = False) -> float:
    """Gradient sync over the replica axes of each weight (reference:
    ncclAllReduce fused into the optimizer update, optimizer_kernel.cu:88).
    `zero` prices the ZeRO rewrite instead — reduce-scatter(grads) +
    all-gather(updates); both tensors are param-sized, so on a ring the
    total volume EQUALS the all-reduce's (the ZeRO win is memory, not
    step-time comm — keep the two terms equal or the DP's compute/comm
    overlap split in dp.py drifts from Candidate.op_time's internal sync
    term). Interned by (weight geometry, layouts, machine) — see memo.py."""
    if not weight_specs:
        return 0.0
    if memo.enabled():
        key = (memo.freeze_weight_specs(weight_specs),
               tuple(sorted((w, memo.freeze_dims(d))
                            for w, d in weight_dims.items())),
               tuple(batch_axes), zero, memo.machine_fingerprint(machine))
        t = memo.get("grad_sync", key)
        if t is not memo.MISS:
            return t
        return memo.put("grad_sync", key, _grad_sync_time(
            weight_specs, weight_dims, machine, batch_axes, zero))
    return _grad_sync_time(weight_specs, weight_dims, machine, batch_axes,
                           zero)


def _grad_sync_time(weight_specs, weight_dims, machine, batch_axes,
                    zero=False) -> float:
    t = 0.0
    for w, spec in weight_specs.items():
        dims = weight_dims.get(w, [None] * spec.ndim)
        used = {a for d in dims for a in _axes_of(d)}
        replica_axes = tuple(a for a in batch_axes if a not in used)
        if not replica_axes:
            continue
        b = shard_bytes(spec, dims, machine)
        if zero:
            # grads scatter down at full size, the param-dtype updates
            # gather back up — same ring volume as the fused all-reduce
            t += reduce_scatter_time(b, replica_axes, machine) \
                + all_gather_time(b, replica_axes, machine)
        else:
            t += all_reduce_time(b, replica_axes, machine)
    return t


def __getattr__(name):
    # KVCacheSpec lives with the cache (serving/kv_cache.py); JAX's cost
    # model defines it here. Lazy: the serving package imports this module
    if name == "KVCacheSpec":
        from flexflow_tpu_torch.serving.kv_cache import KVCacheSpec

        return KVCacheSpec
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
