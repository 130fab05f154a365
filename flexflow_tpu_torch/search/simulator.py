"""Event-driven task-graph simulator: a concurrent replay of a full
strategy (counterpart: flexflow_tpu/search/simulator.py).

Reference analog: `LogicalTaskgraphBasedSimulator::simulate_runtime`
(include/flexflow/simulator.h:785-827, src/runtime/simulator.cc:1251-1480):
build forward, backward and all-reduce tasks per op under a chosen
parallel config, wire dependency edges with transfer tasks, then replay
the graph with a ready queue. Timelines advance concurrently, so the
overlap of compute and communication comes out of the schedule instead of
the closed-form `overlapped_step_cost` the frontier DP uses per layer.

Every device runs the same program, so one timeline per hardware stream
stands for all of them: the compute stream ("mxu", the name the JAX
package gives it, kept so both packages build the same task lists) and
one link stream per mesh axis. Tasks:

  fwd[i]  (mxu)     the candidate's forward compute
  bwd[i]  (mxu)     its backward compute (reverse graph order)
  edge comm (link)  the reshard of an input edge, forward direction
  inherent comm     the candidate's extra_comm (tp all-reduce, ring hops)
  grad sync (link)  the per-layer gradient all-reduce over replica axes
  update[i] (mxu)   the optimizer update, bound by the memory rate

Transfers larger than `segment_bytes` (reference
`--simulator-segment-size`, 16 MB) are split into chunks chained on their
link, so short transfers interleave with long ones.

`simulate_pipeline` replays a pipeline schedule: each stage one serial
resource, every dependency edge checked against the replayed times.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.search import cost_model as cm
from flexflow_tpu_torch.search.candidates import (Candidate, _batch_axes,
                                                  _dp_dims)
from flexflow_tpu_torch.search.dp import _drop_axis, _freeze_dims

DEFAULT_SEGMENT_BYTES = 16 * 1024 * 1024  # reference model.cc:3493


@dataclasses.dataclass
class SimTask:
    name: str
    kind: str          # "comp" | "comm"
    resource: str      # "mxu" | "link:<axis>"
    duration: float
    bytes: int = 0
    ready_time: float = 0.0
    counter: int = 0
    next_tasks: List["SimTask"] = dataclasses.field(default_factory=list)
    start: float = -1.0
    end: float = -1.0

    def add_next(self, t: "SimTask") -> None:
        self.next_tasks.append(t)
        t.counter += 1


@dataclasses.dataclass
class SimReport:
    makespan: float
    tasks: List[SimTask]
    resource_busy: Dict[str, float]

    @property
    def total_comm(self) -> float:
        return sum(t.duration for t in self.tasks if t.kind == "comm")

    @property
    def exposed_comm(self) -> float:
        """Wall time the compute stream sat idle: the communication (and
        dependency stalls) the schedule did not hide behind compute."""
        return max(0.0, self.makespan - self.resource_busy.get("mxu", 0.0))

    @property
    def hidden_frac(self) -> float:
        tc = self.total_comm
        if tc <= 0:
            return 1.0
        return max(0.0, min(1.0, 1.0 - self.exposed_comm / tc))

    def to_json(self) -> dict:
        return {
            "makespan_s": self.makespan,
            "total_comm_s": self.total_comm,
            "exposed_comm_s": self.exposed_comm,
            "hidden_frac": self.hidden_frac,
            "resource_busy_s": dict(self.resource_busy),
            "timeline": [
                {"name": t.name, "kind": t.kind, "resource": t.resource,
                 "start_us": t.start * 1e6, "end_us": t.end * 1e6}
                for t in self.tasks],
        }

    def export_trace(self, path: str) -> None:
        """Chrome trace-event format (chrome://tracing, Perfetto), one
        thread per stream."""
        pids = {r: i for i, r in enumerate(sorted(self.resource_busy))}
        events = [
            {"name": t.name, "cat": t.kind, "ph": "X",
             "ts": t.start * 1e6, "dur": (t.end - t.start) * 1e6,
             "pid": 0, "tid": pids.get(t.resource, 99),
             "args": {"resource": t.resource}}
            for t in self.tasks]
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": i,
                 "args": {"name": r}} for r, i in pids.items()]
        with open(path, "w") as f:
            json.dump({"traceEvents": meta + events}, f)


def _involved_axes(src, dst) -> Tuple[str, ...]:
    sa = {a for d in src for a in cm._axes_of(d)}
    da = {a for d in dst for a in cm._axes_of(d)}
    return tuple(sorted(sa.symmetric_difference(da))) or tuple(sorted(sa | da))


def _link_of(axes: Sequence[str], machine: MachineSpec) -> str:
    """A collective over several axes is staged hierarchically
    (cost_model._hier_gather_time): its serial total occupies the slowest
    involved link's timeline."""
    live = [a for a in axes if machine.mesh_axes.get(a, 1) > 1]
    if not live:
        return "link:_"
    return "link:" + min(live, key=lambda a: machine.axis_bw_eff(a))


def build_step_tasks(model, choices: Dict[str, Candidate], machine: MachineSpec,
                     cost_fn=None, include_update: bool = True,
                     segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                     ) -> List[SimTask]:
    """The task graph of one training step under a full per-op assignment.

    `choices` maps layer name -> chosen Candidate (a SearchResult's choices
    or an MCMC assignment). `cost_fn(layer, cand)` overrides the analytic
    total op time. When it is the bound method `MeasuredCost.op_time` (or
    anything with `.op_times(layer, cand) -> (fwd, bwd)`), the measured
    forward/backward split is used; otherwise pure compute splits 1:2
    (cost_model.compute_time's 3x convention)."""
    layers = topo_order(model.layers)
    batch_sizes = {t.shape[0] for t in model.input_tensors if t.ndim > 0}
    batch_axes = _batch_axes(machine)
    tasks: List[SimTask] = []
    # the measured path passes the bound method MeasuredCost.op_time as
    # cost_fn (optimize.py): its measurer is found through __self__
    measurer = getattr(getattr(cost_fn, "__self__", None), "op_times",
                       None) or getattr(cost_fn, "op_times", None)

    def comm_task(name: str, dur: float, nbytes: int, link: str,
                  after: Sequence[SimTask], before: Sequence[SimTask]) -> None:
        """A comm task, split into `segment_bytes` chunks chained on the
        link so other transfers can interleave (reference
        route_transfer_seg)."""
        if dur <= 0:
            for a in after:
                for b in before:
                    a.add_next(b)
            return
        nseg = max(1, math.ceil(nbytes / segment_bytes)) if nbytes else 1
        prev: Optional[SimTask] = None
        for s in range(nseg):
            t = SimTask(f"{name}[{s}/{nseg}]" if nseg > 1 else name,
                        "comm", link, dur / nseg, nbytes // nseg)
            tasks.append(t)
            for a in (after if s == 0 else [prev]):
                a.add_next(t)
            prev = t
        for b in before:
            prev.add_next(b)

    # frontier layouts, evolving as in mcmc.assignment_cost
    lay: Dict[int, Tuple] = {
        t.guid: _freeze_dims(_dp_dims(t.shape, machine, batch_sizes))
        for t in model.input_tensors}
    fwd_of: Dict[str, SimTask] = {}
    bwd_of: Dict[str, SimTask] = {}
    producer: Dict[int, str] = {}  # tensor guid -> producing layer name

    for layer in layers:
        cand = choices[layer.name]
        if cand.passthrough:
            src = lay.get(layer.inputs[0].guid) if layer.inputs else None
            if src is None:
                src = _freeze_dims([None] * layer.inputs[0].spec.ndim)
            od = tuple(_drop_axis(d, cand.drop_axis) for d in src)
            pname = producer.get(layer.inputs[0].guid) if layer.inputs else None
            if od != src:
                # an implied all-gather between producer and consumers; the
                # forward and backward anchors alias the producer's
                spec = layer.inputs[0].spec
                dur = cm.reshard_time(spec, list(src), list(od), machine)
                link = _link_of(_involved_axes(src, od), machine)
                anchor = SimTask(f"{layer.name}:gather-anchor", "comp", "mxu", 0.0)
                tasks.append(anchor)
                comm_task(f"{layer.name}:gather", dur,
                          cm.shard_bytes(spec, list(od), machine), link,
                          [fwd_of[pname]] if pname and pname in fwd_of else [],
                          [anchor])
                fwd_of[layer.name] = anchor
                bwd_of[layer.name] = bwd_of.get(pname) if pname else None
            elif pname and pname in fwd_of:
                fwd_of[layer.name] = fwd_of[pname]
                bwd_of[layer.name] = bwd_of.get(pname)
            for o in layer.outputs:
                lay[o.guid] = od
                producer[o.guid] = layer.name
            continue

        # the op time split into forward / backward compute and its own comm
        op_comm = cand.extra_comm + cm.grad_sync_time(
            layer.weight_specs, cand.weight_dims, machine, batch_axes)
        if measurer is not None:
            fwd_t, bwd_t = measurer(layer, cand)
        else:
            total = cost_fn(layer, cand) if cost_fn else cand.op_time(layer, machine)
            comp = max(0.0, total - op_comm)
            fwd_t, bwd_t = comp / 3.0, 2.0 * comp / 3.0

        fwd = SimTask(f"{layer.name}:fwd", "comp", "mxu", fwd_t)
        bwd = SimTask(f"{layer.name}:bwd", "comp", "mxu", bwd_t)
        tasks += [fwd, bwd]
        fwd.add_next(bwd)  # bwd also waits on its consumers' bwd, below
        fwd_of[layer.name], bwd_of[layer.name] = fwd, bwd

        # input edges: the reshard in the forward, the reverse edge backward
        for ii, tin in enumerate(layer.inputs):
            cur = lay.get(tin.guid)
            if cur is None:
                cur = _freeze_dims([None] * tin.spec.ndim)
            want = _freeze_dims(cand.in_dims[ii] if ii < len(cand.in_dims)
                                else [None] * tin.spec.ndim)
            pname = producer.get(tin.guid)
            src_fwd = [fwd_of[pname]] if pname and pname in fwd_of else []
            dur = cm.reshard_time(tin.spec, list(cur), list(want), machine)
            comm_task(f"{layer.name}:in{ii}", dur,
                      cm.shard_bytes(tin.spec, list(want), machine),
                      _link_of(_involved_axes(cur, want), machine),
                      src_fwd, [fwd])
            if pname and bwd_of.get(pname) is not None:
                bwd.add_next(bwd_of[pname])

        # the inherent collective (tp_row all-reduce, ring hops, halos)
        # runs after the forward; consumers wait on it through an anchor
        if cand.extra_comm > 0:
            # candidate names carry the axis as their second token
            # ("tp_row:model", "inter:model:3-1")
            link = "link:_"
            parts = cand.name.split(":")
            if len(parts) > 1 and machine.mesh_axes.get(parts[1], 1) > 1:
                link = f"link:{parts[1]}"
            anchor = SimTask(f"{layer.name}:coll-anchor", "comp", "mxu", 0.0)
            tasks.append(anchor)
            out_bytes = sum(cm.shard_bytes(o.spec, list(
                cand.out_dims[oi] if oi < len(cand.out_dims) else []), machine)
                for oi, o in enumerate(layer.outputs))
            comm_task(f"{layer.name}:coll", cand.extra_comm, out_bytes, link,
                      [fwd], [anchor])
            fwd_of[layer.name] = anchor
            # the backward reads the collective's product too (the loss
            # needs the reduced output when this is the last layer)
            anchor.add_next(bwd)

        # the gradient all-reduce of each weight, then its update
        for w, spec in layer.weight_specs.items():
            dims = cand.weight_dims.get(w, [None] * spec.ndim)
            used = {a for d in dims for a in cm._axes_of(d)}
            replica_axes = tuple(a for a in batch_axes if a not in used)
            wbytes = cm.shard_bytes(spec, dims, machine)
            followers: List[SimTask] = []
            if include_update:
                # SGD/Adam: ~6 passes over the shard (read w, g, m, v;
                # write w, m, v) at the memory rate
                upd = SimTask(f"{layer.name}:{w}:update", "comp", "mxu",
                              6.0 * wbytes / machine.hbm_bw)
                tasks.append(upd)
                followers.append(upd)
            if replica_axes:
                dur = cm.all_reduce_time(wbytes, replica_axes, machine)
                comm_task(f"{layer.name}:{w}:gradsync", dur, wbytes,
                          _link_of(replica_axes, machine), [bwd], followers)
            else:
                for f in followers:
                    bwd.add_next(f)

        for oi, o in enumerate(layer.outputs):
            lay[o.guid] = _freeze_dims(
                cand.out_dims[oi] if oi < len(cand.out_dims)
                else [None] * o.spec.ndim)
            producer[o.guid] = layer.name

    return tasks


def replay(tasks: List[SimTask]) -> SimReport:
    """Reference simulate_runtime steps 4-5 (simulator.cc:1369-1447): pop
    the earliest-ready task, bind it to its stream's timeline, release its
    dependents."""
    heap: List[Tuple[float, int, SimTask]] = []
    seq = 0
    for t in tasks:
        if t.counter == 0:
            heap.append((t.ready_time, seq, t))
            seq += 1
    heapq.heapify(heap)
    free: Dict[str, float] = {}
    busy: Dict[str, float] = {}
    makespan = 0.0
    done = 0
    while heap:
        _, _, cur = heapq.heappop(heap)
        start = max(free.get(cur.resource, 0.0), cur.ready_time)
        end = start + cur.duration
        free[cur.resource] = end
        busy[cur.resource] = busy.get(cur.resource, 0.0) + cur.duration
        cur.start, cur.end = start, end
        makespan = max(makespan, end)
        done += 1
        for nxt in cur.next_tasks:
            nxt.ready_time = max(nxt.ready_time, end)
            nxt.counter -= 1
            if nxt.counter == 0:
                heapq.heappush(heap, (nxt.ready_time, seq, nxt))
                seq += 1
    if done != len(tasks):
        raise RuntimeError(
            f"task graph deadlock: {len(tasks) - done} tasks never ready")
    return SimReport(makespan=makespan, tasks=tasks, resource_busy=busy)


def simulate_strategy(model, choices: Dict[str, Candidate],
                      machine: MachineSpec, cost_fn=None,
                      include_update: bool = True,
                      segment_bytes: int = DEFAULT_SEGMENT_BYTES) -> SimReport:
    tasks = build_step_tasks(model, choices, machine, cost_fn=cost_fn,
                             include_update=include_update,
                             segment_bytes=segment_bytes)
    return replay(tasks)


def rerank(model, machine: MachineSpec, results: Sequence,
           cost_fn=None, segment_bytes: int = DEFAULT_SEGMENT_BYTES):
    """Re-rank DP finalists by simulated makespan (the refinement pass of
    `simulator_mode="taskgraph"`): the frontier DP's closed-form costing
    prunes the space, the event replay decides among the survivors.
    Returns (best result, reports parallel to `results`)."""
    reports = [simulate_strategy(model, r.choices, machine, cost_fn=cost_fn,
                                 segment_bytes=segment_bytes)
               for r in results]
    best = min(range(len(results)), key=lambda i: reports[i].makespan)
    return results[best], reports


# ----------------------------------------------------- pipeline validation
def simulate_pipeline(fwd_times: Sequence[float], bwd_times: Sequence[float],
                      schedule: str, num_micro: int,
                      p2p: float = 0.0) -> dict:
    """Event-driven replay of a pipeline schedule (JAX `simulator.py:
    373-409`): each stage one serial resource, an op starts at max(stage
    free, producer finish + p2p). Every dependency edge is checked against
    the replayed times (a schedule fault surfaces as a consumer starting
    before its producer ends). Returns {"makespan", "bubble", "events"},
    events keyed (phase, stage, microbatch) -> (start, end)."""
    span, events = cm.pipeline_timeline(schedule, num_micro,
                                        list(fwd_times), list(bwd_times),
                                        p2p=p2p)
    S = len(fwd_times)
    for (ph, s, m), (start, _end) in events.items():
        deps = []
        if ph == "F" and s > 0:
            deps.append(("F", s - 1, m))
        if ph == "B":
            deps.append(("F", s, m))
            if s < S - 1:
                deps.append(("B", s + 1, m))
        for d in deps:
            if events[d][1] > start + 1e-12:
                raise RuntimeError(
                    f"invalid pipeline schedule: {ph}(s={s}, m={m}) starts "
                    f"at {start} before its producer {d} ends at "
                    f"{events[d][1]}")
    return {
        "makespan": span,
        "bubble": cm.pipeline_bubble(schedule, num_micro, list(fwd_times),
                                     list(bwd_times), p2p=p2p),
        "events": events,
    }
