"""The capacity twin: a discrete-event replay of the serving control plane
(counterpart: flexflow_tpu/serving/twin.py).

"What happens to the TTFT p99 if we add a replica, raise spec K, flip the
KV dtype or shrink the device pool?" The twin answers without a card: it
replays any `serving/tracefmt.py` trace (recorded traffic and generated
load alike) through the control plane's own classes:

- admission by `AdmissionControl` (the permanent-shed, queue-cap and
  staleness decisions the scheduler and the fleet make),
- placement by `FleetRouter` (a simulated replica offers the signals a
  `ReplicaHandle` offers: outstanding work, queue depth, EMA prefill time),
- slots and pages by the `KVCacheSpec` geometry (device pool and host
  tier; spill and refill priced at the host link's rate, hidden behind
  `kv_prefetch_ahead` decode steps),
- speculation as expected commits a round (1 + accept rate x K tokens),
- the disaggregated handoff priced like the cache's `kv_transfer` rows.

Durations come from `TwinCosts`: live measurement (`from_live_report`)
over the analytic roofline of the machine. With no machine given the
roofline takes the port's H100 preset (`parallel/machine.CHIP_PRESETS`).
The learned cost model's rung returns nothing in the port: that model is
ROADMAP Queue 1 item 8. The report has the live schema: terminal records
from `reqtrace.terminal_record`, the same `StreamingHistogram` metrics and
an `SLOTracker` scoreboard, so twin against live is a plain diff
(`validate`) and `health.scaling_signal` reads the twin's output as it
reads a fleet's.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.health import SLOTracker, parse_slo, scaling_signal
from flexflow_tpu_torch.parallel.machine import CHIP_PRESETS
from flexflow_tpu_torch.serving.fleet import AdmissionControl, FleetRouter
from flexflow_tpu_torch.serving.kv_cache import KVCacheSpec
from flexflow_tpu_torch.serving.reqtrace import (HIST_METRICS,
                                                 StreamingHistogram,
                                                 terminal_record)
from flexflow_tpu_torch.serving.scheduler import _urgency
from flexflow_tpu_torch.serving.tracefmt import TraceRecord, scale_rate

__all__ = ["TwinSpec", "TwinCosts", "TwinResult", "simulate",
           "capacity_curve", "validate", "emit_residual_rows",
           "signal_timeline", "calibrate_window_overhead"]


class _Len:
    """A length without the storage: admission and terminal_record only
    take len() of prompts and token lists, so the twin carries counts."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = int(n)

    def __len__(self) -> int:
        return self.n


class _SimReq:
    """The twin's request: the fields `AdmissionControl`, `_urgency` and
    `terminal_record` read off a live `Request`, with counted lengths in
    place of token lists."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "arrival_s", "priority",
                 "deadline_s", "tokens", "ttft_s", "admit_s", "finish_s",
                 "outcome", "kv_pages", "host_pages", "phase")

    def __init__(self, rec: TraceRecord, rid: int):
        self.rid = rec.rid if rec.rid is not None else rid
        self.prompt = _Len(rec.tokens_in)
        self.max_new_tokens = int(rec.max_tokens)
        self.arrival_s = float(rec.arrival_ts)
        self.priority = int(rec.priority)
        self.deadline_s = rec.deadline
        self.tokens = _Len(0)
        self.ttft_s: Optional[float] = None
        self.admit_s: Optional[float] = None
        self.finish_s: Optional[float] = None
        self.outcome = ""
        self.kv_pages = 0       # device pages held
        self.host_pages = 0     # host-tier pages borrowed (spilled)
        self.phase = "arrive"   # arrive | decode (after a disagg handoff)


# ------------------------------------------------------------------- spec
@dataclasses.dataclass
class TwinSpec:
    """The structure of a scenario: the replica topology and the
    scheduler and cache knobs. Time lives in `TwinCosts`, so one spec
    sweeps across pricing assumptions."""

    replicas: int = 1
    slots: int = 4
    seq: int = 16                 # prefill window (max prompt positions)
    page_size: int = 4
    pages_per_slot: int = 0       # 0 -> from seq + the decode budget
    max_decode_len: int = 8
    layers: int = 1
    heads: int = 2
    head_dim: int = 32
    itemsize: int = 4
    scale_itemsize: int = 0
    host_pages: int = 0
    device_pages: int = 0
    dispatch_ahead: int = 4
    spec_tokens: int = 0          # draft K (0 = greedy)
    spec_accept_rate: float = 0.6
    queue_cap: int = 0
    ttft_budget_ms: float = 0.0
    max_context: int = 0
    prefetch_ahead: int = 2
    router: str = "least_loaded"
    slo: str = ""
    topology: str = "colocated"   # "colocated" | "disagg"
    prefill_replicas: int = 1

    def __post_init__(self):
        if not self.pages_per_slot:
            total = self.seq + self.max_decode_len
            self.pages_per_slot = max(1, -(-total // self.page_size))

    def kv_spec(self) -> KVCacheSpec:
        return KVCacheSpec(
            layers=self.layers, heads=self.heads, head_dim=self.head_dim,
            slots=self.slots, pages_per_slot=self.pages_per_slot,
            page_size=self.page_size, itemsize=self.itemsize,
            scale_itemsize=self.scale_itemsize,
            host_pages=self.host_pages, device_pages=self.device_pages)

    @classmethod
    def from_engine(cls, engine: Any, replicas: int = 1,
                    dispatch_ahead: int = 4) -> "TwinSpec":
        """The spec of a live engine's configuration: twin against live
        builds its spec here, so the two cannot drift apart."""
        ks: KVCacheSpec = engine.kv.spec
        cfg = getattr(engine, "cfg", None)
        g = (lambda k, d: getattr(cfg, k, d) if cfg is not None else d)
        return cls(
            replicas=replicas, slots=int(engine.slots),
            seq=int(engine.prefill_model.input_tensors[0].spec.shape[1]),
            page_size=ks.page_size, pages_per_slot=ks.pages_per_slot,
            max_decode_len=int(getattr(engine, "max_decode_len", 0) or
                               ks.padded_len),
            layers=ks.layers, heads=ks.heads, head_dim=ks.head_dim,
            itemsize=ks.itemsize, scale_itemsize=ks.scale_itemsize,
            host_pages=ks.host_pages, device_pages=ks.device_pages,
            dispatch_ahead=dispatch_ahead,
            spec_tokens=int(g("serve_spec_tokens", 0)),
            queue_cap=int(g("serve_queue_cap", 0)),
            ttft_budget_ms=float(g("serve_ttft_budget_ms", 0.0)),
            max_context=int(g("serve_max_context", 0)),
            prefetch_ahead=int(g("kv_prefetch_ahead", 2)),
            router=str(g("serve_router", "least_loaded")),
            slo=str(g("serve_slo", "") or ""),
            topology=str(g("serve_fleet_topology", "colocated")),
            prefill_replicas=int(g("serve_prefill_replicas", 1)))


# ------------------------------------------------------------------ costs
def _twin_features(kind: str, spec: KVCacheSpec, slots: int,
                   machine: Any = None) -> Dict[str, Any]:
    """The feature row of the twin's `twin_*` op kinds, as
    `emit_residual_rows` writes it."""
    from flexflow_tpu_torch.search import memo
    return {
        "op": kind,
        "in_shapes": [[slots, spec.page_size, spec.heads, spec.head_dim]],
        "out_shapes": [[slots, spec.page_size, spec.heads, spec.head_dim]],
        "weight_shapes": [],
        "dtype": "int8" if spec.scale_itemsize else "float32",
        "params": 0,
        "layout": f"L{spec.layers}",
        "sharding": {"out": [], "weights": []},
        "machine": (memo.machine_fingerprint(machine)
                    if machine is not None else ()),
    }


@dataclasses.dataclass
class TwinCosts:
    """Every duration the event loop charges. `source` names the rung of
    the ladder that priced it ("measured" or "analytic")."""

    decode_step_s: float = 1e-3       # one decode step (all slots)
    prefill_base_s: float = 1e-3      # per prefill program launch
    prefill_per_token_s: float = 0.0  # + per prompt token in the batch
    kv_transfer_page_s: float = 1e-5  # host<->device, one page, all layers
    spec_round_factor: float = 1.3    # a verify round against a plain step
    window_overhead_s: float = 0.0    # host work a dispatch window that no
    #   per-op histogram sees (admission, sampling, the materializing
    #   sync); it limits throughput under overload: calibrate it from a
    #   saturated live run (`calibrate_window_overhead`)
    source: str = "analytic"

    def prefill_s(self, batch_tokens: int) -> float:
        return self.prefill_base_s + self.prefill_per_token_s * batch_tokens

    def commit_per_step(self, spec_tokens: int, accept: float) -> float:
        """Expected tokens a slot commits per priced step."""
        if spec_tokens <= 0:
            return 1.0
        return 1.0 + max(0.0, min(1.0, accept)) * spec_tokens

    def step_s(self, spec_tokens: int) -> float:
        return self.decode_step_s * (self.spec_round_factor
                                     if spec_tokens > 0 else 1.0)

    # ------------------------------------------------------- resolution
    @classmethod
    def analytic(cls, spec: KVCacheSpec, machine: Any = None,
                 param_bytes: int = 0, step_floor_s: float = 0.0,
                 model_degree: int = 1) -> "TwinCosts":
        """The roofline: a decode step streams the weights and the live
        K/V, a prefill is one launch's overhead plus compute per token, the
        host link prices tier traffic. The rates are the machine's (a
        `MachineSpec`: `hbm_bw`, `host_bw`, `flops`), else the H100
        preset's. A simulated device-step floor dominates when set."""
        h100 = CHIP_PRESETS["h100"]
        hbm_bw = getattr(machine, "hbm_bw", 0.0) or h100.hbm_bw
        host_bw = getattr(machine, "host_bw", 0.0) or h100.host_bw
        flops = getattr(machine, "flops", 0.0) or h100.flops
        overhead_s = 5e-5  # host dispatch floor per program launch
        step = (param_bytes + spec.step_read_bytes(model_degree)) / hbm_bw \
            + overhead_s
        per_tok = (2.0 * max(0, param_bytes // 4)) / flops
        return cls(decode_step_s=max(step, step_floor_s),
                   prefill_base_s=max(overhead_s, step_floor_s),
                   prefill_per_token_s=per_tok,
                   kv_transfer_page_s=spec.layers * spec.page_bytes()
                   / host_bw,
                   source="analytic")

    @classmethod
    def from_live_report(cls, report: Dict[str, Any],
                         fallback: "TwinCosts") -> "TwinCosts":
        """Step and prefill means from a live report's histograms (a
        scheduler's `tracer.hists` or a fleet report's summaries): the twin
        is told how long a step IS and queueing emerges."""
        step = _hist_mean(report, "decode_step")
        pre = _hist_mean(report, "prefill")
        return cls(
            decode_step_s=step if step and step > 0
            else fallback.decode_step_s,
            prefill_base_s=pre if pre and pre > 0
            else fallback.prefill_base_s,
            prefill_per_token_s=0.0 if pre and pre > 0
            else fallback.prefill_per_token_s,
            kv_transfer_page_s=fallback.kv_transfer_page_s,
            spec_round_factor=fallback.spec_round_factor,
            window_overhead_s=fallback.window_overhead_s,
            source="measured")

    @classmethod
    def resolve(cls, spec: KVCacheSpec, cfg: Any = None, machine: Any = None,
                live_report: Optional[Dict[str, Any]] = None,
                param_bytes: int = 0, step_floor_s: float = 0.0,
                model_degree: int = 1, slots: int = 0) -> "TwinCosts":
        """The ladder, field by field: learned model > live measurement >
        analytic roofline (the port's learned rung is empty, see
        `_learned_costs`)."""
        out = cls.analytic(spec, machine, param_bytes=param_bytes,
                           step_floor_s=step_floor_s,
                           model_degree=model_degree)
        if live_report is not None:
            out = cls.from_live_report(live_report, out)
        learned = _learned_costs(spec, cfg, machine,
                                 slots=slots or spec.slots)
        if learned:
            for field, val in learned.items():
                setattr(out, field, val)
            out.source = "learned" if len(learned) >= 2 else out.source
        # a measured step can't beat a simulated device floor
        out.decode_step_s = max(out.decode_step_s, step_floor_s)
        out.prefill_base_s = max(out.prefill_base_s, step_floor_s)
        return out


def _hist_mean(report: Dict[str, Any], metric: str) -> Optional[float]:
    """A histogram's mean from a report: a summary dict or a
    `StreamingHistogram`."""
    h = (report.get("hists") or {}).get(metric)
    if h is None:
        return None
    if isinstance(h, dict):
        return h.get("mean")
    mean = getattr(h, "mean", None)
    return mean() if callable(mean) else None


def _learned_costs(spec: KVCacheSpec, cfg: Any, machine: Any,
                   slots: int) -> Dict[str, float]:
    """The learned cost model's prices of the twin's step and prefill.
    The port has no learned cost model yet (`--cost-model-path` is ROADMAP
    Queue 1 item 8), so it returns {}, as the JAX package does when no
    model file resolves: the ladder falls through to measurement and the
    roofline."""
    return {}


# ------------------------------------------------------------- sim replica
class _SimReplica:
    """One replica's state on its own virtual-time axis. It offers the
    router-visible surface of `ReplicaHandle` (outstanding, worst_burn,
    index, sched.queue_depth, sched._ema_serve_ms), so the real
    `FleetRouter` places the twin's work."""

    def __init__(self, index: int, spec: TwinSpec, role: str = "mixed"):
        ks = spec.kv_spec()
        self.index = index
        self.role = role
        self.t = 0.0
        self.waiting: List[_SimReq] = []
        self.active: List[_SimReq] = []
        self.free_slots = int(spec.slots)
        self.free_device = ks.pool_pages - 1   # data pages (minus scratch)
        self.free_host = int(ks.host_pages)
        self.assigned = 0
        self.done = 0
        self._ema_serve_s = 0.05
        self.busy_s = 0.0
        self.stepping = False   # a "step" event is in the heap

    @property
    def sched(self) -> "_SimReplica":
        return self

    @property
    def _ema_serve_ms(self) -> float:
        return self._ema_serve_s * 1e3

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def outstanding(self) -> int:
        return max(0, self.assigned - self.done)

    def worst_burn(self) -> float:
        return 0.0


# ------------------------------------------------------------------ result
@dataclasses.dataclass
class TwinResult:
    """The twin's output in the live report's shape: terminal records,
    histograms, an SLOTracker scoreboard, and the scaling-signal timeline
    of the replay."""

    completed: List[Dict[str, Any]]
    shed: List[Dict[str, Any]]
    hists: Dict[str, StreamingHistogram]
    slo: SLOTracker
    stats: Dict[str, Any]
    signals: List[Dict[str, Any]]
    spec: TwinSpec
    costs: TwinCosts

    def report(self) -> Dict[str, Any]:
        hists = {m: {"count": h.count, "mean": h.mean(),
                     "p50": h.quantile(0.5), "p99": h.quantile(0.99)}
                 for m, h in self.hists.items() if h.count}
        slo_report = self.slo.report(now_s=self.stats.get("wall_s") or None)
        return {"stats": dict(self.stats), "hists": hists,
                "slo": slo_report, "scaling": scaling_signal(slo_report),
                "signals": list(self.signals),
                "priced_by": self.costs.source}


# -------------------------------------------------------------- event loop
def simulate(records: Sequence[TraceRecord], spec: TwinSpec,
             costs: TwinCosts, signal_every_s: float = 5.0
             ) -> TwinResult:
    """Replay a trace through the twin. Deterministic: the same records,
    spec and costs give the same result (no wall clock, no rng)."""
    ks = spec.kv_spec()
    pages_needed = (lambda total:
                    -(-min(int(total), ks.padded_len) // ks.page_size))
    admission = AdmissionControl(
        seq=spec.seq, max_context=spec.max_context,
        queue_cap=spec.queue_cap, ttft_budget_ms=spec.ttft_budget_ms,
        overhead_tokens=spec.dispatch_ahead + spec.spec_tokens,
        pages_needed=pages_needed,
        capacity_pages=lambda: (ks.pool_pages - 1) + ks.host_pages)
    router = FleetRouter(spec.router)
    disagg = spec.topology == "disagg" and spec.replicas > 1
    n_pre = max(1, min(spec.prefill_replicas, spec.replicas - 1)) \
        if disagg else 0
    replicas = [
        _SimReplica(i, spec,
                    role=("prefill" if disagg and i < n_pre else
                          "decode" if disagg else "mixed"))
        for i in range(spec.replicas)]
    prefill_pool = replicas[:n_pre] if disagg else replicas
    decode_pool = replicas[n_pre:] if disagg else replicas

    cps = costs.commit_per_step(spec.spec_tokens, spec.spec_accept_rate)
    step_s = costs.step_s(spec.spec_tokens)
    handoff_pages = pages_needed(spec.seq)  # the prefill's K/V (disagg)

    hists = {m: StreamingHistogram() for m in HIST_METRICS}
    terminals: List[Tuple[float, Dict[str, Any]]] = []
    completed: List[Dict[str, Any]] = []
    shed: List[Dict[str, Any]] = []
    counters = {"kv_spilled_pages": 0, "prefetch_stall_s": 0.0,
                "handoffs": 0, "tokens_out": 0, "windows": 0}

    def terminal(req: _SimReq, now_s: float, outcome: str,
                 reason: str) -> None:
        req.outcome = outcome
        req.finish_s = now_s
        rec = terminal_record(req, now_s, req.kv_pages + req.host_pages,
                              reason)
        terminals.append((now_s, rec))
        if outcome == "done":
            completed.append(rec)
            counters["tokens_out"] += rec["tokens_out"]
            if rec["ttft_s"] is not None:
                hists["ttft"].add(rec["ttft_s"])
            if rec["per_token_s"] is not None:
                hists["per_token"].add(rec["per_token_s"])
        else:
            shed.append(rec)
        hists["queue_wait"].add(rec["queue_wait_s"])

    # (time, seq, kind, payload): seq breaks ties deterministically
    events: List[Tuple[float, int, str, Any]] = []
    eseq = 0

    def push(t: float, kind: str, payload: Any) -> None:
        nonlocal eseq
        heapq.heappush(events, (t, eseq, kind, payload))
        eseq += 1

    def wake(rep: _SimReplica, t: float) -> None:
        if not rep.stepping:
            rep.stepping = True
            push(max(t, rep.t), "step", rep)

    def admit_batch(rep: _SimReplica) -> List[_SimReq]:
        """Most urgent first, head of line, under slot and two-tier page
        occupancy: stop at the first waiter that does not fit, as the
        scheduler's page backpressure does."""
        batch: List[_SimReq] = []
        rep.waiting.sort(key=_urgency)
        while rep.waiting and rep.free_slots > 0:
            req = rep.waiting[0]
            budget = (req.max_new_tokens if req.phase != "decode"
                      else max(1, req.max_new_tokens - len(req.tokens)))
            need = pages_needed(len(req.prompt) + budget
                                + admission.overhead_tokens)
            dev = min(need, rep.free_device)
            host = need - dev
            if host > rep.free_host:
                break
            rep.waiting.pop(0)
            rep.free_slots -= 1
            rep.free_device -= dev
            rep.free_host -= host
            req.kv_pages, req.host_pages = dev, host
            if host:
                counters["kv_spilled_pages"] += host
            batch.append(req)
        return batch

    def release(rep: _SimReplica, req: _SimReq) -> None:
        rep.free_slots += 1
        rep.free_device += req.kv_pages
        rep.free_host += req.host_pages
        rep.done += 1

    def replica_step(rep: _SimReplica) -> None:
        t0 = rep.t
        # 1) the staleness sweep (deadline, TTFT budget)
        for req, reason in admission.stale(rep.waiting, rep.t,
                                           rep._ema_serve_ms):
            terminal(req, rep.t, "shed", reason)
            rep.done += 1
        # 2) admit and prefill (handed-off requests skip the prefill)
        batch = admit_batch(rep)
        fresh = [r for r in batch if r.phase != "decode"]
        joins = [r for r in batch if r.phase == "decode"]
        if fresh:
            for req in fresh:
                req.admit_s = rep.t
            dt = costs.prefill_s(sum(len(r.prompt) for r in fresh))
            spill = sum(r.host_pages for r in fresh)
            if spill:
                dt += spill * costs.kv_transfer_page_s
            rep.t += dt
            rep._ema_serve_s = 0.9 * rep._ema_serve_s + 0.1 * dt
            hists["prefill"].add(dt, n=len(fresh))
            for req in fresh:
                req.ttft_s = rep.t - req.arrival_s
                req.tokens = _Len(1)
                if rep.role == "prefill":
                    # disagg: the first token came from the prefill; the
                    # K/V pages travel to the decode pool over the host link
                    release(rep, req)
                    req.kv_pages = req.host_pages = 0
                    req.phase = "decode"
                    counters["handoffs"] += 1
                    push(rep.t + handoff_pages * costs.kv_transfer_page_s,
                         "handoff", req)
                else:
                    rep.active.append(req)
        for req in joins:
            if req.admit_s is None:
                req.admit_s = rep.t
            rep.active.append(req)
        # 3) a decode window
        worked = bool(fresh or joins or rep.active)
        if rep.active:
            steps = min(spec.dispatch_ahead,
                        max(int(math.ceil(
                            (r.max_new_tokens - len(r.tokens)) / cps))
                            for r in rep.active))
            steps = max(1, steps)
            dt = steps * step_s
            stall_pages = sum(r.host_pages for r in rep.active)
            if stall_pages:
                stall = max(0.0, stall_pages * costs.kv_transfer_page_s
                            - spec.prefetch_ahead * step_s)
                counters["prefetch_stall_s"] += stall
                dt += stall
            hists["decode_step"].add(dt / steps, n=steps)
            for req in list(rep.active):
                take = min(req.max_new_tokens - len(req.tokens),
                           int(math.ceil(steps * cps)))
                req.tokens = _Len(len(req.tokens) + max(0, take))
                if len(req.tokens) >= req.max_new_tokens:
                    finish_steps = min(steps,
                                       int(math.ceil(max(1, take) / cps)))
                    rep.active.remove(req)
                    terminal(req, rep.t + finish_steps * step_s,
                             "done", "completed")
                    release(rep, req)
            rep.t += dt
        if worked:
            # one outer-loop window's host overhead
            rep.t += costs.window_overhead_s
            counters["windows"] += 1
        rep.busy_s += rep.t - t0
        if rep.active or rep.waiting:
            push(rep.t, "step", rep)
        else:
            rep.stepping = False

    reqs = [_SimReq(rec, i) for i, rec in enumerate(records)]
    for req in reqs:
        push(req.arrival_s, "arrive", req)
    while events:
        t, _, kind, payload = heapq.heappop(events)
        if kind == "arrive":
            reason = admission.permanent_shed_reason(payload)
            if reason is not None:
                terminal(payload, t, "shed", reason)
                continue
            rep = router.pick(prefill_pool)
            rep.assigned += 1
            victim = admission.queue_or_displace(payload, rep.waiting)
            if victim is not None:
                terminal(victim, t, "shed", "queue_full")
                rep.done += 1
            wake(rep, t)
        elif kind == "handoff":
            rep = router.pick(decode_pool)
            rep.assigned += 1
            rep.waiting.append(payload)
            wake(rep, t)
        else:  # step
            payload.t = max(payload.t, t)
            replica_step(payload)

    terminals.sort(key=lambda e: e[0])
    tracker = SLOTracker(parse_slo(spec.slo or ""))
    for t, rec in terminals:
        tracker.observe(rec, now_s=t)
    wall = max([t for t, _ in terminals] + [r.t for r in replicas] + [1e-9])
    stats = {
        "requests": len(reqs), "completed": len(completed),
        "shed": len(shed), "replicas": spec.replicas,
        "topology": spec.topology, "wall_s": wall,
        "tokens_out": counters["tokens_out"],
        "tokens_per_s": counters["tokens_out"] / wall,
        "handoffs": counters["handoffs"],
        "windows": counters["windows"],
        "kv_spilled_pages": counters["kv_spilled_pages"],
        "prefetch_stall_s": counters["prefetch_stall_s"],
        "utilization": [r.busy_s / wall for r in replicas],
    }
    signals = signal_timeline(terminals, parse_slo(spec.slo or ""),
                              interval_s=signal_every_s)
    return TwinResult(completed=completed, shed=shed, hists=hists,
                      slo=tracker, stats=stats, signals=signals,
                      spec=spec, costs=costs)


# -------------------------------------------------------------- signals
def signal_timeline(terminals: Sequence[Tuple[float, Dict[str, Any]]],
                    objectives: Dict[str, Dict[str, Any]],
                    interval_s: float = 5.0) -> List[Dict[str, Any]]:
    """`health.scaling_signal` every `interval_s` of virtual time over the
    terminal stream: what an autoscaler polling the scoreboard at that
    cadence would have seen. Only changes of action are recorded."""
    if not terminals or not objectives:
        return []
    tracker = SLOTracker(objectives)
    timeline: List[Dict[str, Any]] = []
    last_action = None
    next_t = terminals[0][0] + interval_s
    idx = 0
    end = terminals[-1][0]
    while next_t <= end + interval_s:
        while idx < len(terminals) and terminals[idx][0] <= next_t:
            t, rec = terminals[idx]
            tracker.observe(rec, now_s=t)
            idx += 1
        sig = scaling_signal(tracker.report(now_s=min(next_t, end)))
        if sig["action"] != last_action:
            timeline.append({"t": round(min(next_t, end), 6), **sig})
            last_action = sig["action"]
        next_t += interval_s
    return timeline


# --------------------------------------------------------- capacity curve
def capacity_curve(records: Sequence[TraceRecord], spec: TwinSpec,
                   costs: TwinCosts,
                   replicas: Sequence[int] = (1, 2, 4),
                   feasible: Optional[Callable[[TwinResult], bool]] = None,
                   iters: int = 7) -> List[Dict[str, Any]]:
    """Replicas -> the most offered load sustained at SLO, by bisection
    over `tracefmt.scale_rate` factors: an exponential search brackets
    the edge, then `iters` halvings pin it. "Sustained" by default: no
    sheds, budget left on every objective, and the replay drains about as
    fast as the load arrives (wall within 5% of the arrival span plus one
    request's service time)."""
    if not records:
        return []
    duration = max(r.arrival_ts for r in records) or 1e-9
    base_rate = len(records) / duration
    mean_prompt = sum(r.tokens_in for r in records) / len(records)
    mean_new = sum(r.max_tokens for r in records) / len(records)
    cps = costs.commit_per_step(spec.spec_tokens, spec.spec_accept_rate)
    svc_s = (costs.prefill_s(mean_prompt)
             + math.ceil(mean_new / cps) * costs.step_s(spec.spec_tokens))

    out: List[Dict[str, Any]] = []
    for n in replicas:
        spec_n = dataclasses.replace(spec, replicas=int(n))

        def ok(factor: float) -> bool:
            # scale_rate(records, f) multiplies the offered RATE by f
            res = simulate(scale_rate(records, factor), spec_n, costs)
            if feasible is not None:
                return feasible(res)
            if res.stats["shed"]:
                return False
            if res.stats["wall_s"] > 1.05 * (duration / factor) \
                    + svc_s:
                return False
            rep = res.slo.report(now_s=res.stats["wall_s"])
            budgets = [o["budget_remaining"]
                       for o in (rep.get("objectives") or {}).values()]
            return all(b > 0 for b in budgets)

        lo, hi = 0.0, 1.0
        if ok(1.0):
            lo = 1.0
            while lo < 4096 and ok(lo * 2):
                lo *= 2
            hi = lo * 2
        for _ in range(iters):
            mid = (lo + hi) / 2
            if mid <= 0:
                break
            if ok(mid):
                lo = mid
            else:
                hi = mid
        out.append({"replicas": int(n), "load_factor": lo,
                    "capacity_rps": base_rate * lo})
    return out


def calibrate_window_overhead(probe_records: Sequence[TraceRecord],
                              spec: TwinSpec, costs: TwinCosts,
                              live_wall_s: float) -> float:
    """`TwinCosts.window_overhead_s` from a SATURATED live run: replay the
    probe at zero overhead and spread the wall time the live run took
    beyond the twin's over the windows the twin dispatched (the host work
    between materializations that no per-op histogram sees)."""
    base = dataclasses.replace(costs, window_overhead_s=0.0)
    res = simulate(probe_records, spec, base)
    windows = max(1, res.stats["windows"])
    return max(0.0, (live_wall_s - res.stats["wall_s"]) / windows)


# ------------------------------------------------------------- validation
def validate(live: Dict[str, float], twin: Dict[str, float],
             max_rel_err: float = 0.25) -> Dict[str, Any]:
    """Twin against live: each shared metric's relative error against the
    live value, and whether the worst stays within `max_rel_err`."""
    metrics: Dict[str, Dict[str, float]] = {}
    worst = 0.0
    for k in sorted(set(live) & set(twin)):
        lv, tv = live[k], twin[k]
        if lv is None or tv is None:
            continue
        err = abs(tv - lv) / max(abs(lv), 1e-12)
        metrics[k] = {"live": float(lv), "twin": float(tv),
                      "rel_err": err}
        worst = max(worst, err)
    return {"metrics": metrics, "max_rel_err": worst,
            "bound": max_rel_err,
            "ok": bool(metrics) and worst <= max_rel_err}


def emit_residual_rows(live_report: Dict[str, Any], costs: TwinCosts,
                       spec: KVCacheSpec, slots: int,
                       machine: Any = None) -> int:
    """`op/attr` telemetry rows pairing the twin's priced step and
    prefill with the live means, shaped like the cache's `kv_transfer`
    rows, for a learned cost model's refit. Returns the rows written."""
    from flexflow_tpu_torch import telemetry as tel
    from flexflow_tpu_torch.attribution import OP_EVENT, feature_key

    rows = 0
    for kind, predicted, metric in (
            ("twin_decode_step", costs.decode_step_s, "decode_step"),
            ("twin_prefill", costs.prefill_base_s, "prefill")):
        measured = _hist_mean(live_report, metric)
        if not measured or measured <= 0:
            continue
        features = _twin_features(kind, spec, slots, machine)
        tel.event(OP_EVENT, cat="op", layer=f"twin/{kind}", op=kind,
                  candidate="twin", predicted_s=predicted,
                  measured_s=measured, attributed_s=measured,
                  roofline_s=predicted, bound="twin", mfu=0.0,
                  mfu_ceiling=0.0, key=feature_key(features),
                  features=features, source="twin", bytes=0)
        rows += 1
    return rows
