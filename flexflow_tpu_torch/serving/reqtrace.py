"""Request-level tracing and streaming latency histograms (counterpart:
flexflow_tpu/serving/reqtrace.py).

  * `StreamingHistogram`: fixed log-spaced buckets shared by every
    instance (10 a decade from 1 us to 100 s), so two histograms merge by
    adding bucket counts; numpy only, O(1) memory. It renders Prometheus
    histogram series (`*_bucket{le=...}`, `_sum`, `_count`) and answers
    quantiles by interpolating inside the landing bucket.
  * `RequestTracer`: each request's lifecycle from submission through its
    queue wait, its prefill wave, each decode window or speculative round,
    a parked interval in the KV host tier, any param swap landing
    mid-flight, to the terminal outcome. Stages TILE the request's wall
    time (each starts where the previous ended) and are emitted as
    `serve/req/<stage>` spans with tid "slot<k>"; finished traces stay in
    a bounded ring.
  * `terminal_record`: the one record every outcome (done, shed, failed,
    timeout) ends in, with the same fields; the SLO tracker classifies it.

Zero-sync contract, as in the JAX package: the tracer never reads a device
value and never takes a time itself beyond anchoring the clock in
`begin`; every timestamp it sees is one the scheduler already took at a
sync point. With `serve_reqtrace` off the scheduler holds no tracer.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

from flexflow_tpu_torch import telemetry as tel

# ------------------------------------------------------------- histograms
# One fixed bucket layout for every latency histogram in the process:
# log-spaced, 10 buckets per decade from 1us to 100s (~26% resolution per
# bucket). Fixed edges are what make histograms MERGEABLE — counts from
# two processes (or two bench legs) add elementwise with no rebinning.
HIST_LO_S = 1e-6
HIST_HI_S = 1e2
HIST_BUCKETS_PER_DECADE = 10
_N_EDGES = 8 * HIST_BUCKETS_PER_DECADE + 1  # 8 decades inclusive
HIST_EDGES = np.logspace(np.log10(HIST_LO_S), np.log10(HIST_HI_S), _N_EDGES)

# the tracer's five live histogram families
HIST_METRICS = ("ttft", "per_token", "queue_wait", "prefill", "decode_step")


class StreamingHistogram:
    """Fixed-bucket streaming latency histogram (seconds).

    counts[i] holds samples x with edges[i-1] < x <= edges[i]
    (counts[0] is the underflow <= edges[0], counts[-1] the overflow
    > edges[-1]), matching the Prometheus cumulative-`le` convention."""

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Optional[np.ndarray] = None):
        self.edges = HIST_EDGES if edges is None else np.asarray(edges, float)
        self.counts = np.zeros(len(self.edges) + 1, dtype=np.int64)
        self.sum = 0.0
        self.count = 0

    def add(self, value_s: float, n: int = 1) -> None:
        """Record `n` occurrences of one latency value."""
        if not np.isfinite(value_s):
            return
        i = int(np.searchsorted(self.edges, value_s, side="left"))
        self.counts[i] += n
        self.sum += float(value_s) * n
        self.count += n

    def add_many(self, values_s: Iterable[float]) -> None:
        vs = np.asarray(list(values_s), float)
        vs = vs[np.isfinite(vs)]
        if vs.size == 0:
            return
        idx = np.searchsorted(self.edges, vs, side="left")
        np.add.at(self.counts, idx, 1)
        self.sum += float(vs.sum())
        self.count += int(vs.size)

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """In-place merge; requires identical bucket edges (always true
        for the module's fixed layout)."""
        if len(self.edges) != len(other.edges) or \
                not np.allclose(self.edges, other.edges):
            raise ValueError("cannot merge histograms with different edges")
        self.counts += other.counts
        self.sum += other.sum
        self.count += other.count
        return self

    def quantile(self, q: float) -> Optional[float]:
        """q-quantile estimate (linear interpolation inside the landing
        bucket). Error is bounded by one bucket's width (~26%); tests pin
        this against np.percentile on random draws."""
        if self.count == 0:
            return None
        q = min(1.0, max(0.0, float(q)))
        target = q * (self.count - 1)
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c > target:
                lo = float(self.edges[i - 1]) if i >= 1 else 0.0
                hi = float(self.edges[i]) if i < len(self.edges) \
                    else float(self.edges[-1])
                frac = (target - cum + 0.5) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            cum += c
        return float(self.edges[-1])

    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    # -------------------------------------------------------- serialization
    def snapshot(self) -> Dict[str, Any]:
        """Compact dict for a telemetry event: nonzero buckets only (the
        JSONL stays small) + enough layout info to reconstruct/merge."""
        nz = np.nonzero(self.counts)[0]
        return {"buckets": {int(i): int(self.counts[i]) for i in nz},
                "sum": float(self.sum), "count": int(self.count),
                "n_edges": len(self.edges)}

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any]) -> "StreamingHistogram":
        h = cls()
        if int(snap.get("n_edges", len(h.edges))) != len(h.edges):
            raise ValueError("histogram snapshot has a different bucket "
                             "layout than this build")
        for i, c in (snap.get("buckets") or {}).items():
            h.counts[int(i)] = int(c)
        h.sum = float(snap.get("sum", 0.0))
        h.count = int(snap.get("count", 0))
        return h

    def prom_lines(self, name: str, help_: str) -> List[str]:
        """Render as a real Prometheus histogram series: cumulative
        `_bucket{le="..."}` per edge, `+Inf`, `_sum`, `_count`."""
        lines = [f"# HELP {name} {help_}", f"# TYPE {name} histogram"]
        cum = 0
        for i, edge in enumerate(self.edges):
            cum += int(self.counts[i])
            lines.append(f'{name}_bucket{{le="{edge:.6g}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {self.count}')
        lines.append(f"{name}_sum {self.sum:.9g}")
        lines.append(f"{name}_count {self.count}")
        return lines


# --------------------------------------------------------- terminal schema
# The unified terminal-event field set every serve/request_{done,shed,
# failed} event carries (the SLO tracker never special-cases an outcome).
TERMINAL_FIELDS = ("rid", "priority", "outcome", "outcome_reason",
                   "queue_wait_s", "ttft_s", "per_token_s", "tokens_in",
                   "tokens_out", "kv_pages", "total_s")


def terminal_record(req, now_s: float, kv_pages: int,
                    reason: str) -> Dict[str, Any]:
    """The unified terminal record for any outcome, derived purely from
    fields the scheduler already fills — no tracer required, so the
    schema holds even under --no-serve-reqtrace. per_token_s is the
    post-first-token decode average (None below 2 tokens)."""
    tokens_out = len(req.tokens)
    total_s = max(0.0, now_s - req.arrival_s)
    queue_wait_s = (req.admit_s - req.arrival_s
                    if getattr(req, "admit_s", None) is not None
                    else total_s)
    per_token_s = None
    if req.ttft_s is not None and tokens_out >= 2:
        per_token_s = max(0.0, total_s - req.ttft_s) / (tokens_out - 1)
    return {"rid": req.rid, "priority": req.priority,
            "outcome": req.outcome, "outcome_reason": reason,
            "queue_wait_s": max(0.0, queue_wait_s),
            "ttft_s": req.ttft_s, "per_token_s": per_token_s,
            "tokens_in": len(req.prompt), "tokens_out": tokens_out,
            "kv_pages": int(kv_pages), "total_s": total_s}


# ---------------------------------------------------------------- tracer
class RequestTracer:
    """Per-request lifecycle tracing for the continuous-batching loop.

    Timestamps are SCHEDULER-relative seconds (offsets from run()'s t0
    perf_counter origin) — exactly the values the scheduler already
    takes at its sync points; `begin()` anchors that domain onto the
    telemetry clock so emitted spans land on the shared timeline."""

    def __init__(self, ring: int = 512):
        self.hists: Dict[str, StreamingHistogram] = {
            m: StreamingHistogram() for m in HIST_METRICS}
        self.ring: "deque[Dict[str, Any]]" = deque(maxlen=max(1, int(ring)))
        self._live: Dict[int, Dict[str, Any]] = {}
        self._base_us: Optional[float] = None

    # ------------------------------------------------------------ plumbing
    def begin(self, t0_perf: float) -> None:
        """Anchor the scheduler's clock (t0 = its perf_counter origin)
        onto the telemetry us domain."""
        self._base_us = tel.now_us() - (time.perf_counter() - t0_perf) * 1e6

    def _to_us(self, offset_s: float) -> float:
        if self._base_us is None:  # direct unit-test use without run()
            self._base_us = tel.now_us() - offset_s * 1e6
        return self._base_us + offset_s * 1e6

    # -------------------------------------------------------------- stages
    def on_submit(self, req, now_s: float) -> None:
        self._live[req.rid] = {
            "rid": req.rid, "priority": req.priority,
            "arrival_s": req.arrival_s, "tokens_in": len(req.prompt),
            "slot": None, "cursor": min(req.arrival_s, now_s),
            "stages": [], "swaps": []}

    def stage(self, req, name: str, end_s: float, **extra: Any) -> None:
        """Close one stage span for `req`: [previous stage end, end_s].
        The cursor discipline makes stages tile the request's wall."""
        tr = self._live.get(req.rid)
        if tr is None:
            return
        start = tr["cursor"]
        end = max(start, end_s)
        tr["stages"].append({"stage": name, "start_s": start, "end_s": end,
                             **extra})
        tr["cursor"] = end
        if tel.enabled():
            slot = tr["slot"]
            tel.record(f"serve/req/{name}", self._to_us(start),
                       self._to_us(end), cat="serve",
                       tid=("queue" if slot is None else f"slot{slot}"),
                       rid=req.rid, **extra)

    def on_admit(self, req, t_pre_s: float, t_first_s: float,
                 wave: int) -> None:
        """Queue stage closes at prefill dispatch; the prefill stage spans
        dispatch -> first-token materialization (the TTFT sync)."""
        tr = self._live.get(req.rid)
        if tr is None:
            return
        self.stage(req, "queue", t_pre_s)
        tr["slot"] = req.slot
        self.stage(req, "prefill", t_first_s, wave=wave,
                   prompt_tokens=len(req.prompt))
        self.hists["queue_wait"].add(max(0.0, t_pre_s - tr["arrival_s"]))
        self.hists["prefill"].add(max(0.0, t_first_s - t_pre_s))
        if req.ttft_s is not None:
            self.hists["ttft"].add(max(0.0, req.ttft_s))

    def on_decode_window(self, active_reqs: Sequence[Any], end_s: float,
                         steps: int, per_step_s: float,
                         tokens_kept: Dict[int, int]) -> None:
        """One materialized dispatch window, attributed to every slot that
        was active in it."""
        self.hists["decode_step"].add(per_step_s, n=max(1, steps))
        for req in active_reqs:
            self.stage(req, "decode", end_s, steps=steps,
                       tokens=tokens_kept.get(req.slot, steps))

    def on_spec_round(self, req, end_s: float, drafted: int, committed: int,
                      rejected: int) -> None:
        self.stage(req, "spec", end_s, drafted=drafted, committed=committed,
                   rejected=rejected)

    def on_swap(self, active_reqs: Sequence[Any], now_s: float,
                version: Optional[int]) -> None:
        """A param swap landed between windows: charge the swap wall to a
        'swap' stage on every in-flight request's timeline."""
        for req in active_reqs:
            tr = self._live.get(req.rid)
            if tr is None:
                continue
            tr["swaps"].append(version)
            self.stage(req, "swap", now_s, version=version)

    # ------------------------------------------------------------ terminal
    def on_terminal(self, req, now_s: float,
                    record: Dict[str, Any]) -> Dict[str, Any]:
        """Finalize a request: close the residual span (host bookkeeping
        between the last sync point and the terminal decision), move the
        trace to the ring, and feed the per-request histograms. Returns
        the finished trace."""
        tr = self._live.pop(req.rid, None)
        if tr is None:
            tr = {"rid": req.rid, "priority": req.priority,
                  "arrival_s": req.arrival_s, "tokens_in": len(req.prompt),
                  "slot": None, "cursor": req.arrival_s, "stages": [],
                  "swaps": []}
        if now_s > tr["cursor"]:
            # sheds spent their whole life queueing; anything slot-bound
            # was in (a failing) decode since the last materialization
            self.stage_tr(tr, req,
                          "queue" if tr["slot"] is None else "decode",
                          now_s)
        wall = max(0.0, now_s - tr["arrival_s"])
        accounted = sum(s["end_s"] - s["start_s"] for s in tr["stages"])
        tr.update(record)
        tr["wall_s"] = wall
        tr["accounted_s"] = accounted
        tr["accounted_frac"] = (accounted / wall) if wall > 0 else 1.0
        self.ring.append(tr)
        if record.get("per_token_s") is not None:
            self.hists["per_token"].add(record["per_token_s"])
        if tr["slot"] is None and record.get("outcome") != "done":
            # shed before admission: its wait still belongs in the
            # queue-wait distribution the SLO shed estimator reads
            self.hists["queue_wait"].add(record.get("queue_wait_s") or 0.0)
        return tr

    def stage_tr(self, tr: Dict[str, Any], req, name: str,
                 end_s: float) -> None:
        """stage() against an already-popped trace dict."""
        self._live[req.rid] = tr
        self.stage(req, name, end_s)
        self._live.pop(req.rid, None)

    # -------------------------------------------------------------- queries
    def get(self, rid: int) -> Optional[Dict[str, Any]]:
        """Live query: an in-flight or recently finished request's trace."""
        if rid in self._live:
            return self._live[rid]
        for tr in reversed(self.ring):
            if tr["rid"] == rid:
                return tr
        return None

    def min_accounted_frac(self) -> Optional[float]:
        fracs = [tr["accounted_frac"] for tr in self.ring
                 if tr.get("wall_s", 0.0) > 0.0]
        return min(fracs) if fracs else None

    def emit_hists(self) -> None:
        """Publish every histogram into the telemetry stream (one
        `serve/hist` event per metric). monitor.gather MERGES these
        across segments/processes — fixed edges make that exact."""
        if not tel.enabled():
            return
        for metric, h in self.hists.items():
            if h.count:
                tel.event("serve/hist", cat="serve", metric=metric,
                          **h.snapshot())
