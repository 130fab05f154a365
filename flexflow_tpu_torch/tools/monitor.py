"""Live run-health monitor (counterpart: tools/monitor.py): tail a
--telemetry-dir into a refreshing terminal dashboard — goodput bar +
bucket breakdown (health/goodput events from flexflow_tpu_torch/health.py),
a step-time sparkline (fit/dispatch or pipe/update spans), numerics-sentinel
status (health/nonfinite, health/grad_spike, health/loss_spike), memory
watermarks (health/hbm: on the card the CUDA caching allocator's peak, as
health.py samples it), and any fault/error events.

Usage:
    python -m flexflow_tpu_torch.tools.monitor <telemetry-dir>
        [--refresh 2.0] [--once] [--iterations N] [--prom-file node.prom]
        [--twin-report twin.json] [--json]
    python -m flexflow_tpu_torch.tools.monitor --check [--device cpu]

`--check` runs a small fit on the card (or on `--device cpu`) with
telemetry on and renders the dashboard and the export.

--prom-file additionally writes a Prometheus textfile-collector export
(atomic rename, so node_exporter never reads a torn file) on every
refresh — the bridge from the local JSONL stream to a real alerting
stack without running a server in the training process.

The monitor is read-only and tail-safe: it re-reads the directory each
refresh (telemetry.read_events merges rotated telemetry-*.jsonl segments
and skips a crashed writer's torn tail), so it can watch a run that is
still writing, already finished, or restarting under the elastic
supervisor.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

SPARK = "▁▂▃▄▅▆▇█"
STEP_SPAN_NAMES = ("fit/dispatch", "pipe/update")


def load_events(path: str) -> List[Dict[str, Any]]:
    from flexflow_tpu_torch.telemetry import read_events

    return read_events(path)


# ------------------------------------------------------------------- gather
def gather(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the raw event stream into the dashboard's state dict (pure —
    tests feed synthetic events)."""
    goodputs: List[Dict[str, Any]] = []
    steps_ms: List[float] = []
    sent = {"nonfinite": 0, "grad_spike": 0, "loss_spike": 0}
    last_nonfinite: Optional[Dict[str, Any]] = None
    hbm: Dict[str, Dict[str, Any]] = {}
    halts: List[Dict[str, Any]] = []
    faults = 0
    errors = 0
    # serving (flexflow_tpu_torch/serving): decode-step span durations,
    # finished requests (tokens + ttft for the panel quantiles), live
    # slot/queue counter samples, and the ts window tokens/s is computed
    # over
    serve = {"decode_ms": [], "done": [], "prefills": 0,
             "active_slots": None, "queue_depth": None,
             "ts_first": None, "ts_last": None,
             # hot-swap + degradation stream
             "swap_ms": [], "active_version": None, "rollbacks": 0,
             "shed": 0, "failed": 0, "evicted": 0, "retries": 0,
             # speculative decoding + KV quantization stream
             "spec_drafted": 0, "spec_accepted": 0, "spec_accept_ema": None,
             "kv_dtype": None, "spec_tokens": 0,
             # streaming latency histograms (serve/hist
             # snapshots — merged across segments/processes by
             # _merged_hists) + the last SLO scoreboard
             "hist_snaps": [], "slo": None,
             # tiered KV cache counters (latest sample wins —
             # the scheduler re-emits at every rotation sync point)
             "kv_hot_pages": None, "kv_cold_pages": None,
             "kv_prefetch_hits": 0, "kv_prefetch_stalls": 0, "kv_spills": 0,
             # disaggregated fleet — per-replica scoreboard rows
             # (latest serve/fleet_replica per index wins), the fleet-wide
             # summary, and the rolling-rollout action counters
             "fleet_replicas": {}, "fleet": None,
             "fleet_rollout_swaps": 0, "fleet_rollout_rollbacks": 0}
    for ev in events:
        name = ev.get("name", "")
        args = ev.get("args") or {}
        if name.startswith("serve/"):
            serve["ts_first"] = (ev.get("ts") if serve["ts_first"] is None
                                 else serve["ts_first"])
            serve["ts_last"] = ev.get("ts", serve["ts_last"])
        if name == "health/goodput":
            goodputs.append(args)
        elif name in STEP_SPAN_NAMES and ev.get("ph") == "X":
            steps_ms.append(float(ev.get("dur", 0.0)) / 1e3)
        elif name == "serve/decode_step" and ev.get("ph") == "X":
            serve["decode_ms"].append(float(ev.get("dur", 0.0)) / 1e3)
        elif name == "serve/prefill" and ev.get("ph") == "X":
            serve["prefills"] += 1
        elif name == "serve/request_done":
            serve["done"].append(args)
        elif name == "serve/param_swap" and ev.get("ph") == "X":
            serve["swap_ms"].append(float(ev.get("dur", 0.0)) / 1e3)
            if args.get("version") is not None:
                serve["active_version"] = args.get("version")
        elif name == "serve/version":
            # rollbacks counted HERE only: a disk-reload rollback emits
            # both a param_swap span and a version event — one increment
            serve["active_version"] = args.get("version",
                                               serve["active_version"])
            if args.get("rollback"):
                serve["rollbacks"] += 1
        elif name == "serve/request_shed":
            serve["shed"] += 1
        elif name == "serve/request_failed":
            serve["failed"] += 1
        elif name == "serve/slot_evicted":
            serve["evicted"] += 1
        elif name == "retry" and str(args.get("site", "")).startswith("serve/"):
            serve["retries"] += 1
        elif name == "serve/active_slots":
            serve["active_slots"] = args.get("value")
        elif name == "serve/queue_depth":
            serve["queue_depth"] = args.get("value")
        elif name == "serve/spec_drafted_tokens":
            serve["spec_drafted"] = int(args.get("value") or 0)
        elif name == "serve/spec_accepted_tokens":
            serve["spec_accepted"] = int(args.get("value") or 0)
        elif name == "serve/spec_accept_rate":
            serve["spec_accept_ema"] = args.get("value")
        elif name == "serve/engine":
            serve["kv_dtype"] = args.get("kv_dtype", serve["kv_dtype"])
            serve["spec_tokens"] = int(args.get("spec_tokens") or 0)
        elif name == "serve/kv_tier_hot_pages":
            serve["kv_hot_pages"] = int(args.get("value") or 0)
        elif name == "serve/kv_tier_cold_pages":
            serve["kv_cold_pages"] = int(args.get("value") or 0)
        elif name == "serve/kv_prefetch_hits":
            serve["kv_prefetch_hits"] = int(args.get("value") or 0)
        elif name == "serve/kv_prefetch_stalls":
            serve["kv_prefetch_stalls"] = int(args.get("value") or 0)
        elif name == "serve/kv_spills":
            serve["kv_spills"] = int(args.get("value") or 0)
        elif name == "serve/fleet_replica":
            serve["fleet_replicas"][int(args.get("replica") or 0)] = args
        elif name == "serve/fleet":
            serve["fleet"] = args
        elif name == "serve/fleet_rollout":
            if args.get("action") == "rollback":
                serve["fleet_rollout_rollbacks"] += 1
            else:
                serve["fleet_rollout_swaps"] += 1
        elif name == "serve/hist":
            serve["hist_snaps"].append(args)
        elif name == "serve/slo":
            serve["slo"] = args.get("report") or serve["slo"]
        elif name == "health/nonfinite":
            sent["nonfinite"] += 1
            last_nonfinite = args
        elif name == "health/grad_spike":
            sent["grad_spike"] += 1
        elif name == "health/loss_spike":
            sent["loss_spike"] += 1
        elif name == "health/hbm":
            hbm[str(args.get("tag", "?"))] = args
        elif name == "health/halt":
            halts.append(args)
        elif name == "fault/injected":
            faults += 1
        if ev.get("cat") == "error":
            errors += 1
    return {"goodputs": goodputs, "steps_ms": steps_ms,
            "sentinels": sent, "last_nonfinite": last_nonfinite,
            "hbm": hbm, "halts": halts, "faults": faults,
            "errors": errors, "events": len(events), "serve": serve}


# ------------------------------------------------------------------- render
def load_twin(path: Optional[str]) -> Optional[Dict[str, Any]]:
    """Read a twin tool's report (--twin-out) for the twin panel;
    tolerant of a missing/partial file (the twin may be re-running)."""
    if not path:
        return None
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return None
    return d if isinstance(d, dict) and d.get("stats") else None


def _bar(frac: float, width: int = 30) -> str:
    frac = max(0.0, min(1.0, frac))
    n = int(round(frac * width))
    return "[" + "#" * n + "." * (width - n) + "]"


def sparkline(values: List[float], width: int = 48) -> str:
    vals = values[-width:]
    if not vals:
        return "(no steps yet)"
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(SPARK[int((v - lo) / span * (len(SPARK) - 1))]
                   for v in vals)


def _pq(xs: List[float], q: float) -> float:
    """Nearest-rank quantile (no numpy dependency in the render path)."""
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))]


def _merged_hists(serve: Dict[str, Any]) -> Dict[str, Any]:
    """Merge every serve/hist snapshot in the stream into one histogram
    per metric (fixed shared buckets make the merge exact across
    segments, processes, and bench legs). Lazy import keeps the pure
    gather path dependency-free for synthetic-stream tests."""
    snaps = serve.get("hist_snaps") or []
    if not snaps:
        return {}
    from flexflow_tpu_torch.serving.reqtrace import StreamingHistogram

    out: Dict[str, Any] = {}
    for s in snaps:
        metric = s.get("metric")
        if not metric:
            continue
        try:
            h = StreamingHistogram.from_snapshot(s)
        except (ValueError, TypeError):
            continue
        if metric in out:
            out[metric].merge(h)
        else:
            out[metric] = h
    return out


def _serve_stats(serve: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Fold the gathered serve/* stream into the panel's numbers; None
    when the run has no serving activity (panel stays hidden)."""
    if not (serve["done"] or serve["decode_ms"] or serve["prefills"]
            or serve.get("hist_snaps")):
        return None
    tokens = sum(int(d.get("tokens", 0)) for d in serve["done"])
    span_s = 0.0
    if serve["ts_first"] is not None and serve["ts_last"] is not None:
        span_s = max(0.0, (serve["ts_last"] - serve["ts_first"]) / 1e6)
    ttfts = [float(d["ttft_s"]) for d in serve["done"]
             if d.get("ttft_s") is not None]
    # when the stream carries live histograms they are THE source of truth
    # for latency quantiles (a serving bench reads the same histograms, so
    # the two can never disagree); the done-event/span recompute is only
    # the fallback for streams without serve/hist snapshots
    hists = _merged_hists(serve)
    th, sh = hists.get("ttft"), hists.get("decode_step")
    return {
        "hists": hists,
        "slo": serve.get("slo"),
        "requests_done": len(serve["done"]),
        "tokens": tokens,
        "tokens_per_s": tokens / span_s if span_s > 0 else 0.0,
        "ttft_p50_s": (th.quantile(0.5) if th is not None and th.count
                       else (_pq(ttfts, 0.5) if ttfts else None)),
        "ttft_p99_s": (th.quantile(0.99) if th is not None and th.count
                       else (_pq(ttfts, 0.99) if ttfts else None)),
        "decode_p50_ms": (sh.quantile(0.5) * 1e3
                          if sh is not None and sh.count else
                          (_pq(serve["decode_ms"], 0.5)
                           if serve["decode_ms"] else None)),
        "decode_p99_ms": (sh.quantile(0.99) * 1e3
                          if sh is not None and sh.count else
                          (_pq(serve["decode_ms"], 0.99)
                           if serve["decode_ms"] else None)),
        "active_slots": serve["active_slots"],
        "queue_depth": serve["queue_depth"],
        "shed": serve.get("shed", 0),
        "failed": serve.get("failed", 0),
        "evicted": serve.get("evicted", 0),
        "serve_retries": serve.get("retries", 0),
        "swaps": len(serve.get("swap_ms", [])),
        "swap_p99_ms": (_pq(serve["swap_ms"], 0.99)
                        if serve.get("swap_ms") else None),
        "active_version": serve.get("active_version"),
        "rollbacks": serve.get("rollbacks", 0),
        "spec_drafted": serve.get("spec_drafted", 0),
        "spec_accepted": serve.get("spec_accepted", 0),
        "spec_accept_rate": (
            serve.get("spec_accept_ema") if serve.get("spec_accept_ema")
            is not None else
            (serve.get("spec_accepted", 0) / serve["spec_drafted"]
             if serve.get("spec_drafted") else None)),
        "spec_tokens": serve.get("spec_tokens", 0),
        "kv_dtype": serve.get("kv_dtype"),
        "kv_hot_pages": serve.get("kv_hot_pages"),
        "kv_cold_pages": serve.get("kv_cold_pages"),
        "kv_prefetch_hits": serve.get("kv_prefetch_hits", 0),
        "kv_prefetch_stalls": serve.get("kv_prefetch_stalls", 0),
        "kv_spills": serve.get("kv_spills", 0),
        "kv_prefetch_hit_rate": (
            serve.get("kv_prefetch_hits", 0)
            / (serve.get("kv_prefetch_hits", 0)
               + serve.get("kv_prefetch_stalls", 0))
            if (serve.get("kv_prefetch_hits", 0)
                + serve.get("kv_prefetch_stalls", 0)) else None),
        "fleet": serve.get("fleet"),
        "fleet_replicas": serve.get("fleet_replicas") or {},
        "fleet_rollout_swaps": serve.get("fleet_rollout_swaps", 0),
        "fleet_rollout_rollbacks": serve.get("fleet_rollout_rollbacks", 0),
    }


def render(state: Dict[str, Any]) -> List[str]:
    lines = [f"flexflow_tpu_torch run monitor — {state['events']} events"]
    gps = state["goodputs"]
    if gps:
        last = gps[-1]
        gp = float(last.get("goodput", 0.0))
        lines.append(f"goodput  {_bar(gp)} {100.0 * gp:5.1f}%  "
                     f"(epoch {last.get('epoch')}, "
                     f"wall {float(last.get('wall_s', 0.0)):.2f}s, "
                     f"residual {float(last.get('residual_s', 0.0)):.3f}s)")
        buckets = {k[:-2]: float(v) for k, v in last.items()
                   if k.endswith("_s") and k not in
                   ("wall_s", "residual_s")}
        wall = float(last.get("wall_s", 0.0)) or 1e-12
        parts = " ".join(f"{k}={100.0 * v / wall:.1f}%" for k, v in
                         sorted(buckets.items(), key=lambda kv: -kv[1])
                         if v > 0.0)
        lines.append(f"buckets  {parts or '(none)'}")
        if len(gps) > 1:
            lines.append("epochs   " + " ".join(
                f"{100.0 * float(g.get('goodput', 0.0)):.0f}%"
                for g in gps[-12:]))
    else:
        lines.append("goodput  (no health/goodput events yet — epoch in "
                     "progress or health disabled)")
    steps = state["steps_ms"]
    if steps:
        tail = steps[-48:]
        lines.append(f"steps    {sparkline(steps)}  "
                     f"last={tail[-1]:.1f}ms "
                     f"min={min(tail):.1f} max={max(tail):.1f} "
                     f"(n={len(steps)})")
    sv = _serve_stats(state.get("serve") or
                      {"done": [], "decode_ms": [], "prefills": 0})
    if sv:
        def f(v, fmt):
            return (fmt % v) if v is not None else "-"
        lines.append(
            f"serving  {sv['tokens_per_s']:.1f} tok/s "
            f"({sv['requests_done']} reqs, {sv['tokens']} tokens)  "
            f"ttft p50/p99 {f(sv['ttft_p50_s'], '%.3fs')}/"
            f"{f(sv['ttft_p99_s'], '%.3fs')}  "
            f"step p50/p99 {f(sv['decode_p50_ms'], '%.1fms')}/"
            f"{f(sv['decode_p99_ms'], '%.1fms')}")
        lines.append(
            f"         active_slots={f(sv['active_slots'], '%g')} "
            f"queue={f(sv['queue_depth'], '%g')} "
            f"shed={sv['shed']} failed={sv['failed']} "
            f"evicted={sv['evicted']} retries={sv['serve_retries']}")
        if sv["swaps"] or sv["rollbacks"] or sv["active_version"] is not None:
            lines.append(
                f"         params v{f(sv['active_version'], '%g')}  "
                f"swaps={sv['swaps']} rollbacks={sv['rollbacks']} "
                f"swap p99 {f(sv['swap_p99_ms'], '%.1fms')}")
        if sv["spec_drafted"] or sv["kv_dtype"]:
            rate = sv["spec_accept_rate"]
            lines.append(
                f"         spec K={sv['spec_tokens']} "
                f"drafted={sv['spec_drafted']} "
                f"accepted={sv['spec_accepted']} "
                f"accept_ema={f(rate, '%.2f')}  "
                f"kv_dtype={sv['kv_dtype'] or '-'}")
        if sv["kv_hot_pages"] is not None or sv["kv_spills"]:
            # tiered KV cache — occupancy + prefetch efficiency
            lines.append(
                f"kv tier  hot={f(sv['kv_hot_pages'], '%g')} "
                f"cold={f(sv['kv_cold_pages'], '%g')} pages  "
                f"spills={sv['kv_spills']} "
                f"prefetch hit/stall={sv['kv_prefetch_hits']}/"
                f"{sv['kv_prefetch_stalls']} "
                f"(hit rate {f(sv['kv_prefetch_hit_rate'], '%.2f')})")
        slo = sv.get("slo")
        if slo and slo.get("objectives"):
            # error-budget scoreboard — one compact line per
            # objective (budget left + the fastest-window burn rate)
            for name, ob in sorted(slo["objectives"].items()):
                burns = {k: v for k, v in ob.items()
                         if k.startswith("burn_rate_")}
                burn_txt = " ".join(
                    f"{k[len('burn_rate_'):]}={v:.2f}x"
                    for k, v in sorted(burns.items()))
                lines.append(
                    f"slo      {name}: budget "
                    f"{100.0 * float(ob.get('budget_remaining', 0.0)):.1f}% "
                    f"left  bad {ob.get('bad', 0)}/{ob.get('total', 0)}  "
                    f"burn {burn_txt or '-'}")
            lines.append(
                f"         requests={slo.get('requests', 0)} "
                f"shed_rate={100.0 * float(slo.get('shed_rate', 0.0)):.1f}% "
                f"worst_burn={float(slo.get('worst_burn_rate', 0.0)):.2f}x")
        fl = sv.get("fleet")
        reps = sv.get("fleet_replicas") or {}
        if fl or reps:
            # disaggregated fleet — one summary line + one line
            # per replica (role, throughput, live occupancy, live version)
            if fl:
                lines.append(
                    f"fleet    {fl.get('replicas', len(reps))} replicas "
                    f"({fl.get('topology', '?')})  "
                    f"{float(fl.get('tokens_per_s', 0.0)):.1f} tok/s  "
                    f"done={fl.get('completed', 0)} "
                    f"shed={fl.get('shed', 0)} "
                    f"handoffs={fl.get('handoffs', 0)}  "
                    f"rollout swaps={sv['fleet_rollout_swaps']} "
                    f"rollbacks={sv['fleet_rollout_rollbacks']}")
            for idx in sorted(reps):
                r = reps[idx]
                lines.append(
                    f"         r{idx} [{r.get('role', '?'):>8}] "
                    f"{float(r.get('tokens_per_s', 0.0)):6.1f} tok/s  "
                    f"done={r.get('completed', 0)} "
                    f"assigned={r.get('assigned', 0)} "
                    f"slots={r.get('active_slots', 0)} "
                    f"queue={r.get('queue_depth', 0)} "
                    f"v{r.get('swap_version') if r.get('swap_version') is not None else '-'}")
    tw = state.get("twin")
    if tw:
        # capacity-twin panel — what the replayed trace says
        # about this config, plus the burn-driven scaling recommendation
        # and the replicas -> capacity curve from twin bisection
        st = tw.get("stats") or {}
        ttft = ((tw.get("hists") or {}).get("ttft") or {}).get("p99")
        lines.append(
            f"twin     {st.get('replicas', '?')} replicas "
            f"({st.get('topology', '?')}, priced {tw.get('priced_by', '?')})"
            f"  {float(st.get('tokens_per_s', 0.0)):.1f} tok/s"
            + (f"  ttft p99 {ttft:.3f}s" if ttft is not None else ""))
        lines.append(
            f"         replayed {st.get('requests', 0)} reqs: "
            f"done={st.get('completed', 0)} shed={st.get('shed', 0)} "
            f"handoffs={st.get('handoffs', 0)} "
            f"wall {float(st.get('wall_s', 0.0)):.1f}s (virtual)")
        sc = tw.get("scaling") or {}
        if sc.get("action"):
            bud = sc.get("budget_remaining")
            lines.append(
                f"         scaling: {sc['action']}"
                + (f" [{sc.get('objective')}]" if sc.get("objective")
                   else "")
                + (f" budget={100.0 * bud:.1f}%" if bud is not None else "")
                + f" — {sc.get('reason', '')}")
        curve = tw.get("capacity_curve") or []
        if curve:
            lines.append("capacity " + "  ".join(
                f"{c['replicas']}r={float(c['capacity_rps']):.1f}rps"
                for c in curve))
    sent = state["sentinels"]
    bad = sent["nonfinite"] or state["halts"]
    status = "FATAL" if bad else (
        "WARN" if sent["grad_spike"] or sent["loss_spike"] else "OK")
    lines.append(f"numerics {status}: nonfinite={sent['nonfinite']} "
                 f"grad_spikes={sent['grad_spike']} "
                 f"loss_spikes={sent['loss_spike']}")
    if state["last_nonfinite"]:
        lines.append(f"         last nonfinite: {state['last_nonfinite']}")
    for h in state["halts"][-2:]:
        lines.append(f"         HALTED at step {h.get('step')}; recovery "
                     f"checkpoint: {h.get('checkpoint') or '(none)'}")
    mb = 1024 * 1024
    for tag, s in list(state["hbm"].items())[-3:]:
        lines.append(f"hbm      {tag}: peak "
                     f"{float(s.get('peak_bytes', 0)) / mb:.2f}MB/device "
                     f"live {float(s.get('live_bytes', 0)) / mb:.2f}MB "
                     f"({s.get('devices')} devices)")
    if state["faults"] or state["errors"]:
        lines.append(f"faults   injected={state['faults']} "
                     f"error_events={state['errors']}")
    return lines


# --------------------------------------------------------------- prometheus
def prom_export(state: Dict[str, Any], path: str) -> None:
    """Textfile-collector export: write gauges to <path> atomically."""
    g: List[str] = []

    def gauge(name: str, value: float, help_: str) -> None:
        g.append(f"# HELP {name} {help_}")
        g.append(f"# TYPE {name} gauge")
        g.append(f"{name} {value:g}")

    gps = state["goodputs"]
    if gps:
        last = gps[-1]
        gauge("flexflow_goodput_ratio", float(last.get("goodput", 0.0)),
              "Goodput fraction of the last closed epoch")
        gauge("flexflow_goodput_residual_seconds",
              float(last.get("residual_s", 0.0)),
              "Unattributed wall-clock of the last closed epoch")
        gauge("flexflow_epoch_wall_seconds",
              float(last.get("wall_s", 0.0)),
              "Wall-clock of the last closed epoch")
    gauge("flexflow_epochs_total", float(len(gps)),
          "Closed fit epochs observed in the telemetry stream")
    if state["steps_ms"]:
        gauge("flexflow_step_time_seconds",
              state["steps_ms"][-1] / 1e3,
              "Duration of the last observed step dispatch/update span")
    sent = state["sentinels"]
    gauge("flexflow_nonfinite_windows_total", float(sent["nonfinite"]),
          "Sentinel windows with non-finite loss/grad")
    gauge("flexflow_grad_spikes_total", float(sent["grad_spike"]),
          "Grad-norm spike warnings")
    gauge("flexflow_loss_spikes_total", float(sent["loss_spike"]),
          "Loss spike warnings")
    gauge("flexflow_run_halts_total", float(len(state["halts"])),
          "Fatal health halts (health/halt events)")
    peak = max((float(s.get("peak_bytes", 0))
                for s in state["hbm"].values()), default=0.0)
    gauge("flexflow_hbm_peak_bytes", peak,
          "Max per-device peak memory across watermark samples")
    gauge("flexflow_error_events_total", float(state["errors"]),
          "Events in the reserved error category")
    sv = _serve_stats(state.get("serve") or
                      {"done": [], "decode_ms": [], "prefills": 0})
    if sv:
        gauge("flexflow_serve_tokens_per_second", sv["tokens_per_s"],
              "Serving throughput over the telemetry window")
        gauge("flexflow_serve_requests_done_total",
              float(sv["requests_done"]),
              "Completed serving requests in the telemetry stream")
        if sv["ttft_p99_s"] is not None:
            gauge("flexflow_serve_ttft_p99_seconds", sv["ttft_p99_s"],
                  "p99 time-to-first-token of completed requests")
        if sv["decode_p99_ms"] is not None:
            gauge("flexflow_serve_decode_step_p99_seconds",
                  sv["decode_p99_ms"] / 1e3,
                  "p99 decode-step span duration")
        if sv["active_slots"] is not None:
            gauge("flexflow_serve_active_slots",
                  float(sv["active_slots"]),
                  "Occupied decode slots at the last counter sample")
        gauge("flexflow_serve_shed_total", float(sv["shed"]),
              "Requests shed by SLO-aware admission control")
        gauge("flexflow_serve_failed_total", float(sv["failed"]),
              "Requests failed/evicted by faults or watchdog timeouts")
        gauge("flexflow_serve_evictions_total", float(sv["evicted"]),
              "Decode slots force-evicted (wedged or timed out)")
        gauge("flexflow_serve_retries_total", float(sv["serve_retries"]),
              "Transient serve/* faults absorbed by retry")
        gauge("flexflow_serve_swaps_total", float(sv["swaps"]),
              "Live parameter hot-swaps completed")
        gauge("flexflow_serve_rollbacks_total", float(sv["rollbacks"]),
              "Parameter rollbacks to a retained version")
        if sv["active_version"] is not None:
            gauge("flexflow_serve_active_version",
                  float(sv["active_version"]),
                  "Checkpoint step of the live parameter version")
        if sv["swap_p99_ms"] is not None:
            gauge("flexflow_serve_swap_p99_seconds",
                  sv["swap_p99_ms"] / 1e3,
                  "p99 hot-swap latency (read+validate+place+flip)")
        gauge("flexflow_serve_spec_drafted_tokens_total",
              float(sv["spec_drafted"]),
              "Draft tokens proposed by the speculative decoder")
        gauge("flexflow_serve_spec_accepted_tokens_total",
              float(sv["spec_accepted"]),
              "Draft tokens accepted by the target verify pass")
        if sv["spec_accept_rate"] is not None:
            gauge("flexflow_serve_spec_accept_rate",
                  float(sv["spec_accept_rate"]),
                  "EMA of the per-round draft acceptance rate")
        if sv["kv_hot_pages"] is not None or sv["kv_spills"]:
            # tiered KV cache gauges
            gauge("flexflow_serve_kv_tier_hot_pages",
                  float(sv["kv_hot_pages"] or 0),
                  "Allocated HBM-tier KV pages (latest sample)")
            gauge("flexflow_serve_kv_tier_cold_pages",
                  float(sv["kv_cold_pages"] or 0),
                  "Allocated host-tier KV pages (latest sample)")
            gauge("flexflow_serve_kv_tier_spills_total",
                  float(sv["kv_spills"]),
                  "Slot spills HBM -> host tier")
            gauge("flexflow_serve_kv_prefetch_stalls_total",
                  float(sv["kv_prefetch_stalls"]),
                  "Slot rejoins whose host->HBM prefetch lacked lead")
            if sv["kv_prefetch_hit_rate"] is not None:
                gauge("flexflow_serve_kv_prefetch_hit_rate",
                      float(sv["kv_prefetch_hit_rate"]),
                      "Prefetch hits / (hits + stalls)")
        if sv["kv_dtype"] is not None:
            # dtype rides as a label on a constant-1 gauge (the textfile
            # collector has no string metrics)
            g.append("# HELP flexflow_serve_kv_cache_dtype_info "
                     "KV-cache storage dtype of the serving engine")
            g.append("# TYPE flexflow_serve_kv_cache_dtype_info gauge")
            g.append('flexflow_serve_kv_cache_dtype_info{dtype="%s"} 1'
                     % sv["kv_dtype"])
        # live latency histograms as real Prometheus histogram
        # series (cumulative le buckets, mergeable across scrapes)
        _HIST_HELP = {
            "ttft": "Time to first token of admitted requests",
            "per_token": "Steady-state inter-token latency of completed "
                         "requests",
            "queue_wait": "Queue wait before admission (or until shed)",
            "prefill": "Chunked-prefill wave latency per admission",
            "decode_step": "Per-token decode/verify step latency",
        }
        for metric, h in sorted((sv.get("hists") or {}).items()):
            g.extend(h.prom_lines(
                f"flexflow_serve_{metric}_seconds",
                _HIST_HELP.get(metric, f"Serving {metric} latency")))
        slo = sv.get("slo")
        if slo and slo.get("objectives"):
            # per-objective error budgets as labeled gauges
            g.append("# HELP flexflow_serve_slo_budget_remaining "
                     "Remaining SLO error budget fraction per objective")
            g.append("# TYPE flexflow_serve_slo_budget_remaining gauge")
            for name, ob in sorted(slo["objectives"].items()):
                g.append(
                    'flexflow_serve_slo_budget_remaining{objective="%s"} %g'
                    % (name, float(ob.get("budget_remaining", 0.0))))
            g.append("# HELP flexflow_serve_slo_burn_rate "
                     "SLO error-budget burn rate per objective and window")
            g.append("# TYPE flexflow_serve_slo_burn_rate gauge")
            for name, ob in sorted(slo["objectives"].items()):
                for k, v in sorted(ob.items()):
                    if k.startswith("burn_rate_"):
                        g.append(
                            'flexflow_serve_slo_burn_rate{objective="%s",'
                            'window="%s"} %g'
                            % (name, k[len("burn_rate_"):], float(v)))
            gauge("flexflow_serve_slo_shed_rate",
                  float(slo.get("shed_rate", 0.0)),
                  "Fraction of terminal requests that did not complete")
            gauge("flexflow_serve_slo_worst_burn_rate",
                  float(slo.get("worst_burn_rate", 0.0)),
                  "Max burn rate across objectives and windows")
        fl = sv.get("fleet")
        reps = sv.get("fleet_replicas") or {}
        if fl or reps:
            # disaggregated fleet — per-replica series carry the
            # replica index (and role) as labels so one scrape covers the
            # whole fleet
            if fl:
                gauge("flexflow_fleet_replicas",
                      float(fl.get("replicas", len(reps))),
                      "Serving replicas in the fleet")
                gauge("flexflow_fleet_tokens_per_second",
                      float(fl.get("tokens_per_s", 0.0)),
                      "Aggregate fleet serving throughput")
                gauge("flexflow_fleet_handoffs_total",
                      float(fl.get("handoffs", 0)),
                      "Prefill->decode KV handoffs across the fleet")
            gauge("flexflow_fleet_rollout_swaps_total",
                  float(sv["fleet_rollout_swaps"]),
                  "Rolling-rollout replica swaps completed")
            gauge("flexflow_fleet_rollout_rollbacks_total",
                  float(sv["fleet_rollout_rollbacks"]),
                  "Rolling-rollout rollbacks (SLO burn during bake)")
            _FLEET_SERIES = [
                ("flexflow_fleet_replica_tokens_per_second", "tokens_per_s",
                 "Per-replica serving throughput"),
                ("flexflow_fleet_replica_completed_total", "completed",
                 "Per-replica completed requests"),
                ("flexflow_fleet_replica_assigned_total", "assigned",
                 "Per-replica requests routed by the fleet router"),
                ("flexflow_fleet_replica_active_slots", "active_slots",
                 "Per-replica occupied decode slots (last sample)"),
                ("flexflow_fleet_replica_queue_depth", "queue_depth",
                 "Per-replica waiting queue depth (last sample)"),
                ("flexflow_fleet_replica_swap_version", "swap_version",
                 "Per-replica live parameter version"),
            ]
            for name, key, help_ in _FLEET_SERIES:
                rows = [(idx, reps[idx]) for idx in sorted(reps)
                        if reps[idx].get(key) is not None]
                if not rows:
                    continue
                g.append(f"# HELP {name} {help_}")
                g.append(f"# TYPE {name} gauge")
                for idx, r in rows:
                    g.append('%s{replica="%d",role="%s"} %g'
                             % (name, idx, r.get("role", "?"),
                                float(r[key])))
    tw = state.get("twin")
    if tw:
        # capacity-twin gauges — the twin's replay verdict and
        # scaling recommendation, scrapeable next to the live series
        st = tw.get("stats") or {}
        gauge("flexflow_twin_replicas", float(st.get("replicas", 0)),
              "Replica count of the replayed twin scenario")
        gauge("flexflow_twin_tokens_per_second",
              float(st.get("tokens_per_s", 0.0)),
              "Twin-predicted serving throughput for the replayed trace")
        gauge("flexflow_twin_completed_total",
              float(st.get("completed", 0)),
              "Requests the twin replay completed")
        gauge("flexflow_twin_shed_total", float(st.get("shed", 0)),
              "Requests the twin replay shed")
        ttft = ((tw.get("hists") or {}).get("ttft") or {}).get("p99")
        if ttft is not None:
            gauge("flexflow_twin_ttft_p99_seconds", float(ttft),
                  "Twin-predicted TTFT p99 for the replayed trace")
        sc = tw.get("scaling") or {}
        if sc.get("budget_remaining") is not None:
            gauge("flexflow_twin_budget_remaining",
                  float(sc["budget_remaining"]),
                  "Worst remaining SLO error budget in the twin replay")
        if sc.get("worst_burn_rate") is not None:
            gauge("flexflow_twin_worst_burn_rate",
                  float(sc["worst_burn_rate"]),
                  "Worst SLO burn rate in the twin replay")
        if sc.get("action"):
            g.append("# HELP flexflow_twin_scaling_info Twin scaling "
                     "recommendation (action as label)")
            g.append("# TYPE flexflow_twin_scaling_info gauge")
            g.append('flexflow_twin_scaling_info{action="%s"} 1'
                     % sc["action"])
        curve = tw.get("capacity_curve") or []
        if curve:
            g.append("# HELP flexflow_twin_capacity_rps Max sustainable "
                     "offered load at SLO by twin bisection, per replica "
                     "count")
            g.append("# TYPE flexflow_twin_capacity_rps gauge")
            for c in curve:
                g.append('flexflow_twin_capacity_rps{replicas="%d"} %g'
                         % (int(c["replicas"]), float(c["capacity_rps"])))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(g) + "\n")
    os.replace(tmp, path)


# --------------------------------------------------------------------- main
def run_once(telemetry_dir: str, prom_file: Optional[str] = None,
             clear: bool = False,
             twin_report: Optional[str] = None) -> Dict[str, Any]:
    state = gather(load_events(telemetry_dir))
    state["twin"] = load_twin(twin_report)
    out = render(state)
    if clear:
        sys.stdout.write("\x1b[2J\x1b[H")
    print("\n".join(out))
    if prom_file:
        prom_export(state, prom_file)
    return state


def _check(device: str = "cuda") -> int:
    """Smoke: small fit with telemetry on `device` -> gather/render/prom."""
    import tempfile

    import numpy as np

    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.losses import LossType

    with tempfile.TemporaryDirectory() as td:
        tdir = os.path.join(td, "tel")
        cfg = FFConfig(batch_size=8, epochs=2, seed=0, telemetry_dir=tdir)
        m = FFModel(cfg)
        t = m.create_tensor([8, 16], name="x")
        m.dense(t, 4, name="head")
        cm = m.compile(SGDOptimizer(lr=0.05),
                       LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                       metrics=[], device=device)
        cm.init(seed=0)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(32, 16)).astype(np.float32)
        y = rng.integers(0, 4, size=(32,)).astype(np.int32)
        cm.fit(x, y, epochs=2, verbose=False)
        from flexflow_tpu_torch import telemetry as tel

        tel.shutdown()
        # a twin report feeds the twin panel + gauges
        from flexflow_tpu_torch.serving import tracefmt
        from flexflow_tpu_torch.serving.twin import (TwinCosts, TwinSpec,
                                                     simulate)

        trng = np.random.default_rng(0)
        recs = tracefmt.poisson_records(trng, 16, 10.0, 64, 4, 4)
        tspec = TwinSpec(replicas=2, slots=4, seq=16, page_size=4,
                         max_decode_len=4, slo="ttft_p99_ms=500")
        trep = simulate(recs, tspec,
                        TwinCosts.analytic(tspec.kv_spec())).report()
        trep["capacity_curve"] = [{"replicas": 1, "capacity_rps": 10.0},
                                  {"replicas": 2, "capacity_rps": 20.0}]
        twin_path = os.path.join(td, "twin.json")
        with open(twin_path, "w") as f:
            json.dump(trep, f, default=float)
        prom = os.path.join(td, "flexflow.prom")
        state = run_once(tdir, prom_file=prom, twin_report=twin_path)
        ok = (len(state["goodputs"]) == 2
              and state["sentinels"]["nonfinite"] == 0
              and os.path.exists(prom))
        if ok:
            with open(prom) as f:
                text = f.read()
            ok = ("flexflow_goodput_ratio" in text
                  and "flexflow_twin_tokens_per_second" in text
                  and 'flexflow_twin_capacity_rps{replicas="2"}' in text)
    print("CHECK " + ("PASS" if ok else "FAIL"))
    return 0 if ok else 1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser("flexflow_tpu_torch.tools.monitor",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("telemetry_dir", nargs="?",
                    help="telemetry dir (or one .jsonl file) to tail")
    ap.add_argument("--refresh", type=float, default=2.0,
                    help="seconds between dashboard refreshes")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (no screen clearing)")
    ap.add_argument("--iterations", type=int, default=0,
                    help="stop after N refreshes (0 = until Ctrl-C)")
    ap.add_argument("--prom-file", default=None,
                    help="write a Prometheus textfile export here on "
                    "every refresh")
    ap.add_argument("--twin-report", default=None,
                    help="the twin tool's report JSON (--twin-out) to "
                    "render as the capacity-twin panel + "
                    "flexflow_twin_* gauges (re-read every refresh)")
    ap.add_argument("--json", action="store_true",
                    help="with --once: dump the gathered state as JSON "
                    "instead of the dashboard")
    ap.add_argument("--check", action="store_true",
                    help="smoke: small fit -> dashboard -> verify")
    ap.add_argument("--device", default="cuda",
                    help="device of --check's fit (default: the card)")
    args = ap.parse_args(argv)
    if args.check:
        return _check(args.device)
    if not args.telemetry_dir:
        ap.error("telemetry_dir is required (or --check)")
    if args.once:
        if args.json:
            state = gather(load_events(args.telemetry_dir))
            state["twin"] = load_twin(args.twin_report)
            if args.prom_file:
                prom_export(state, args.prom_file)
            print(json.dumps(state, indent=2, default=str))
        else:
            run_once(args.telemetry_dir, args.prom_file,
                     twin_report=args.twin_report)
        return 0
    n = 0
    try:
        while True:
            run_once(args.telemetry_dir, args.prom_file, clear=True,
                     twin_report=args.twin_report)
            n += 1
            if args.iterations and n >= args.iterations:
                break
            time.sleep(max(0.1, args.refresh))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
