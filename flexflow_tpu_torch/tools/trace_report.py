"""Render a telemetry JSONL stream (--telemetry-dir) into (a) a per-span
summary table and (b) Chrome trace-event JSON loadable in chrome://tracing /
Perfetto (counterpart: tools/trace_report.py).

Usage:
    python -m flexflow_tpu_torch.tools.trace_report <telemetry-dir-or-file>
        [--out trace.json] [--top N] [--rid RID]
    python -m flexflow_tpu_torch.tools.trace_report --check [--device cpu]

`--check` runs a small fit of the port with telemetry on, on the card
(or on `--device cpu`), renders it and validates the Chrome document.

The report also derives the cross-layer metrics the raw stream carries:
  * pipeline bubble fraction from the executed per-(stage, phase,
    microbatch) op timeline — the SAME accounting the executor reports in
    step_stats["measured_bubble"] (telemetry.bubble_from_ops is shared),
  * the [drift] predicted-vs-measured step-time events the fit loop
    emitted (cost-model drift monitor),
  * any error-category events (e.g. checkpoint/write_failed).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import Any, Dict, List, Optional


def load_events(path: str) -> List[Dict[str, Any]]:
    from flexflow_tpu_torch.telemetry import read_events

    return read_events(path)


# ------------------------------------------------------------- span summary
def span_summary(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-name aggregate over complete ("X") spans: count, total, mean,
    median, p95, max — all in milliseconds."""
    groups: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        groups.setdefault(ev["name"], []).append(
            float(ev.get("dur", 0.0)) / 1e3)
    rows = []
    for name in sorted(groups):
        ds = sorted(groups[name])
        n = len(ds)
        rows.append({
            "name": name,
            "count": n,
            "total_ms": sum(ds),
            "mean_ms": sum(ds) / n,
            "p50_ms": statistics.median(ds),
            "p95_ms": ds[min(n - 1, int(0.95 * n))],
            "max_ms": ds[-1],
        })
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def print_summary(rows: List[Dict[str, Any]], top: int = 0) -> None:
    if top:
        rows = rows[:top]
    print(f"{'span':32} {'count':>7} {'total_ms':>10} {'mean_ms':>9} "
          f"{'p50_ms':>9} {'p95_ms':>9} {'max_ms':>9}")
    for r in rows:
        print(f"{r['name'][:32]:32} {r['count']:7d} {r['total_ms']:10.2f} "
              f"{r['mean_ms']:9.3f} {r['p50_ms']:9.3f} {r['p95_ms']:9.3f} "
              f"{r['max_ms']:9.3f}")


# ------------------------------------------------------------ chrome export
def to_chrome(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome trace-event JSON: telemetry records already carry
    Chrome-compatible ph/ts/dur (microseconds); thread NAMES become
    numeric tids plus thread_name metadata events."""
    tids: Dict[Any, int] = {}

    def tid_of(ev):
        key = (ev.get("pid", 0), ev.get("tid", "main"))
        if key not in tids:
            tids[key] = len(tids)
        return tids[key]

    out = []
    for ev in events:
        ce: Dict[str, Any] = {
            "name": ev["name"],
            "ph": ev.get("ph", "i"),
            "ts": float(ev["ts"]),
            "pid": int(ev.get("pid", 0)),
            "tid": tid_of(ev),
        }
        if ev.get("cat"):
            ce["cat"] = ev["cat"]
        if ce["ph"] == "X":
            ce["dur"] = float(ev.get("dur", 0.0))
        if ce["ph"] == "i":
            ce["s"] = ev.get("s", "p")
        if ev.get("args"):
            ce["args"] = ev["args"]
        out.append(ce)
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": t,
             "args": {"name": str(tname)}}
            for (pid, tname), t in sorted(tids.items(), key=lambda x: x[1])]
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def validate_chrome(doc: Any) -> List[str]:
    """Schema check for the exported trace (what Perfetto/chrome://tracing
    require to load it): returns a list of problems, empty = valid."""
    problems = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["top level must be an object with a traceEvents list"]
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        if not ev.get("name") or "ph" not in ev:
            problems.append(f"event {i}: missing name/ph")
        ph = ev.get("ph")
        if ph not in ("X", "i", "I", "C", "M", "B", "E"):
            problems.append(f"event {i}: unknown ph {ph!r}")
        if ph in ("X", "i", "I", "C") and not isinstance(
                ev.get("ts"), (int, float)):
            problems.append(f"event {i}: non-numeric ts")
        if ph == "X" and (not isinstance(ev.get("dur"), (int, float))
                          or ev["dur"] < 0):
            problems.append(f"event {i}: X event needs dur >= 0")
        if ph == "C" and "value" not in (ev.get("args") or {}):
            problems.append(f"event {i}: counter without args.value")
    return problems


# -------------------------------------------------------- derived sections
def pipeline_bubble(events: List[Dict[str, Any]]) -> Optional[float]:
    from flexflow_tpu_torch.telemetry import pipeline_bubble_from_events

    return pipeline_bubble_from_events(events)


def drift_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [ev.get("args", {}) for ev in events
            if ev.get("name") == "fit/drift"]


def op_attr_rows(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-op attribution rows (op/attr events from --profile-ops runs,
    flexflow_tpu_torch/attribution.py), newest occurrence per (layer,
    stage) — the [ops] section and the raw material of span_dataset."""
    by_op: Dict[Any, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("name") != "op/attr":
            continue
        args = ev.get("args") or {}
        if args.get("layer"):
            by_op[(args.get("layer"), args.get("stage"))] = args
    rows = list(by_op.values())
    rows.sort(key=lambda r: -(r.get("attributed_s") or 0.0))
    return rows


def op_drift_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [ev.get("args", {}) for ev in events
            if ev.get("name") == "op/drift_topk"]


def error_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [ev for ev in events if ev.get("cat") == "error"]


# ------------------------------------------------- per-request timeline (15)
_TERMINAL_EVENTS = ("serve/request_done", "serve/request_shed",
                    "serve/request_failed")


def request_timeline(events: List[Dict[str, Any]],
                     rid: Any) -> Optional[Dict[str, Any]]:
    """One request's lifecycle from its serve/req/* stage spans: ordered
    stages (queue -> prefill waves -> decode/spec rounds -> swap) with
    per-stage duration and share of the request's wall time, plus the
    unified terminal record. None when the rid never appears."""
    spans = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if not str(ev.get("name", "")).startswith("serve/req/"):
            continue
        args = ev.get("args") or {}
        if str(args.get("rid")) != str(rid):
            continue
        spans.append({
            "stage": ev["name"][len("serve/req/"):],
            "start_us": float(ev["ts"]),
            "dur_us": float(ev.get("dur", 0.0)),
            "tid": ev.get("tid"),
            "args": {k: v for k, v in args.items() if k != "rid"},
        })
    terminal = None
    for ev in events:
        if ev.get("name") in _TERMINAL_EVENTS:
            args = ev.get("args") or {}
            if str(args.get("rid")) == str(rid):
                terminal = dict(args, event=ev["name"])
    if not spans and terminal is None:
        return None
    spans.sort(key=lambda s: (s["start_us"], s["start_us"] + s["dur_us"]))
    if spans:
        t0 = min(s["start_us"] for s in spans)
        t1 = max(s["start_us"] + s["dur_us"] for s in spans)
        wall_us = max(t1 - t0, 1e-9)
        accounted = sum(s["dur_us"] for s in spans)
    else:
        t0, wall_us, accounted = 0.0, 1e-9, 0.0
    return {
        "rid": rid,
        "t0_us": t0,
        "wall_ms": wall_us / 1e3,
        "accounted_frac": accounted / wall_us,
        "stages": spans,
        "terminal": terminal,
    }


def print_request_timeline(tl: Dict[str, Any]) -> None:
    term = tl.get("terminal") or {}
    print(f"request rid={tl['rid']}  wall={tl['wall_ms']:.2f}ms  "
          f"accounted={100.0 * tl['accounted_frac']:.1f}%  "
          f"outcome={term.get('outcome', '?')}"
          f"({term.get('outcome_reason', '?')})")
    t0 = tl["t0_us"]
    for s in tl["stages"]:
        extra = " ".join(f"{k}={v}" for k, v in sorted(s["args"].items()))
        pct = 100.0 * s["dur_us"] / max(tl["wall_ms"] * 1e3, 1e-9)
        print(f"  +{(s['start_us'] - t0) / 1e3:9.2f}ms "
              f"{s['stage']:12} {s['dur_us'] / 1e3:9.2f}ms {pct:5.1f}%  "
              f"[{s.get('tid') or '-'}] {extra}")
    if term:
        keep = ("priority", "queue_wait_s", "ttft_s", "per_token_s",
                "tokens_in", "tokens_out", "kv_pages", "total_s")
        rec = " ".join(f"{k}={term[k]}" for k in keep if k in term)
        print(f"  terminal {term.get('event', '?')}: {rec}")


def render(path: str, out_path: Optional[str] = None, top: int = 0,
           quiet: bool = False) -> Dict[str, Any]:
    """The full report: summary rows + chrome doc + derived sections.
    Returns them for programmatic use (tests, --check)."""
    events = load_events(path)
    rows = span_summary(events)
    chrome = to_chrome(events)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(chrome, f)
    bubble = pipeline_bubble(events)
    drifts = drift_events(events)
    errors = error_events(events)
    ops = op_attr_rows(events)
    op_drifts = op_drift_events(events)
    if not quiet:
        print(f"{len(events)} events from {path}")
        print_summary(rows, top=top)
        if out_path:
            print(f"[chrome] trace written to {out_path} "
                  f"({len(chrome['traceEvents'])} events; load in "
                  "chrome://tracing or https://ui.perfetto.dev)")
        if bubble is not None:
            print(f"[pipeline] measured bubble fraction from executed "
                  f"timeline: {bubble:.3f}")
        for d in drifts:
            pred, meas = d.get("predicted_step_time_s"), \
                d.get("measured_step_time_s")
            if pred and meas:
                print(f"[drift] predicted_step={pred * 1e3:.3f}ms "
                      f"measured_step={meas * 1e3:.3f}ms "
                      f"ratio={meas / pred:.2f}x"
                      + (" DRIFT-WARNING" if d.get("warn") else ""))
        if ops:
            show = ops[:top] if top else ops[:12]
            print(f"[ops] {len(ops)} attributed ops "
                  "(attributed / predicted / roofline, per update):")
            for r in show:
                st = f" s{r['stage']}" if r.get("stage") is not None else ""
                print(f"[ops]   {str(r.get('layer'))[:28]:28}{st} "
                      f"{(r.get('attributed_s') or 0) * 1e6:9.1f}u / "
                      f"{(r.get('predicted_s') or 0) * 1e6:9.1f}u / "
                      f"{(r.get('roofline_s') or 0) * 1e6:9.1f}u  "
                      f"mfu={r.get('mfu', 0):.2f} {r.get('bound', '?')}")
        for d in op_drifts:
            print(f"[ops] drift top-K: worst={d.get('worst')} "
                  f"explains(top-k)={100 * (d.get('explained') or 0):.0f}% "
                  "of the per-op misprediction")
        for ev in errors:
            print(f"[error] {ev['name']}: {ev.get('args', {})}")
    return {"events": events, "summary": rows, "chrome": chrome,
            "bubble": bubble, "drift": drifts, "errors": errors,
            "ops": ops, "op_drift": op_drifts}


# --------------------------------------------------------------- check mode
def _check(device: str = "cuda") -> int:
    """Smoke: run a small fit with telemetry on (on `device`), render it,
    and assert the whole chain — spans from compile AND fit present, drift
    event emitted, chrome JSON schema-valid and json round-trippable."""
    import tempfile

    import numpy as np

    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer, telemetry

    with tempfile.TemporaryDirectory() as td:
        tdir = os.path.join(td, "telemetry")
        cfg = FFConfig(batch_size=16, only_data_parallel=True,
                       telemetry_dir=tdir)
        m = FFModel(cfg)
        x = m.create_tensor([16, 8], name="x")
        m.dense(m.dense(x, 16, activation="relu", name="fc1"), 4,
                name="fc2")
        cmod = m.compile(SGDOptimizer(lr=0.01),
                         loss_type="sparse_categorical_crossentropy",
                         metrics=[], device=device)
        cmod.init(seed=0)
        rng = np.random.default_rng(0)
        xv = rng.normal(size=(64, 8)).astype(np.float32)
        yv = rng.integers(0, 4, size=(64,)).astype(np.int32)
        cmod.fit(xv, yv, epochs=1, verbose=False)
        telemetry.flush()
        out = os.path.join(td, "trace.json")
        rep = render(tdir, out_path=out, quiet=True)
        telemetry.shutdown()

        names = {r["name"] for r in rep["summary"]}
        assert "fit/dispatch" in names, names
        assert "fit/prefetch_wait" in names, names
        assert "compile/compile_model" in names, names
        assert rep["drift"], "no fit/drift event emitted"
        with open(out) as f:
            doc = json.load(f)  # round-trips
        problems = validate_chrome(doc)
        assert not problems, problems
        assert any(ev.get("ph") == "X" and ev.get("name") == "fit/dispatch"
                   for ev in doc["traceEvents"])
    print("trace_report --check OK")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        "flexflow_tpu_torch.tools.trace_report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", nargs="?", default=None,
                    help="telemetry dir or one telemetry-*.jsonl file")
    ap.add_argument("--out", default=None,
                    help="write Chrome trace-event JSON here "
                         "(default <dir>/trace.json)")
    ap.add_argument("--top", type=int, default=0,
                    help="only the N hottest spans in the summary")
    ap.add_argument("--rid", default=None,
                    help="print one serving request's stage timeline "
                         "(serve/req/* spans) instead of the full report")
    ap.add_argument("--check", action="store_true",
                    help="smoke: small fit -> render -> validate")
    ap.add_argument("--device", default="cuda",
                    help="device of --check's fit (default: the card)")
    args = ap.parse_args(argv)
    if args.check:
        return _check(args.device)
    if not args.path:
        ap.error("path required (or --check)")
    if args.rid is not None:
        tl = request_timeline(load_events(args.path), args.rid)
        if tl is None:
            print(f"rid {args.rid!r} not found in {args.path}")
            return 1
        print_request_timeline(tl)
        return 0
    out = args.out
    if out is None:
        base = args.path if os.path.isdir(args.path) \
            else os.path.dirname(args.path) or "."
        out = os.path.join(base, "trace.json")
    render(args.path, out_path=out, top=args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
