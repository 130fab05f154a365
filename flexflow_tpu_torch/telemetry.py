"""One span/counter event stream for every layer (counterpart:
flexflow_tpu/telemetry.py, the same module: the record schema, the file
name and the readers are JAX's, so `tools/trace_report.py`,
`tools/span_dataset.py` and `tools/monitor.py` read the port's stream
unchanged).

A process-global, thread-safe sink that the compile (`compile/*` spans),
the search (`search/*`), fit's loop (prefetch wait, dispatch, host sync,
barrier, epoch), the loader's prefetch thread (transfers, queue depth),
the async checkpoint writer, the retry policy, the fault injector and the
serving engine and scheduler emit into.

Design contract:
  * OFF by default, near-zero cost when disabled: `enabled()` is one
    global read; hot loops guard their instrumentation on a local copy of
    it, and `span()` returns a shared no-op context manager. The disabled
    fit performs exactly the dispatches and host syncs it performs without
    this module. A span times host work only: nothing here synchronizes
    with a device or reads a device value.
  * Enabled by `configure(dir)` (`--telemetry-dir` through FFConfig and
    compile_model), writing JSON Lines to `<dir>/telemetry-<pid>.jsonl`,
    rotated by size (`--telemetry-max-mb`).
  * Timestamps are MICROSECONDS on a process-monotonic clock
    (time.perf_counter since import), so events map 1:1 onto the Chrome
    trace-event format (ph "X" complete span / "i" instant / "C" counter,
    ts/dur in us).

Record schema (one JSON object per line):
  {"name": str, "ph": "X"|"i"|"C", "ts": us, "dur": us (X only),
   "pid": int, "tid": thread-name, "cat": str?, "args": dict?}
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

_LOCK = threading.Lock()
_SINK: Optional["_Sink"] = None
_T0 = time.perf_counter()  # process epoch all ts are relative to

# cost-model drift guardrail: measured/predicted step-time ratios beyond
# this factor (either direction) flag the calibration as stale
DRIFT_WARN_RATIO = 3.0


class _Sink:
    """One open JSONL stream. All writes serialize under the module lock
    (spans are emitted from the fit loop, prefetch threads, and the async
    checkpoint writer concurrently).

    Long elastic runs (days of fit + resume cycles) would grow a single
    JSONL without bound, so the sink rotates by SIZE: once the current
    segment exceeds `max_bytes` the next emit rolls to
    `telemetry-<pid>.<seq>.jsonl`. Segments are never renamed or deleted
    (concurrent readers — tools/monitor.py tailing the dir — stay valid),
    and read_events() merges every `telemetry-*.jsonl` in the dir
    ts-sorted, so trace_report / span_dataset / monitor see one stream."""

    def __init__(self, dir_: str, max_bytes: Optional[int] = None):
        os.makedirs(dir_, exist_ok=True)
        self.dir = dir_
        self.max_bytes = max_bytes
        self._seq = 0
        self.path = os.path.join(dir_, f"telemetry-{os.getpid()}.jsonl")
        self._f = open(self.path, "a", buffering=1 << 16)
        # appending to an existing stream (re-configure to the same dir in
        # a new sink): count what's already there toward the size cap
        try:
            self._written = os.path.getsize(self.path)
        except OSError:
            self._written = 0

    def _rotate_locked(self) -> None:
        """Roll to the next segment (caller holds _LOCK)."""
        try:
            self._f.flush()
            self._f.close()
        except ValueError:
            pass
        self._seq += 1
        self.path = os.path.join(
            self.dir, f"telemetry-{os.getpid()}.{self._seq:03d}.jsonl")
        self._f = open(self.path, "a", buffering=1 << 16)
        self._written = 0

    def emit(self, obj: Dict[str, Any]) -> None:
        line = json.dumps(obj, separators=(",", ":"), default=str)
        with _LOCK:
            # a writer thread (async checkpoint, prefetcher) may hold a
            # sink reference shutdown() is concurrently closing: dropping
            # the event is correct, raising into the caller is not (it
            # would mark a SUCCESSFUL checkpoint write as failed)
            try:
                if self._f.closed:
                    return
                if (self.max_bytes is not None
                        and self._written >= self.max_bytes):
                    self._rotate_locked()
                self._f.write(line + "\n")
                self._written += len(line) + 1
            except ValueError:
                pass

    def flush(self) -> None:
        with _LOCK:
            self._f.flush()

    def close(self) -> None:
        with _LOCK:
            try:
                self._f.flush()
                self._f.close()
            except ValueError:  # already closed
                pass


_ATEXIT_HOOKED = False


def _register_atexit() -> None:
    global _ATEXIT_HOOKED
    if _ATEXIT_HOOKED:
        return
    _ATEXIT_HOOKED = True
    import atexit

    atexit.register(flush)


def configure(telemetry_dir: Optional[str],
              max_mb: Optional[float] = None) -> bool:
    """Enable (or re-point) the process-global sink. A falsy dir is a
    no-op — telemetry keeps its current state; turning it OFF is an
    explicit `shutdown()` (so one compile with --telemetry-dir doesn't get
    silently disabled by a later compile without it). `max_mb` caps each
    JSONL segment's size (`--telemetry-max-mb`; None/0 = unbounded) — the
    sink rotates to numbered segments past it. Returns enabled()."""
    global _SINK
    if not telemetry_dir:
        return _SINK is not None
    d = os.path.abspath(os.path.expanduser(telemetry_dir))
    max_bytes = int(max_mb * (1 << 20)) if max_mb else None
    old = _SINK
    if old is not None and old.dir == d:
        if max_mb is not None:
            with _LOCK:
                old.max_bytes = max_bytes
        return True
    _SINK = _Sink(d, max_bytes=max_bytes)
    if old is not None:
        old.close()
    _register_atexit()
    return True


def shutdown() -> None:
    """Disable telemetry and close the stream (flushes buffered lines)."""
    global _SINK
    s, _SINK = _SINK, None
    if s is not None:
        s.close()


def flush() -> None:
    s = _SINK
    if s is not None:
        s.flush()


def enabled() -> bool:
    return _SINK is not None


def sink_path() -> Optional[str]:
    s = _SINK
    return s.path if s is not None else None


def now_us() -> float:
    """Microseconds on the process-monotonic clock (the ts domain of every
    emitted event and of the Chrome trace export)."""
    return (time.perf_counter() - _T0) * 1e6


def _base(name: str, ph: str, ts: float, cat: Optional[str],
          args: Optional[Dict[str, Any]],
          tid: Optional[str] = None) -> Dict[str, Any]:
    obj: Dict[str, Any] = {"name": name, "ph": ph, "ts": ts,
                           "pid": os.getpid(),
                           "tid": tid if tid is not None
                           else threading.current_thread().name}
    if cat:
        obj["cat"] = cat
    if args:
        obj["args"] = args
    return obj


def record(name: str, start_us: float, end_us: Optional[float] = None,
           cat: Optional[str] = None, tid: Optional[str] = None,
           **args: Any) -> None:
    """Emit a complete span from explicit timestamps — the hot-loop path:
    callers guard on enabled(), stamp now_us() inline, and pay nothing
    (not even a context-manager frame) when telemetry is off. `tid`
    overrides the default thread-name track — the serving request tracer
    uses "slot<k>" so the Chrome export reads as one row per decode slot
    instead of one row per host thread."""
    s = _SINK
    if s is None:
        return
    end = now_us() if end_us is None else end_us
    obj = _base(name, "X", start_us, cat, args or None, tid=tid)
    obj["dur"] = max(0.0, end - start_us)
    s.emit(obj)


def event(name: str, cat: Optional[str] = None, **args: Any) -> None:
    """Instant event (Chrome ph "i")."""
    s = _SINK
    if s is None:
        return
    obj = _base(name, "i", now_us(), cat, args or None)
    obj["s"] = "p"  # process-scoped instant
    s.emit(obj)


def error(name: str, **args: Any) -> None:
    """Instant event in the reserved "error" category — surfaced by
    trace_report's summary and by the fit-end / profile_report warnings
    (e.g. checkpoint/write_failed from runtime/checkpoint.py)."""
    event(name, cat="error", **args)


def retry(site: str, attempt: int, exc: BaseException, **args: Any) -> None:
    """Instant event in the reserved "retry" category — one per backoff
    retry of a transient fault (runtime/resilience.run_resilient);
    exhaustion lands in the "error" category instead."""
    event("retry", cat="retry", site=site, attempt=attempt,
          error=repr(exc), **args)


def counter(name: str, value: float, cat: Optional[str] = None) -> None:
    """Counter sample (Chrome ph "C") — e.g. dataloader queue occupancy."""
    s = _SINK
    if s is None:
        return
    obj = _base(name, "C", now_us(), cat, {"value": float(value)})
    s.emit(obj)


class _Span:
    __slots__ = ("_name", "_cat", "_args", "_t0")

    def __init__(self, name: str, cat: Optional[str],
                 args: Dict[str, Any]):
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = now_us()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        args = self._args
        if et is not None:
            args = dict(args, error=repr(ev))
        record(self._name, self._t0, cat=self._cat, **args)
        return False


class _NullSpan:
    """Shared no-op context manager: `with span(...)` costs two attribute
    calls when telemetry is disabled (reentrant; one module singleton)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


def span(name: str, cat: Optional[str] = None, **args: Any):
    """Context manager recording a complete span around its body. Returns
    the shared no-op when disabled. For per-step hot loops prefer the
    record()/now_us() pair under an enabled() guard."""
    if _SINK is None:
        return NULL_SPAN
    return _Span(name, cat, args)


# ------------------------------------------------------------------ readers
def read_events(path: str) -> List[Dict[str, Any]]:
    """Load a telemetry stream: `path` is one .jsonl file or a telemetry
    dir (all telemetry-*.jsonl merged). Events come back ts-sorted;
    malformed lines (a crashed writer's torn tail) are skipped."""
    files: List[str]
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.startswith("telemetry-") and f.endswith(".jsonl"))
    else:
        files = [path]
    out: List[Dict[str, Any]] = []
    for fp in files:
        with open(fp) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if isinstance(ev, dict) and "name" in ev and "ts" in ev:
                    out.append(ev)
    out.sort(key=lambda e: e.get("ts", 0.0))
    return out


# ------------------------------------------------- shared derived metrics
def bubble_from_ops(num_stages: int,
                    ops: Iterable[Tuple[int, float, float]]
                    ) -> Optional[float]:
    """Bubble fraction of one executed pipeline update from its per-op
    timeline: ops are (stage, start_us, end_us) for every F/B op the
    executor dispatched. bubble = 1 - busy / (stages * span). This is THE
    accounting a pipeline executor's step_stats["measured_bubble"] and
    tools/trace_report.py use, shared so the two can never disagree."""
    ops = list(ops)
    if not ops or num_stages <= 0:
        return None
    start = min(o[1] for o in ops)
    end = max(o[2] for o in ops)
    span_us = end - start
    if span_us <= 0.0:
        return None
    busy = sum(e - s for _stage, s, e in ops)
    return max(0.0, 1.0 - busy / (num_stages * span_us))


def pipeline_bubble_from_events(events: Sequence[Dict[str, Any]]
                                ) -> Optional[float]:
    """Mean per-update bubble over a stream's pipeline phase events
    (cat "pipeline", names pipe/F + pipe/B, args stage/micro/update/fit):
    groups by (pid, fit id, update id) — update counters restart per
    process AND per fit (init() resets the iteration counter), and each
    process's ts lives on its own monotonic epoch, so a stream holding
    several runs must never merge their ops into one timeline — applies
    bubble_from_ops per update with that update's OWN stage count, in
    group order; the executor accumulates its reported bubble the same
    way (over one fit; on a multi-fit stream this is the mean over every
    fit's updates)."""
    per_update: Dict[Any, List[Tuple[int, float, float]]] = {}
    for ev in events:
        if ev.get("cat") != "pipeline" or ev.get("ph") != "X":
            continue
        if ev.get("name") not in ("pipe/F", "pipe/B"):
            continue
        args = ev.get("args") or {}
        s = int(args.get("stage", 0))
        key = (ev.get("pid"), args.get("fit"), args.get("update"))
        per_update.setdefault(key, []).append(
            (s, float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0))))
    if not per_update:
        return None
    total, n = 0.0, 0
    for key in sorted(per_update,
                      key=lambda k: tuple((x is None, x) for x in k)):
        ops = per_update[key]
        stages = max(o[0] for o in ops) + 1
        b = bubble_from_ops(stages, ops)
        if b is not None:
            total += b
            n += 1
    return total / n if n else None


def drift_stats(predicted_s: Optional[float],
                windows: Sequence[Tuple[int, float]]) -> Dict[str, Any]:
    """Cost-model drift: the search's predicted per-update step time vs
    the fit loop's measured windows [(steps, wall_seconds), one per
    epoch]. The FIRST window pays the warm-up (the kernels' builds, the
    allocator's growth, a CUDA graph's capture), so when more than one
    exists it is excluded and the rest reduce by MEDIAN; warn only trips
    (past DRIFT_WARN_RATIO in either direction) when at least one
    post-warm-up window exists — a 1-epoch fit reports the
    ratio for the record but can't distinguish drift from warm-up cost.
    A tripped warn is the cue to recalibrate the cost model (measured op
    costs: `--profiling` prices the search's ops on the device)."""
    ws = [(int(n), float(t)) for n, t in windows if n > 0 and t > 0.0]
    steady = ws[1:] if len(ws) >= 2 else ws
    measured = statistics.median(t / n for n, t in steady) if steady \
        else None
    out: Dict[str, Any] = {
        "predicted_step_time_s": float(predicted_s) if predicted_s else None,
        "measured_step_time_s": measured,
        "windows": len(ws),
        "ratio": None,
        "warn": False,
    }
    if out["predicted_step_time_s"] and measured:
        r = measured / out["predicted_step_time_s"]
        out["ratio"] = r
        out["warn"] = bool(len(ws) >= 2 and (r > DRIFT_WARN_RATIO
                                             or r < 1.0 / DRIFT_WARN_RATIO))
    return out


def emit_fit_end(drift: Dict[str, Any], verbose: bool,
                 **extra: Any) -> None:
    """Shared fit-end drift hook: emit the fit/drift event into the
    stream when telemetry is on, and print the [drift] warning lines when
    the monitor tripped."""
    if enabled():
        args = {k: v for k, v in drift.items() if v is not None}
        args.update({k: v for k, v in extra.items() if v is not None})
        event("fit/drift", cat="drift", **args)
    if verbose and drift.get("warn"):
        for line in format_drift(drift):
            print(line)


def format_drift(d: Dict[str, Any]) -> List[str]:
    """The `[drift]` report lines (profile_report + fit-end summary share
    this formatting)."""
    pred, meas = d.get("predicted_step_time_s"), d.get("measured_step_time_s")
    if pred is None and meas is None:
        return ["[drift] no prediction and no measured fit windows yet"]
    if meas is None:
        return [f"[drift] predicted_step={pred * 1e3:.3f}ms; no measured "
                "fit windows yet (run fit())"]
    if pred is None:
        return [f"[drift] measured_step={meas * 1e3:.3f}ms; strategy "
                "carries no predicted cost"]
    lines = [f"[drift] predicted_step={pred * 1e3:.3f}ms "
             f"measured_step={meas * 1e3:.3f}ms "
             f"ratio={d['ratio']:.2f}x "
             f"(median of {d['windows']} epoch windows)"]
    if d.get("warn"):
        lines.append(
            f"[drift] WARNING: measured/predicted ratio {d['ratio']:.2f}x "
            f"outside [1/{DRIFT_WARN_RATIO:g}, {DRIFT_WARN_RATIO:g}] — the "
            "cost model has drifted; recalibrate it (--profiling prices "
            "the search's ops on the device)")
    return lines
