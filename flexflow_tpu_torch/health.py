"""Run health: goodput accounting, numerics sentinels, memory watermarks
and serving SLOs (counterpart: flexflow_tpu/health.py).

  * `GoodputMeter` classifies fit's wall clock into named buckets with a
    contiguous lap cursor (every perf_counter interval between two lap()
    calls lands in exactly one bucket, so the buckets tile the loop's wall
    and the unattributed residual stays small and explicit). Goodput
    counts the compute-facing buckets (dispatch + host_sync + barrier);
    input stalls, checkpointing, resume and recompile time, host
    bookkeeping and the residual are lost time.
  * `SentinelMonitor` / `SentinelState`: device-resident finite checks and
    grad-norm / loss spike detectors. The train step folds the
    `health/grad_norm` and `health/nonfinite` scalars into its metric
    outputs (inside a K-step CUDA graph too, as means over the K steps),
    and the monitor reads them only at fit's EXISTING sync points: no
    extra host sync on the healthy path. A NaN/Inf emits a
    `health/nonfinite` error event and, under `halt_on_nonfinite`, raises
    `NonFiniteError` through the checkpoint drain, naming the last
    durable checkpoint (runtime/resilience.py).
  * `WatermarkTracker`: live/peak device memory sampled at init and at
    each epoch's end (`torch.cuda.memory_stats` on the card, the summed
    bytes of params and optimizer state on the CPU) against the cost
    model's prediction, with a warning past WATERMARK_WARN_RATIO.
  * Serving SLOs: `--serve-slo` is a comma-separated list of objectives,
    e.g. "ttft_p99_ms=25,per_token_p99_ms=10,availability=0.999". Latency
    objectives are `<metric>_p<PP>_ms` over the terminal records'
    `ttft_s`, `per_token_s` or `queue_wait_s` fields, and their error
    budget is the complement of the percentile (p99: 1% of requests may
    exceed the threshold). `availability=<frac>` budgets the outcomes
    other than "done" (sheds, failures and watchdog timeouts all count
    against it). `merge_slo_trackers` and `scaling_signal` read them.

Telemetry events (cat "health"): health/goodput (per epoch),
health/grad_spike, health/loss_spike, health/hbm; cat "error":
health/nonfinite, health/halt.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.metrics import PerfMetrics

# ------------------------------------------------------------------ goodput
# bucket names (GoodputMeter.lap / add): every second of fit wall-clock
# should land in one of these, with the leftover reported as "residual"
BUCKETS = (
    "dispatch",        # issuing step dispatches (device compute)
    "prefetch_wait",   # blocked on the input pipeline (data stall)
    "host_sync",       # deferred-metric materialization (device wait)
    "barrier",         # dispatch-ahead stream synchronize (device wait)
    "loop",            # host-side bookkeeping between dispatches
    "checkpoint",      # snapshot + drain on the fit thread
    "resume",          # restore_auto / checkpoint load before epoch 0
    "recompile",       # recompile_on_condition rebuilds mid-fit
)
# compute-facing buckets: counted as productive before the bubble carve-out
PRODUCTIVE = ("dispatch", "host_sync", "barrier")


class GoodputMeter:
    """Wall-clock bucket accounting for one fit.

    The lap cursor makes the accounting contiguous: `tick()` arms it,
    and each `lap(bucket)` charges the interval since the previous
    lap/tick to `bucket`. `add(bucket, s)` credits out-of-band time
    (resume before the loop starts). `epoch_end()` closes the epoch:
    derives the pipeline-bubble carve-out from the dispatch bucket,
    computes goodput% and the unattributed residual, emits the
    `health/goodput` event, and resets for the next epoch."""

    def __init__(self) -> None:
        self._acc: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._last: Optional[float] = None
        self.epochs: List[Dict[str, Any]] = []

    def tick(self) -> None:
        self._last = time.perf_counter()

    def lap(self, bucket: str) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._acc[bucket] = self._acc.get(bucket, 0.0) \
                + (now - self._last)
        self._last = now

    def add(self, bucket: str, seconds: float) -> None:
        if seconds > 0.0:
            self._acc[bucket] = self._acc.get(bucket, 0.0) + seconds

    def epoch_end(self, wall_s: float, epoch: int,
                  bubble_frac: Optional[float] = None) -> Dict[str, Any]:
        acc, self._acc = self._acc, {b: 0.0 for b in BUCKETS}
        self._last = None
        bubble_s = (float(bubble_frac) if bubble_frac else 0.0) \
            * acc.get("dispatch", 0.0)
        accounted = sum(acc.values())
        residual = max(0.0, wall_s - accounted)
        productive = sum(acc.get(b, 0.0) for b in PRODUCTIVE) - bubble_s
        rec: Dict[str, Any] = {
            "epoch": int(epoch),
            "wall_s": float(wall_s),
            "buckets": {k: float(v) for k, v in acc.items()},
            "bubble_s": float(bubble_s),
            "residual_s": float(residual),
            "accounted_frac": (accounted / wall_s) if wall_s > 0 else 0.0,
            "goodput": max(0.0, min(1.0, productive / wall_s))
            if wall_s > 0 else 0.0,
        }
        self.epochs.append(rec)
        if tel.enabled():
            args: Dict[str, Any] = {
                "epoch": rec["epoch"], "wall_s": rec["wall_s"],
                "goodput": rec["goodput"],
                "residual_s": rec["residual_s"],
                "bubble_s": rec["bubble_s"],
            }
            for k, v in acc.items():
                if v > 0.0:
                    args[k + "_s"] = v
            tel.event("health/goodput", cat="health", **args)
        return rec

    def report(self) -> Dict[str, Any]:
        """Fit-level aggregate over the closed epochs."""
        wall = sum(e["wall_s"] for e in self.epochs)
        buckets: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        for e in self.epochs:
            for k, v in e["buckets"].items():
                buckets[k] = buckets.get(k, 0.0) + v
        bubble = sum(e["bubble_s"] for e in self.epochs)
        residual = sum(e["residual_s"] for e in self.epochs)
        productive = sum(buckets.get(b, 0.0) for b in PRODUCTIVE) - bubble
        return {
            "epochs": len(self.epochs),
            "wall_s": wall,
            "buckets": buckets,
            "bubble_s": bubble,
            "residual_s": residual,
            "accounted_frac": (sum(buckets.values()) / wall)
            if wall > 0 else 0.0,
            "goodput": max(0.0, min(1.0, productive / wall))
            if wall > 0 else 0.0,
        }


def format_goodput(rep: Dict[str, Any]) -> List[str]:
    """The `[goodput]` report lines (profile_report + bench share this)."""
    if not rep or not rep.get("epochs"):
        return ["[goodput] no closed fit epochs yet (run fit())"]
    wall = rep["wall_s"] or 1e-12
    parts = " ".join(
        f"{k}={100.0 * v / wall:.1f}%" for k, v in
        sorted(rep["buckets"].items(), key=lambda kv: -kv[1]) if v > 0.0)
    lines = [f"[goodput] {100.0 * rep['goodput']:.1f}% of "
             f"{wall:.2f}s wall over {rep['epochs']} epoch(s) "
             f"(accounted {100.0 * rep['accounted_frac']:.1f}%, "
             f"residual {rep['residual_s']:.3f}s)",
             f"[goodput] buckets: {parts or '(none)'}"]
    if rep.get("bubble_s"):
        lines.append(f"[goodput] pipeline bubble carve-out: "
                     f"{rep['bubble_s']:.3f}s "
                     f"({100.0 * rep['bubble_s'] / wall:.1f}% of wall)")
    return lines


# ---------------------------------------------------------------- sentinels
# reserved metric keys the train step folds into its metric outputs; fit
# pops them off before the user-facing metric accounting
GRAD_NORM_KEY = "health/grad_norm"
NONFINITE_KEY = "health/nonfinite"
SENTINEL_KEYS = (GRAD_NORM_KEY, NONFINITE_KEY)

# spike thresholds: a window mean this many times the trailing EMA (grad
# norm) / the previous window mean (loss) emits a health/*_spike warning
GRAD_SPIKE_RATIO = 10.0
LOSS_SPIKE_RATIO = 4.0
_EMA_DECAY = 0.9


def grad_global_norm(grads: Dict[str, Dict[str, torch.Tensor]]
                     ) -> torch.Tensor:
    """The f32 global L2 norm of a gradient tree, on the device (optax's
    `global_norm`: the root of the sum of every element's square); no
    host read."""
    flat = [g for ws in grads.values() for g in ws.values()]
    if not flat:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm([g.float() for g in flat])
    return torch.linalg.vector_norm(torch.stack(norms))


def sentinel_metrics(loss: torch.Tensor, grad_norm: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """Device-side sentinel scalars for one optimizer update: the grad
    global norm and a 0/1 non-finite flag over (loss, grad_norm), both
    f32 device tensors (nothing is read to the host). Means of the flag
    across fused or accumulated steps stay > 0 iff ANY step tripped (NaN
    also propagates through the mean), so deferred accumulation keeps the
    detection."""
    gn = grad_norm.detach().float()
    ls = loss.detach().float()
    finite = torch.isfinite(ls) & torch.isfinite(gn)
    return {GRAD_NORM_KEY: gn,
            NONFINITE_KEY: 1.0 - finite.float()}


class NonFiniteError(RuntimeError):
    """Fatal numerics failure (--halt-on-nonfinite): raised through the
    checkpoint drain, carrying the last DURABLE checkpoint path — the
    recovery point a supervisor resumes from (the in-memory state is
    poisoned and deliberately NOT saved)."""

    def __init__(self, step: int, checkpoint: Optional[str],
                 detail: str = ""):
        self.step = int(step)
        self.checkpoint = checkpoint
        msg = (f"non-finite loss/grad detected at step {step}"
               + (f" ({detail})" if detail else ""))
        msg += (f"; last durable checkpoint: {checkpoint}" if checkpoint
                else "; no durable checkpoint available")
        super().__init__(msg)


def halt_nonfinite(step: int, checkpoint_root: Optional[str],
                   detail: str = "") -> "NoReturn":  # noqa: F821
    """The drain path for a fatal sentinel: join in-flight async
    checkpoint writes (so a durable save racing the failure lands), look
    up the newest durable checkpoint, emit the health/halt error event,
    and raise NonFiniteError. The poisoned live state is NOT saved."""
    from flexflow_tpu_torch.runtime import checkpoint as ck
    from flexflow_tpu_torch.runtime.resilience import latest_checkpoint

    ck.wait_pending()
    last = latest_checkpoint(checkpoint_root) if checkpoint_root else None
    tel.error("health/halt", step=int(step), checkpoint=last,
              detail=detail or None)
    raise NonFiniteError(step, last, detail)


class SentinelState:
    """Host-side spike/NaN detectors over materialized window means.
    Pure accounting (feed it floats, read `.events`) so tests drive it
    without a device."""

    def __init__(self, grad_ratio: float = GRAD_SPIKE_RATIO,
                 loss_ratio: float = LOSS_SPIKE_RATIO):
        self.grad_ratio = float(grad_ratio)
        self.loss_ratio = float(loss_ratio)
        self.grad_ema: Optional[float] = None
        self.loss_prev: Optional[float] = None
        self.nonfinite_steps = 0
        self.events: List[Dict[str, Any]] = []

    def observe(self, step: int, loss_mean: Optional[float] = None,
                grad_norm: Optional[float] = None,
                nonfinite: float = 0.0) -> Optional[str]:
        """One materialized window. Returns "nonfinite" on a fatal
        window, else None (spikes are warnings, not fatal)."""
        fatal = (nonfinite is not None and nonfinite > 0.0) \
            or (nonfinite != nonfinite)  # NaN count is itself a trip
        if not fatal and grad_norm is not None \
                and grad_norm != grad_norm:
            fatal = True
        if fatal:
            self.nonfinite_steps += 1
            ev = {"kind": "nonfinite", "step": int(step),
                  "grad_norm": grad_norm, "loss": loss_mean}
            self.events.append(ev)
            tel.error("health/nonfinite", step=int(step),
                      grad_norm=grad_norm, loss=loss_mean)
            return "nonfinite"
        if grad_norm is not None:
            if self.grad_ema is not None \
                    and grad_norm > self.grad_ratio * max(self.grad_ema,
                                                          1e-12):
                ev = {"kind": "grad_spike", "step": int(step),
                      "grad_norm": grad_norm, "ema": self.grad_ema}
                self.events.append(ev)
                tel.event("health/grad_spike", cat="health",
                          step=int(step), grad_norm=grad_norm,
                          ema=self.grad_ema)
            self.grad_ema = grad_norm if self.grad_ema is None else \
                _EMA_DECAY * self.grad_ema + (1 - _EMA_DECAY) * grad_norm
        if loss_mean is not None and loss_mean == loss_mean:
            if self.loss_prev is not None \
                    and abs(loss_mean) > self.loss_ratio \
                    * max(abs(self.loss_prev), 1e-12):
                ev = {"kind": "loss_spike", "step": int(step),
                      "loss": loss_mean, "prev": self.loss_prev}
                self.events.append(ev)
                tel.event("health/loss_spike", cat="health",
                          step=int(step), loss=loss_mean,
                          prev=self.loss_prev)
            self.loss_prev = loss_mean
        return None

    def status(self) -> Dict[str, Any]:
        return {
            "nonfinite_steps": self.nonfinite_steps,
            "grad_spikes": sum(1 for e in self.events
                               if e["kind"] == "grad_spike"),
            "loss_spikes": sum(1 for e in self.events
                               if e["kind"] == "loss_spike"),
            "grad_ema": self.grad_ema,
        }


class SentinelMonitor:
    """The fit loop's sentinel harness: `push()` strips the reserved
    health keys off a dispatch's metric dict into a deferred PerfMetrics
    (no host transfer), and `check()` materializes the window ONLY at
    the loop's existing sync points, runs the detectors, and — under
    halt_on_nonfinite — raises via the drain path."""

    def __init__(self, halt: bool = False,
                 checkpoint_root: Optional[str] = None,
                 state: Optional[SentinelState] = None):
        self.halt = bool(halt)
        self.checkpoint_root = checkpoint_root
        self.state = state or SentinelState()
        self._win = PerfMetrics()
        self._loss_sum_prev = 0.0
        self._steps_prev = 0

    def push(self, steps: int, mvals: Dict[str, Any]) -> None:
        """Pop health/* device scalars out of `mvals` (mutates it — the
        user-facing metric accounting must not see reserved keys) and
        queue them deferred."""
        h = {k: mvals.pop(k) for k in SENTINEL_KEYS if k in mvals}
        if h:
            self._win.update_deferred(int(steps), h)

    def check(self, step: int, loss_sum: Optional[float] = None,
              steps_total: Optional[int] = None) -> Optional[str]:
        """Materialize the window (call ONLY where the loop already
        syncs) and run the detectors. `loss_sum`/`steps_total` are the
        loop's running loss accumulator + step count; window means are
        the deltas since the previous check."""
        w, self._win = self._win, PerfMetrics()
        w.materialize()
        n = max(1, w.train_all)
        gsum = w.sums.get(GRAD_NORM_KEY)
        nf = w.sums.get(NONFINITE_KEY, 0.0)
        loss_mean = None
        if loss_sum is not None and steps_total is not None:
            dn = steps_total - self._steps_prev
            if dn > 0:
                loss_mean = (loss_sum - self._loss_sum_prev) / dn
            self._loss_sum_prev = float(loss_sum)
            self._steps_prev = int(steps_total)
        verdict = self.state.observe(
            step, loss_mean=loss_mean,
            grad_norm=(gsum / n) if gsum is not None else None,
            nonfinite=nf)
        if verdict == "nonfinite" and self.halt:
            halt_nonfinite(step, self.checkpoint_root,
                           detail=f"nonfinite window mean {nf / n:g}")
        return verdict


# --------------------------------------------------------------- watermarks
# actual peak memory beyond this multiple of the search's prediction flags
# the memory model as under-predicting (the inverse of OOM headroom)
WATERMARK_WARN_RATIO = 1.5


def device_watermarks(trees: Sequence[Any] = (), device=None
                      ) -> Dict[str, Dict[str, int]]:
    """Per-device live/peak byte sample. On a CUDA device: the caching
    allocator's `allocated_bytes.all.current` and `.peak`
    (`torch.cuda.memory_stats`): every tensor alive, a CUDA graph's pool
    included, and the peak since the process started or the last
    `torch.cuda.reset_peak_memory_stats` (nothing here resets it). On the
    CPU: the summed bytes of the tensors of the trees the caller passes
    (params and optimizer state, the persistent footprint that
    memory_stats() predicts), as JAX's fallback does."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        live = int(stats.get("allocated_bytes.all.current", 0))
        return {str(dev.index if dev.index is not None
                    else torch.cuda.current_device()): {
            "live": live,
            "peak": int(stats.get("allocated_bytes.all.peak", live))}}
    total = 0
    for tree in trees:
        total += _tree_bytes(tree)
    return {"cpu": {"live": total, "peak": total}} if total else {}


def _tree_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0


def watermark_drift(peak_bytes: Optional[int],
                    predicted_bytes: Optional[int],
                    warn_ratio: float = WATERMARK_WARN_RATIO
                    ) -> Dict[str, Any]:
    """Pure comparison: measured per-device peak vs the search's
    prediction. warn trips when the model UNDER-predicted by more than
    `warn_ratio` (the direction that OOMs a real machine)."""
    ratio = None
    if peak_bytes and predicted_bytes:
        ratio = float(peak_bytes) / float(predicted_bytes)
    return {
        "peak_bytes": int(peak_bytes) if peak_bytes else None,
        "predicted_bytes": int(predicted_bytes) if predicted_bytes
        else None,
        "ratio": ratio,
        "warn": bool(ratio is not None and ratio > warn_ratio),
        "warn_ratio": float(warn_ratio),
    }


class WatermarkTracker:
    """HBM watermark sampler: `sample()` at compile and epoch boundaries,
    `report(predicted)` compares the peak against the cost model."""

    def __init__(self) -> None:
        self.samples: List[Dict[str, Any]] = []

    def sample(self, tag: str, trees: Sequence[Any] = (), device=None
               ) -> Dict[str, Any]:
        per_dev = device_watermarks(trees, device)
        peak = max((v["peak"] for v in per_dev.values()), default=0)
        live = max((v["live"] for v in per_dev.values()), default=0)
        rec = {"tag": str(tag), "per_device": per_dev,
               "peak_bytes": peak, "live_bytes": live}
        self.samples.append(rec)
        if tel.enabled() and per_dev:
            tel.event("health/hbm", cat="health", tag=str(tag),
                      peak_bytes=peak, live_bytes=live,
                      devices=len(per_dev))
        return rec

    def peak_bytes(self) -> Optional[int]:
        peaks = [s["peak_bytes"] for s in self.samples if s["per_device"]]
        return max(peaks) if peaks else None

    def report(self, predicted_bytes: Optional[int],
               warn_ratio: float = WATERMARK_WARN_RATIO
               ) -> Dict[str, Any]:
        rep = watermark_drift(self.peak_bytes(), predicted_bytes,
                              warn_ratio)
        rep["samples"] = len(self.samples)
        return rep


# ------------------------------------------------------------ serving SLOs
_SLO_LATENCY_METRICS = ("ttft", "per_token", "queue_wait")


def parse_slo(spec: str) -> Dict[str, Dict[str, Any]]:
    """Parse the --serve-slo objective string into objective specs:
    {name: {"kind": "latency", "metric", "pct", "threshold_s"} |
            {"kind": "availability", "target"}}. Empty spec -> {}."""
    out: Dict[str, Dict[str, Any]] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"--serve-slo objective {part!r} has no value "
                             "(want name=value)")
        key, _, val = part.partition("=")
        key = key.strip()
        try:
            fval = float(val)
        except ValueError:
            raise ValueError(f"--serve-slo {key}={val!r}: value must be "
                             "numeric") from None
        if key == "availability":
            if not 0.0 < fval <= 1.0:
                raise ValueError(f"--serve-slo availability={fval} must be "
                                 "in (0, 1]")
            out[key] = {"kind": "availability", "target": fval}
            continue
        for metric in _SLO_LATENCY_METRICS:
            prefix = metric + "_p"
            if key.startswith(prefix) and key.endswith("_ms"):
                try:
                    pct = float(key[len(prefix):-3]) / 100.0
                except ValueError:
                    break
                if not 0.0 < pct < 1.0:
                    raise ValueError(f"--serve-slo {key}: percentile must "
                                     "be in (0, 100)")
                out[key] = {"kind": "latency", "metric": metric, "pct": pct,
                            "threshold_s": fval / 1e3}
                break
        else:
            raise ValueError(
                f"--serve-slo objective {key!r} not understood (want "
                f"availability=<frac> or one of "
                f"{'/'.join(_SLO_LATENCY_METRICS)}_p<PP>_ms=<ms>)")
    return out


class SLOTracker:
    """Windowed SLO error budget and burn rates. Every terminal request
    record (`serving.reqtrace.terminal_record`) is classified against each
    objective; `report()` gives the remaining error budget and the burn
    rate over each window (1.0 = spending the budget exactly at the
    sustainable pace, > 1 = it runs out early)."""

    WINDOWS_S = (60.0, 300.0)

    def __init__(self, objectives: Optional[Dict[str, Dict[str, Any]]] = None,
                 windows_s: Sequence[float] = WINDOWS_S,
                 max_events: int = 100_000):
        self.objectives = dict(objectives or {})
        self.windows_s = tuple(float(w) for w in windows_s)
        # (ts_s, {objective: bad}) per terminal request; bounded, since the
        # windows only ever look back max(windows_s)
        self.events: "deque[Tuple[float, Dict[str, bool]]]" = \
            deque(maxlen=max_events)
        self.totals: Dict[str, List[int]] = {
            name: [0, 0] for name in self.objectives}  # [total, bad]
        self.requests = 0
        self.outcomes: Dict[str, int] = {}

    @staticmethod
    def allowed_frac(spec: Dict[str, Any]) -> float:
        """The objective's error budget as a fraction of requests."""
        if spec["kind"] == "availability":
            return max(1e-9, 1.0 - spec["target"])
        return max(1e-9, 1.0 - spec["pct"])

    def _classify(self, rec: Dict[str, Any],
                  spec: Dict[str, Any]) -> Optional[bool]:
        """True = bad (spends budget), False = good, None = the record does
        not count toward this objective."""
        if spec["kind"] == "availability":
            return rec.get("outcome") != "done"
        if rec.get("outcome") != "done":
            return None  # no latency sample; availability prices these
        val = rec.get(spec["metric"] + "_s")
        if val is None:
            return None
        return float(val) > spec["threshold_s"]

    def observe(self, rec: Dict[str, Any],
                now_s: Optional[float] = None) -> None:
        """Classify one terminal request record against every objective."""
        now = time.monotonic() if now_s is None else float(now_s)
        self.requests += 1
        oc = str(rec.get("outcome") or "unknown")
        self.outcomes[oc] = self.outcomes.get(oc, 0) + 1
        verdicts: Dict[str, bool] = {}
        for name, spec in self.objectives.items():
            bad = self._classify(rec, spec)
            if bad is None:
                continue
            verdicts[name] = bad
            self.totals[name][0] += 1
            self.totals[name][1] += int(bad)
        self.events.append((now, verdicts))

    def _window_frac(self, name: str, window_s: float,
                     now: float) -> Optional[float]:
        total = bad = 0
        for ts, verdicts in reversed(self.events):
            if ts < now - window_s:
                break
            if name in verdicts:
                total += 1
                bad += int(verdicts[name])
        return (bad / total) if total else None

    def report(self, now_s: Optional[float] = None) -> Dict[str, Any]:
        now = time.monotonic() if now_s is None else float(now_s)
        done = self.outcomes.get("done", 0)
        per_obj: Dict[str, Any] = {}
        worst_burn: Optional[float] = None
        for name, spec in self.objectives.items():
            total, bad = self.totals[name]
            allowed = self.allowed_frac(spec)
            bad_frac = (bad / total) if total else 0.0
            entry: Dict[str, Any] = {
                "kind": spec["kind"],
                "target": (spec["target"] if spec["kind"] == "availability"
                           else spec["threshold_s"]),
                "total": total, "bad": bad, "bad_frac": bad_frac,
                "allowed_frac": allowed,
                "budget_remaining": 1.0 - bad_frac / allowed,
            }
            for w in self.windows_s:
                frac = self._window_frac(name, w, now)
                burn = (frac / allowed) if frac is not None else None
                entry[f"burn_rate_{w:g}s"] = burn
                if burn is not None:
                    worst_burn = burn if worst_burn is None \
                        else max(worst_burn, burn)
            per_obj[name] = entry
        return {
            "objectives": per_obj,
            "requests": self.requests,
            "outcomes": dict(self.outcomes),
            "shed_rate": ((self.requests - done) / self.requests
                          if self.requests else 0.0),
            "worst_burn_rate": worst_burn,
            "windows_s": list(self.windows_s),
        }


def merge_slo_trackers(trackers) -> "SLOTracker":
    """Rebuild the SLO scoreboard a single tracker would hold had it
    observed the union of every replica's terminal records: totals and
    outcome tallies add, events interleave by timestamp (the window walk
    needs time order), objectives union across the pool, and — the
    windowed-state fix — the merged event ring inherits the base
    tracker's bound, so window burn rates match a union-fed tracker
    exactly even when the ring has wrapped."""
    trackers = [t for t in trackers if t is not None]
    if not trackers:
        return SLOTracker({})
    base = trackers[0]
    objectives: Dict[str, Dict[str, Any]] = {}
    for t in trackers:
        objectives.update(t.objectives)
    out = SLOTracker(objectives, windows_s=base.windows_s,
                     max_events=base.events.maxlen)
    events: List[Tuple[float, Dict[str, bool]]] = []
    for t in trackers:
        events.extend(t.events)
        for name, (total, bad) in t.totals.items():
            slot = out.totals.setdefault(name, [0, 0])
            slot[0] += total
            slot[1] += bad
        out.requests += t.requests
        for oc, n in t.outcomes.items():
            out.outcomes[oc] = out.outcomes.get(oc, 0) + n
    events.sort(key=lambda e: e[0])
    out.events.extend(events)
    return out


# ------------------------------------------------- scaling recommendation
# Multi-window burn-rate policy thresholds (the textbook SRE shape: a
# fast-window burn this hot, CONFIRMED by the slow window, exhausts the
# budget long before a human reacts — recommend scale-out while
# budget_remaining is still positive).
SCALE_OUT_FAST_BURN = 6.0    # short-window burn that demands action
SCALE_OUT_SLOW_BURN = 1.0    # long-window burn confirming it's not a blip
SCALE_IN_MAX_BURN = 0.5      # every window this cool -> capacity to spare
SCALE_IN_MIN_BUDGET = 0.9    # ... and nearly all budget intact


def scaling_signal(slo_report: Dict[str, Any],
                   fast_burn: float = SCALE_OUT_FAST_BURN,
                   slow_burn: float = SCALE_OUT_SLOW_BURN
                   ) -> Dict[str, Any]:
    """Turn one SLOTracker.report() into a scaling recommendation (the
    policy half of an autoscaler). Actions:

      scale_out      — some objective's short-window burn >= fast_burn
                       with the long window confirming (>= slow_burn);
                       fired BEFORE budget_remaining exhausts.
      objective_flip — an error budget already exhausted
                       (budget_remaining <= 0): added capacity can't
                       un-burn history; flip the latency<->throughput
                       objective (or re-tier admission) instead.
      scale_in       — every objective cold (all window burns <=
                       SCALE_IN_MAX_BURN, budgets >= SCALE_IN_MIN_BUDGET).
      steady         — anything else.

    Returns {"action", "objective", "reason", "budget_remaining",
    "worst_burn_rate"} — `objective` names the offender (or None)."""
    objectives = slo_report.get("objectives") or {}
    windows = sorted(float(w) for w in (slo_report.get("windows_s") or
                                        SLOTracker.WINDOWS_S))
    if not objectives:
        return {"action": "steady", "objective": None,
                "reason": "no SLO objectives configured",
                "budget_remaining": None, "worst_burn_rate": None}
    w_fast, w_slow = windows[0], windows[-1]
    min_budget, min_budget_obj = None, None
    flip_obj = None
    out_obj, out_reason = None, None
    all_cold = True
    for name, entry in objectives.items():
        budget = entry.get("budget_remaining")
        if budget is not None and (min_budget is None or
                                   budget < min_budget):
            min_budget, min_budget_obj = budget, name
        bf = entry.get(f"burn_rate_{w_fast:g}s")
        bs = entry.get(f"burn_rate_{w_slow:g}s")
        if budget is not None and budget <= 0.0 and flip_obj is None:
            flip_obj = name
        confirmed = bs is None or bs >= slow_burn
        if bf is not None and bf >= fast_burn and confirmed \
                and out_obj is None:
            out_obj = name
            out_reason = (f"burn_rate_{w_fast:g}s={bf:.2f} >= "
                          f"{fast_burn:g} (slow window "
                          f"{'confirms' if bs is not None else 'empty'})")
        for b in (bf, bs):
            if b is not None and b > SCALE_IN_MAX_BURN:
                all_cold = False
        if budget is not None and budget < SCALE_IN_MIN_BUDGET:
            all_cold = False
    worst = slo_report.get("worst_burn_rate")
    if flip_obj is not None:
        return {"action": "objective_flip", "objective": flip_obj,
                "reason": (f"{flip_obj} error budget exhausted "
                           "(budget_remaining <= 0): capacity alone "
                           "cannot un-burn history"),
                "budget_remaining": min_budget, "worst_burn_rate": worst}
    if out_obj is not None:
        return {"action": "scale_out", "objective": out_obj,
                "reason": out_reason,
                "budget_remaining": min_budget, "worst_burn_rate": worst}
    if all_cold:
        return {"action": "scale_in", "objective": min_budget_obj,
                "reason": (f"all window burns <= {SCALE_IN_MAX_BURN:g} "
                           f"and budgets >= {SCALE_IN_MIN_BUDGET:g}"),
                "budget_remaining": min_budget, "worst_burn_rate": worst}
    return {"action": "steady", "objective": min_budget_obj,
            "reason": "burn within budgeted pace",
            "budget_remaining": min_budget, "worst_burn_rate": worst}


def format_health(sentinels: Optional[Dict[str, Any]],
                  watermarks: Optional[Dict[str, Any]]) -> List[str]:
    """The `[health]` report lines (profile_report)."""
    lines: List[str] = []
    if sentinels is not None:
        nf = sentinels.get("nonfinite_steps", 0)
        lines.append(
            f"[health] sentinels: nonfinite_windows={nf} "
            f"grad_spikes={sentinels.get('grad_spikes', 0)} "
            f"loss_spikes={sentinels.get('loss_spikes', 0)}"
            + (" — NON-FINITE VALUES DETECTED" if nf else ""))
    if watermarks is not None and watermarks.get("peak_bytes"):
        mb = 1024 * 1024
        pred = watermarks.get("predicted_bytes")
        line = (f"[health] hbm peak/device: "
                f"{watermarks['peak_bytes'] / mb:.2f}MB")
        if pred:
            line += (f" vs predicted {pred / mb:.2f}MB "
                     f"(ratio {watermarks['ratio']:.2f}x)")
        lines.append(line)
        if watermarks.get("warn"):
            lines.append(
                f"[health] WARNING: peak memory "
                f"{watermarks['ratio']:.2f}x the predicted footprint "
                f"(> {watermarks['warn_ratio']:g}x) — the memory model "
                "under-predicts this config; re-check "
                "memory_stats()/OptMemSpec accounting")
    return lines
