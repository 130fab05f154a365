"""Serving SLOs: the objective grammar and the error-budget tracker
(counterpart: flexflow_tpu/health.py, `parse_slo` and `SLOTracker`).

`--serve-slo` is a comma-separated list of objectives, e.g.
"ttft_p99_ms=25,per_token_p99_ms=10,availability=0.999". Latency
objectives are `<metric>_p<PP>_ms` over the terminal records' `ttft_s`,
`per_token_s` or `queue_wait_s` fields, and their error budget is the
complement of the percentile (p99: 1% of requests may exceed the
threshold). `availability=<frac>` budgets the outcomes other than "done"
(sheds, failures and watchdog timeouts all count against it).

The rest of the JAX module (goodput, numerics sentinels, HBM watermarks,
hot-swap stats, the scaling signal) is not ported yet.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
