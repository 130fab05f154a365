"""Replayable request traces (counterpart: flexflow_tpu/serving/tracefmt.py,
whose file format this is, byte for byte: either package reads the
other's traces).

One versioned JSONL schema of request arrivals, shared by live serving
(`serve_trace_out` exports the traffic a scheduler saw), the open-loop
generators (`poisson_records`, `burst_records`) and replay
(`records_to_requests`). Line 1 is a HEADER object with `schema_version`,
`kind` and a free-form `meta` dict; every following line is one request:

    {"arrival_ts": 0.012, "tokens_in": 8, "max_tokens": 4,
     "priority": 1, "deadline": null, "rid": 0, "prompt": [17, 3, ...]}

`arrival_ts` is seconds from the trace start, `tokens_in` the prompt
length, `max_tokens` the decode budget, `deadline` seconds from arrival
or null, `prompt` the optional token ids (with them a replay through a
live engine is bitwise). An unknown `schema_version` is rejected; unknown
record fields are ignored; malformed lines are skipped and counted
(`Trace.skipped`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

log = logging.getLogger("flexflow_tpu_torch")

SCHEMA_VERSION = 1
TRACE_KIND = "flexflow_request_trace"

# required per-record fields (the twin prices these; everything else is
# optional provenance)
REQUIRED_FIELDS = ("arrival_ts", "tokens_in", "max_tokens")


@dataclasses.dataclass
class TraceRecord:
    """One request arrival. `prompt` rides along on synthetic/recorded
    traces that need bitwise live replay; the twin ignores it."""

    arrival_ts: float
    tokens_in: int
    max_tokens: int
    priority: int = 1
    deadline: Optional[float] = None
    rid: Optional[int] = None
    prompt: Optional[List[int]] = None

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "arrival_ts": self.arrival_ts,
            "tokens_in": self.tokens_in,
            "max_tokens": self.max_tokens,
            "priority": self.priority,
            "deadline": self.deadline,
        }
        if self.rid is not None:
            out["rid"] = self.rid
        if self.prompt is not None:
            out["prompt"] = list(self.prompt)
        return out

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TraceRecord":
        # forward-compatible: unknown fields are ignored, never fatal
        prompt = d.get("prompt")
        return cls(
            arrival_ts=float(d["arrival_ts"]),
            tokens_in=int(d["tokens_in"]),
            max_tokens=int(d["max_tokens"]),
            priority=int(d.get("priority", 1)),
            deadline=(None if d.get("deadline") is None
                      else float(d["deadline"])),
            rid=(None if d.get("rid") is None else int(d["rid"])),
            prompt=(None if prompt is None else [int(t) for t in prompt]),
        )


@dataclasses.dataclass
class Trace:
    records: List[TraceRecord]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    skipped: int = 0  # malformed lines dropped by the loader

    def __len__(self) -> int:
        return len(self.records)


# ------------------------------------------------------------------- io
def save_trace(path: str, records: Sequence[TraceRecord],
               meta: Optional[Dict[str, Any]] = None) -> str:
    """Write a trace atomically (tmp + rename). Serialization is
    deterministic (sorted keys, no whitespace variance), so identical
    records round-trip to identical bytes — the bitwise
    generate -> save -> load -> save pin in tests."""
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    header = {"schema_version": SCHEMA_VERSION, "kind": TRACE_KIND,
              "meta": dict(meta or {})}
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(header, sort_keys=True,
                           separators=(",", ":")) + "\n")
        for r in records:
            f.write(json.dumps(r.to_json(), sort_keys=True,
                               separators=(",", ":")) + "\n")
    os.replace(tmp, path)
    return path


def load_trace(path: str) -> Trace:
    """Load a trace file. Raises ValueError on a missing/alien header or
    an unknown schema_version; skips (and counts) malformed record
    lines."""
    with open(path) as f:
        first = f.readline()
        try:
            header = json.loads(first)
            if not isinstance(header, dict):
                raise ValueError("header is not an object")
        except ValueError:
            raise ValueError(
                f"{path}: not a {TRACE_KIND} (line 1 must be a JSON header "
                "with schema_version)") from None
        ver = header.get("schema_version")
        if ver != SCHEMA_VERSION:
            raise ValueError(
                f"{path}: unknown trace schema_version {ver!r} (this build "
                f"reads version {SCHEMA_VERSION}; re-record the trace or "
                "upgrade flexflow_tpu_torch)")
        records: List[TraceRecord] = []
        skipped = 0
        for lineno, line in enumerate(f, start=2):
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
                if not isinstance(d, dict):
                    raise ValueError("record is not an object")
                for k in REQUIRED_FIELDS:
                    if k not in d:
                        raise ValueError(f"missing field {k!r}")
                records.append(TraceRecord.from_json(d))
            except (ValueError, TypeError) as e:
                skipped += 1
                log.warning("%s:%d: skipping malformed trace line (%s)",
                            path, lineno, e)
    return Trace(records=records, meta=dict(header.get("meta") or {}),
                 skipped=skipped)


# ----------------------------------------------------------- generators
def poisson_records(rng: np.random.Generator, n: int, rate: float,
                    vocab: int, prompt_len: int, max_new: int,
                    priorities: Sequence[int] = (1,),
                    deadline_s: Optional[float] = None,
                    t0: float = 0.0) -> List[TraceRecord]:
    """Open-loop Poisson arrivals as a trace. The draw order is the JAX
    package's (one exponential gap vector, then one prompt a request), so
    one `np.random.Generator` seed gives the same records in both."""
    arrivals = t0 + np.cumsum(rng.exponential(1.0 / rate, size=n))
    return [TraceRecord(arrival_ts=float(arrivals[i]),
                        tokens_in=prompt_len,
                        max_tokens=max_new,
                        priority=int(priorities[i % len(priorities)]),
                        deadline=deadline_s,
                        rid=i,
                        prompt=[int(t) for t in
                                rng.integers(1, vocab, size=prompt_len)])
            for i in range(n)]


def burst_records(rng: np.random.Generator, n_base: int, base_rate: float,
                  burst_factor: float, burst_frac: float, vocab: int,
                  prompt_len: int, max_new: int) -> List[TraceRecord]:
    """A steady-state segment followed by a `burst_factor` x arrival-rate
    burst covering the last `burst_frac` of requests — the autoscale
    leg's 10x-burst scenario, as a plain trace."""
    n_burst = max(1, int(n_base * burst_frac))
    steady = poisson_records(rng, n_base, base_rate, vocab, prompt_len,
                             max_new)
    t_end = steady[-1].arrival_ts if steady else 0.0
    burst = poisson_records(rng, n_burst, base_rate * burst_factor, vocab,
                            prompt_len, max_new, t0=t_end)
    for i, r in enumerate(burst):
        r.rid = n_base + i
    return steady + burst


def scale_rate(records: Sequence[TraceRecord],
               factor: float) -> List[TraceRecord]:
    """The same arrival PROCESS at `factor` x the offered load: divide
    every arrival timestamp by the factor (inter-arrival gaps shrink,
    ordering and request shapes stay identical). The capacity-curve
    bisection sweeps this knob."""
    if factor <= 0:
        raise ValueError(f"scale_rate: factor must be > 0, got {factor}")
    return [dataclasses.replace(r, arrival_ts=r.arrival_ts / factor)
            for r in records]


# ---------------------------------------------------------- conversions
def records_to_requests(records: Sequence[TraceRecord],
                        vocab: Optional[int] = None,
                        seed: int = 0) -> List[Any]:
    """Serving `Request`s from trace records — the live-replay direction.
    Records without a stored prompt get a deterministic filler prompt
    (seeded per record) of the recorded length; `vocab` is required then."""
    from flexflow_tpu_torch.serving.scheduler import Request

    out = []
    for i, r in enumerate(records):
        if r.prompt is not None:
            prompt = list(r.prompt)
        else:
            if not vocab:
                raise ValueError(
                    "records_to_requests: trace has no stored prompts; "
                    "pass vocab= to synthesize filler tokens")
            prng = np.random.default_rng(
                seed + (r.rid if r.rid is not None else i))
            prompt = [int(t) for t in
                      prng.integers(1, vocab, size=r.tokens_in)]
        out.append(Request(rid=(r.rid if r.rid is not None else i),
                           prompt=prompt,
                           max_new_tokens=r.max_tokens,
                           arrival_s=r.arrival_ts,
                           priority=r.priority,
                           deadline_s=r.deadline))
    return out


def requests_to_records(requests: Iterable[Any],
                        include_prompts: bool = True) -> List[TraceRecord]:
    """Trace records from serving `Request`s — the live-export direction
    (`--serve-trace-out`). Captures arrival-time/shape/class, optionally
    the prompt ids (so the recorded trace replays bitwise through a live
    engine, not just the twin)."""
    return [TraceRecord(arrival_ts=float(r.arrival_s),
                        tokens_in=len(r.prompt),
                        max_tokens=int(r.max_new_tokens),
                        priority=int(r.priority),
                        deadline=(None if r.deadline_s is None
                                  else float(r.deadline_s)),
                        rid=int(r.rid),
                        prompt=(list(r.prompt) if include_prompts else None))
            for r in requests]
