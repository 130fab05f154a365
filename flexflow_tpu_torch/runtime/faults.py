"""Deterministic fault injection, the harness of every recovery path
(counterpart: flexflow_tpu/runtime/faults.py).

A `FaultPlan` arms named SITES to raise at chosen indices, and each
instrumented call site asks `check(site)` before it does the real work,
so an armed fault fires before any state is changed (safe to retry, even
though the port's optimizer updates in place).

Sites (`check` rejects unknown names, so a plan with a typo cannot
silently arm nothing):

  dataloader/transfer   host-to-device batch copy (the prefetch worker)
  checkpoint/write      checkpoint write and commit (caller or writer thread)
  fit/dispatch          train-step dispatch admission (index = global step)
  distributed/init      process-group start (runtime/distributed.py)
  pipe/boundary_hop     pipeline stage-boundary send (StageLink, one
                        index a hop this rank posts)
  health/nonfinite      NaN-poison the params before a step (index = the
                        1-based global step). NON-RAISING: fit asks
                        `poison()` and corrupts the params itself.
  serve/prefill         serving prefill dispatch (one index per admission
                        batch): a permanent fault fails that batch
  serve/decode_step     serving decode dispatch: a permanent fault evicts
                        the wedged slot, the rest keep serving
  serve/kv_admit        KV page reservation at admission (one index per
                        request): a permanent fault fails that request
  serve/param_swap      the hot-swap's snapshot read: a permanent fault
                        is a serve/swap_failed, the live version stays

Plan grammar (`FF_FAULT_PLAN` or `--fault-plan`, comma-separated):

  site@N        fail once at index N (1-based)
  site@N*T      fail T consecutive times from index N (transient: a
                retrying caller recovers once the T failures are spent)
  site@N!       fail EVERY time from index N on (permanent: retries burn
                their budget and the caller escalates)

The index is the site's own 1-based count of operations, except
`fit/dispatch` and `health/nonfinite`, where the caller passes the
1-based global step: "fail step 3" is `fit/dispatch@3` however the steps
batch into dispatches (K steps of a fused dispatch check steps i0+1 ..
i0+K before it launches). A retry re-checks the same index
(`run_resilient` allocates it once), so a plan counts operations, not
attempts.

The plan is process-global, as in JAX: `FF_FAULT_PLAN` is read when this
module is imported, `configure` replaces the plan, `clear` disarms it.
"""

from __future__ import annotations

import logging
import os
import re
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from flexflow_tpu_torch import telemetry as tel

_LOG = logging.getLogger("flexflow_tpu_torch")

SITES = (
    "dataloader/transfer",
    "checkpoint/write",
    "fit/dispatch",
    "distributed/init",
    "pipe/boundary_hop",
    "health/nonfinite",
    "serve/prefill",
    "serve/decode_step",
    "serve/kv_admit",
    "serve/param_swap",
)


class InjectedFault(RuntimeError):
    """A deterministic injected failure (transient unless Permanent)."""


class PermanentInjectedFault(InjectedFault):
    """An injected failure armed to outlast any retry budget."""


@dataclass
class FaultSpec:
    site: str
    at: int = 1            # first 1-based index that fires
    times: int = 1         # consecutive failures (ignored when permanent)
    permanent: bool = False
    fired: int = field(default=0, compare=False)

    def should_fire(self, idx: int) -> bool:
        if idx < self.at:
            return False
        return self.permanent or self.fired < self.times


# the plan: a list of FaultSpec (the JAX package has no other type)
FaultPlan = List[FaultSpec]

_SPEC_RE = re.compile(r"^(?P<site>[\w/._-]+)@(?P<at>\d+)"
                      r"(?:\*(?P<times>\d+))?(?P<perm>!)?$")


def parse_plan(spec: str) -> FaultPlan:
    """The plan grammar; unknown sites and malformed entries raise."""
    out: FaultPlan = []
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        m = _SPEC_RE.match(entry)
        if m is None:
            raise ValueError(
                f"bad fault spec {entry!r}: expected site@N, site@N*T or "
                f"site@N! (sites: {', '.join(SITES)})")
        site = m.group("site")
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} in {entry!r}; "
                             f"sites: {', '.join(SITES)}")
        out.append(FaultSpec(site=site, at=int(m.group("at")),
                             times=int(m.group("times") or 1),
                             permanent=bool(m.group("perm"))))
    return out


_LOCK = threading.Lock()
_SPECS: FaultPlan = []
_COUNTS: Dict[str, int] = {}
_FIRED: Dict[str, int] = {}

if os.environ.get("FF_FAULT_PLAN"):
    # a harness arms a worker process through its environment
    _SPECS = parse_plan(os.environ["FF_FAULT_PLAN"])


def configure(spec) -> None:
    """Arm a plan: a grammar string or a list of FaultSpec; a falsy value
    leaves the current plan as it is."""
    global _SPECS
    if not spec:
        return
    specs = parse_plan(spec) if isinstance(spec, str) else list(spec)
    with _LOCK:
        _SPECS = specs
        _COUNTS.clear()
        _FIRED.clear()


def clear() -> None:
    global _SPECS
    with _LOCK:
        _SPECS = []
        _COUNTS.clear()
        _FIRED.clear()


def active() -> bool:
    """One cheap read: hot loops guard their checks on it."""
    return bool(_SPECS)


def counts() -> Dict[str, int]:
    """Operations counted per site (retries of one operation re-check its
    index and do not count again)."""
    with _LOCK:
        return dict(_COUNTS)


def fired() -> Dict[str, int]:
    """Injected failures per site."""
    with _LOCK:
        return dict(_FIRED)


def next_index(site: str) -> int:
    """The next 1-based index of one real operation at `site`."""
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r}")
    with _LOCK:
        _COUNTS[site] = _COUNTS.get(site, 0) + 1
        return _COUNTS[site]


def _fire(site: str, index: Optional[int]):
    """(index, permanent) of the spec that fires at this operation, or
    None; counts the firing."""
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r}")
    if not _SPECS:
        return None
    idx = next_index(site) if index is None else int(index)
    with _LOCK:
        for spec in _SPECS:
            if spec.site == site and spec.should_fire(idx):
                spec.fired += 1
                _FIRED[site] = _FIRED.get(site, 0) + 1
                _LOG.info("fault injected at %s (index %d%s)", site, idx,
                          ", permanent" if spec.permanent else "")
                return idx, spec.permanent
    return None


def _emit(site: str, idx: int, permanent: bool, **extra) -> None:
    tel.event("fault/injected", cat="fault", site=site, index=idx,
              permanent=permanent, **extra)


def check(site: str, index: Optional[int] = None) -> None:
    """Raise the fault armed for `site` at this operation, if any. Called
    before the real work. `index` is the operation's index (run_resilient
    allocates it once per operation; fit passes the global step); a bare
    check allocates its own."""
    hit = _fire(site, index)
    if hit is None:
        return
    idx, permanent = hit
    _emit(site, idx, permanent)
    cls = PermanentInjectedFault if permanent else InjectedFault
    raise cls(f"injected fault at {site} (index {idx}"
              + (", permanent)" if permanent else ")"))


def poison(site: str, index: Optional[int] = None) -> bool:
    """The non-raising check: True when the fault armed for `site` fires
    at this operation (health/nonfinite: the caller corrupts the params
    itself and carries on). Emits the same fault/injected event as
    check()."""
    hit = _fire(site, index)
    if hit is None:
        return False
    _emit(site, hit[0], hit[1], poison=True)
    return True
