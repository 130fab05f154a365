"""The serving fleet: admission, router, in-process replicas, the
disaggregated prefill/decode handoff and the rolling hot-swap
(counterpart: flexflow_tpu/serving/fleet.py).

One engine and one `ContinuousBatchingScheduler` serve a card; this
module puts N such replicas behind ONE policy brain:

- `AdmissionControl` makes the shed-or-queue decisions (permanent sheds,
  queue-cap displacement, the deadline/TTFT-budget sweep). It decides
  only: whoever owns the request (a replica's scheduler, or the fleet
  before routing) sheds it and writes its terminal record.
- `FleetRouter` places each arrival by the replicas' live signals
  (outstanding work, then queue depth x the EMA prefill time: the same
  estimate the TTFT-budget shed prices), or round robin; with a burn
  ceiling, a replica burning its SLO error budget past it gets work only
  when every other one does too.
- Disaggregation (`topology="disagg"`): prefill replicas run only the
  prefill program and hand each committed slot to a decode replica
  through the host tier (`PagedKVCache.export_parked` / `import_parked`);
  the decode side adopts it as a parked slot, so its rejoin is bitwise
  the spill path and the streams equal the colocated ones.
- `RollingSwapController` rolls a new durable snapshot across the fleet
  one replica at a time, each flip at that replica's between-windows
  safe point (no request is dropped), and rolls a swapped replica back
  and freezes the rollout when its SLO worst burn rate crosses
  `burn_max`; with a ceiling, the next replica waits until the swapped
  one has been judged on requests it served after its swap.

In-process replicas share one card. Every device call of a replica (its
engine's, its cache's and its scheduler's own) runs under one fleet-wide
lock, and runs to completion inside it: the stream it was queued on is
synchronized before the lock is released. That keeps the kernel
wrappers' global launch counters (`launches += 1` from two threads can
lose a count) and the dequant kernel's workspace cache exact, and gives
each replica's work the same order on the card as on the JAX runtime,
which serializes its replicas the same way. One colocated replica takes
the plain scheduler's path: no proxy, no thread, no added sync.

Over a mesh (engines compiled over a process group, one process a GPU)
every rank runs the same fleet: the same replica threads, each replica
SPMD over the ranks on process groups of its own (serving/engine.py), and
every choice that reads a clock or a live signal is rank 0's, broadcast:
the card's lock grants in rank 0's order (`_Turnstile`: otherwise rank 0
could hold it inside replica A's all-reduce while rank 1 holds it inside
B's, and both wait for ever); the pump's arrival times and the router's
picks go on the fleet's control group, each drain of a replica's feed
takes as many items as rank 0's took (`_LockstepFeed`), and the handoff's
routes and the rolling swap's burn, bake and cursor verdicts go on the
replica's own group. Each rank's `decisions` then hold the same routing,
handoff and swap order, the report carries them (`stats["order"]`), and
rank 0 alone writes the trace export. The one-card path takes none of
this: no added collective, no added sync.

A replica thread's exception is recorded and re-raised by `serve` after
the join, so a failed replica never returns fewer requests quietly.
Histograms share fixed bucket edges, so the fleet's merge equals one
histogram fed the pooled samples; `merge_slo_trackers` does the same for
the SLO scoreboard.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.health import (SLOTracker,  # noqa: F401
                                       merge_slo_trackers, parse_slo,
                                       scaling_signal)
from flexflow_tpu_torch.runtime.distributed import (new_host_group, rank,
                                                    rank0_values)
from flexflow_tpu_torch.serving.reqtrace import (HIST_METRICS,
                                                 StreamingHistogram,
                                                 terminal_record)
from flexflow_tpu_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                                  Request, _urgency)

__all__ = [
    "AdmissionControl", "FleetRouter", "ReplicaHandle",
    "RollingSwapController", "ServingFleet", "merge_histograms",
    "merge_slo_trackers",
]


# ------------------------------------------------------------- admission
class AdmissionControl:
    """`pages_needed`/`capacity_pages` probe the KV cache;
    `overhead_tokens` is the dispatch-ahead and speculation slack every
    admission reserves."""

    def __init__(self, seq: int, max_context: int = 0, queue_cap: int = 0,
                 ttft_budget_ms: float = 0.0, overhead_tokens: int = 0,
                 pages_needed: Optional[Callable[[int], int]] = None,
                 capacity_pages: Optional[Callable[[], int]] = None):
        self.seq = int(seq)
        self.max_context = int(max_context or 0)
        self.queue_cap = int(queue_cap or 0)
        self.ttft_budget_ms = float(ttft_budget_ms or 0.0)
        self.overhead_tokens = int(overhead_tokens)
        self.pages_needed = pages_needed
        self.capacity_pages = capacity_pages

    def permanent_shed_reason(self, req: Request) -> Optional[str]:
        """A reason means the request can never be served (the fixed
        prefill window, the operator's context ceiling, or the pool's page
        capacity), as against backpressure, which queues."""
        if len(req.prompt) > self.seq:
            # the prefill window is fixed at `seq`; truncating would serve
            # a different request than the one sent
            return "prompt_too_long"
        if self.max_context and \
                len(req.prompt) + req.max_new_tokens > self.max_context:
            return "over_max_context"
        need = len(req.prompt) + req.max_new_tokens + self.overhead_tokens
        if self.pages_needed is not None and \
                self.pages_needed(need) > self.capacity_pages():
            return "prompt_too_long"
        return None

    def queue_or_displace(self, req: Request,
                          waiting: List[Request]) -> Optional[Request]:
        """Queue-cap shed-or-queue: returns the displaced victim (the least
        urgent waiter, or the arrival itself when nothing waiting is less
        urgent) for the caller to shed as `queue_full`; None means the
        arrival queued. Mutates `waiting`."""
        if self.queue_cap and len(waiting) >= self.queue_cap:
            worst = max(waiting, key=_urgency)
            if _urgency(req) < _urgency(worst):
                waiting.remove(worst)
                waiting.append(req)
                return worst
            return req
        waiting.append(req)
        return None

    def stale(self, waiting: List[Request], now_s: float,
              ema_serve_ms: float) -> List[Tuple[Request, str]]:
        """Deadline/TTFT-budget sweep: removes and returns the waiters that
        can no longer be served in time (their wait plus the EMA prefill
        time already exceeds the budget)."""
        out: List[Tuple[Request, str]] = []
        for r in list(waiting):
            waited_ms = 1e3 * (now_s - r.arrival_s)
            if r.deadline_s is not None and now_s > r.arrival_s + r.deadline_s:
                waiting.remove(r)
                out.append((r, "deadline"))
            elif self.ttft_budget_ms and \
                    waited_ms + ema_serve_ms > self.ttft_budget_ms:
                waiting.remove(r)
                out.append((r, "ttft_budget"))
        return out


# ------------------------------------------------------------ aggregation
def merge_histograms(hists) -> StreamingHistogram:
    """The exact cross-replica merge: with shared fixed edges the merged
    counts equal, bucket for bucket, one histogram fed the pooled
    samples."""
    out = StreamingHistogram()
    for h in hists:
        out.merge(h)
    return out


# ------------------------------------------------------------------ feed
class _Feed:
    """The thread-safe arrival feed the fleet pushes into and a replica's
    scheduler drains at the top of its loop (requests, and `(request,
    payload)` handoffs)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: List[Any] = []
        self.closed = False

    def push(self, item: Any) -> None:
        with self._lock:
            self._items.append(item)

    def drain(self) -> List[Any]:
        if not self._items:
            return []
        with self._lock:
            out, self._items = self._items, []
        return out

    @property
    def exhausted(self) -> bool:
        """Closed AND drained: nothing more can arrive. The scheduler loops
        on this, not on `closed`, so a close racing a push strands
        nothing."""
        return self.closed and not self._items

    def close(self) -> None:
        self.closed = True


class _LockstepFeed(_Feed):
    """A replica's feed over a mesh: each drain takes, on every rank, as
    many items as rank 0's took (one broadcast of the count and whether
    the feed was closed, on the replica's own group); a rank whose pump
    or handoffs are behind waits for them. Every rank pushes the same
    items in the same order (rank 0's routes), so the loops agree."""

    def __init__(self, group):
        super().__init__()
        self._group = group
        self._root = rank() == 0
        self._cond = threading.Condition(self._lock)
        self._done = False

    def push(self, item: Any) -> None:
        with self._cond:
            self._items.append(item)
            self._cond.notify_all()

    def drain(self) -> List[Any]:
        if self._root:
            with self._lock:
                closed = self.closed
                out, self._items = self._items, []
            rank0_values([len(out), closed], self._group)
        else:
            n, closed = rank0_values([0, 0], self._group)
            with self._cond:
                while len(self._items) < n:
                    self._cond.wait()
                out = self._items[:int(n)]
                del self._items[:int(n)]
        self._done = bool(closed)
        return out

    @property
    def exhausted(self) -> bool:
        """Rank 0's feed was closed at the last drain, which took all it
        held: nothing more can arrive, on any rank."""
        return self._done


# -------------------------------------------------------- shared runtime
class _Turnstile:
    """The fleet's device lock over a mesh: re-entrant, and granted in
    rank 0's order on every rank. On rank 0 a replica thread takes a plain
    lock and broadcasts its replica's index on the turnstile's group; on
    every other rank a receiver thread queues those grants, and a replica
    thread waits until the next grant is its replica's. A replica's calls
    come in the same order on every rank (the lockstep), so its k-th grant
    on rank 0 and on rank r are the same call. `bind(index)` names the
    replica of the calling thread."""

    def __init__(self, group):
        self._group = group
        self._root = rank() == 0
        self._lock = threading.Lock()
        self._cond = threading.Condition()
        self._grants: deque = deque()
        self._holder: Optional[int] = None
        self._depth = 0
        self._local = threading.local()
        self._receiver: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def bind(self, index: int) -> None:
        self._local.index = index

    def start(self) -> None:
        if not self._root:
            self._receiver = threading.Thread(
                target=self._receive, name="fleet-turnstile", daemon=True)
            self._receiver.start()

    def _receive(self) -> None:
        try:
            while True:
                index = int(rank0_values([0], self._group)[0])
                if index < 0:
                    return
                with self._cond:
                    self._grants.append(index)
                    self._cond.notify_all()
        except BaseException as e:  # noqa: BLE001 - raised by the waiters
            with self._cond:
                self._error = e
                self._cond.notify_all()

    def acquire(self) -> None:
        me = threading.get_ident()
        if self._holder == me:
            self._depth += 1
            return
        index = getattr(self._local, "index", None)
        if index is None:
            raise RuntimeError("fleet turnstile: a thread of no replica")
        if self._root:
            self._lock.acquire()
            self._holder, self._depth = me, 1
            rank0_values([index], self._group)
        else:
            with self._cond:
                while not (self._grants and self._grants[0] == index
                           and self._holder is None):
                    if self._error is not None:
                        raise RuntimeError("fleet turnstile: the grants "
                                           "stopped") from self._error
                    self._cond.wait()
                self._grants.popleft()
                self._holder, self._depth = me, 1

    def release(self) -> None:
        self._depth -= 1
        if self._depth:
            return
        self._holder = None
        if self._root:
            self._lock.release()
        else:
            with self._cond:
                self._cond.notify_all()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def close(self) -> None:
        """After every replica thread ended: the last grant (-1) ends the
        receivers."""
        if self._root:
            with self._lock:
                rank0_values([-1], self._group)
        elif self._receiver is not None:
            self._receiver.join()


def _run_to_completion(device: torch.device, *streams) -> None:
    """Wait, inside the fleet's lock, for the work a call queued: the
    calling thread's current stream (and `streams`)."""
    if device.type != "cuda":
        return
    torch.cuda.current_stream(device).synchronize()
    for s in streams:
        if s is not None:
            s.synchronize()


class _LockedKV:
    """A replica's KV cache with its device calls serialized under the
    fleet's lock and run to completion (its refill side stream included);
    the host bookkeeping (admit, free_slots, ...) stays lock-free: the
    pools are the replica's own."""

    # `evict` and `join` may queue a wait on a refill's event
    _DEVICE_CALLS = frozenset((
        "push", "commit_prefill", "spill", "prefetch", "join", "adopt",
        "sync_after", "export_parked", "import_parked", "evict"))

    def __init__(self, kv: Any, lock: threading.RLock):
        object.__setattr__(self, "_kv", kv)
        object.__setattr__(self, "_lock", lock)

    def __getattr__(self, name):
        val = getattr(self._kv, name)
        if name in self._DEVICE_CALLS and callable(val):
            kv, lock = self._kv, self._lock

            def locked(*a, __val=val, **kw):
                with lock:
                    out = __val(*a, **kw)
                    _run_to_completion(kv.device, kv._copy_stream)
                    return out
            return locked
        return val

    def __setattr__(self, name, value):
        setattr(self._kv, name, value)


class _SharedRuntimeEngine:
    """A replica's engine with its device calls serialized under the
    fleet-wide lock, each run to completion inside it."""

    _DEVICE_CALLS = frozenset((
        "prefill", "decode_step", "spec_round_step", "verify_step",
        "poll_swap", "hot_swap", "rollback", "load_params"))

    def __init__(self, eng: Any, lock: threading.RLock):
        self._eng = eng
        self._lock = lock
        self._kv: Optional[_LockedKV] = None

    def __getattr__(self, name):
        if name == "kv":
            if self._kv is None:
                self._kv = _LockedKV(self._eng.kv, self._lock)
            return self._kv
        val = getattr(self._eng, name)
        if name not in self._DEVICE_CALLS or not callable(val):
            return val
        lock, device = self._lock, self._eng.device

        def locked(*a, __val=val, **kw):
            with lock:
                out = __val(*a, **kw)
                _run_to_completion(device)
            return out
        return locked


# ---------------------------------------------------------------- replicas
@dataclasses.dataclass
class ReplicaHandle:
    """One replica: an engine, its scheduler (built per serve), its feed,
    and the live load signals the router reads (plain ints and list
    lengths, read across threads without locks). `error` holds the
    exception its thread died of."""

    index: int
    engine: Any
    role: str = "mixed"      # "mixed" | "prefill" | "decode"
    sched: Optional[ContinuousBatchingScheduler] = None
    feed: Optional[_Feed] = None
    thread: Optional[threading.Thread] = None
    assigned: int = 0
    error: Optional[BaseException] = None

    @property
    def finished(self) -> int:
        s = self.sched
        if s is None:
            return 0
        return (len(s.completed) + len(s.shed) + len(s.failed)
                + s.handoffs)

    @property
    def outstanding(self) -> int:
        return max(0, self.assigned - self.finished)

    def worst_burn(self) -> float:
        slo = getattr(self.engine, "slo", None)
        if slo is None or not slo.objectives:
            return 0.0
        burn = slo.report().get("worst_burn_rate")
        return float(burn) if burn is not None else 0.0


class FleetRouter:
    """Placement over live replica signals. `least_loaded` minimizes
    (outstanding work, estimated TTFT, index); the estimated TTFT is
    (1 + queue depth) x the replica's EMA prefill time. With a burn
    ceiling, a replica whose SLO worst burn rate crossed it is picked only
    when every alternative crossed too."""

    def __init__(self, policy: str = "least_loaded",
                 burn_max: float = 0.0):
        if policy not in ("least_loaded", "round_robin"):
            raise ValueError(f"unknown router policy {policy!r}")
        self.policy = policy
        self.burn_max = float(burn_max or 0.0)
        self._rr = 0

    def estimated_ttft_s(self, h: ReplicaHandle) -> float:
        s = h.sched
        ema_s = ((getattr(s, "_ema_serve_ms", 0.0) or 50.0) / 1e3
                 if s is not None else 0.05)
        depth = getattr(s, "queue_depth", 0) if s is not None else 0
        return (1.0 + depth) * ema_s

    def pick(self, handles: List[ReplicaHandle]) -> ReplicaHandle:
        if not handles:
            raise ValueError("router: empty replica pool")
        if self.policy == "round_robin":
            h = handles[self._rr % len(handles)]
            self._rr += 1
            return h
        return min(handles, key=lambda h: (
            (h.worst_burn() > self.burn_max) if self.burn_max else False,
            h.outstanding, self.estimated_ttft_s(h), h.index))


# ------------------------------------------------------------ rolling swap
class _ReplicaControl:
    """A replica's view of the rolling controller, installed as
    `scheduler.control`: the scheduler calls it at its between-windows
    safe point in place of the engine's own `poll_swap`."""

    __slots__ = ("_ctl", "_idx")

    def __init__(self, ctl: "RollingSwapController", idx: int):
        self._ctl = ctl
        self._idx = idx

    def at_safe_point(self, sched) -> bool:
        return self._ctl.at_safe_point(self._idx, sched)


class RollingSwapController:
    """Rolls a new snapshot across the fleet one replica at a time:
    replica k advances only after replicas 0..k-1 took it, each flip at
    that replica's safe point. A swapped replica whose SLO worst burn rate
    exceeds `burn_max` is rolled back to its previous version and the
    rollout FREEZES, so a bad model stops at one replica.

    With a burn ceiling and SLO objectives to judge by, a swap BAKES: the
    next replica may not swap until the swapped one has finished at least
    one request since its swap (a terminal record, or a handoff on a
    prefill replica) and reached a safe point with its burn under the
    ceiling (`bake_waits` counts the next replica's safe points held
    meanwhile). JAX's controller has no bake: there the next replica may
    swap before the first one's burn is judged. With nothing to judge by,
    the cursor moves at the swap, as in JAX.

    Over a mesh the fleet passes its turnstile as `lock` (the replicas
    reach their safe points in rank 0's order on every rank) and `agree`,
    which makes each verdict rank 0's: `agree(idx, code)` returns rank
    0's code for replica `idx` (a broadcast on its group)."""

    _ACTIONS = (None, "rollback", "bake_wait", "poll")

    def __init__(self, engines: List[Any], burn_max: float = 0.0,
                 lock: Any = None,
                 agree: Optional[Callable[[int, Tuple[int, int]],
                                          Tuple[int, int]]] = None):
        self.engines = list(engines)
        self.burn_max = float(burn_max or 0.0)
        self._lock = lock if lock is not None else threading.Lock()
        self._agree = agree
        self._cursor = 0
        # (replica, the requests it had finished at its swap)
        self._baking: Optional[Tuple[int, int]] = None
        self.bake_waits = 0
        self.halted = False
        self.swaps: List[Tuple[int, Optional[int]]] = []
        self.rollbacks: List[Tuple[int, Optional[int]]] = []

    def control(self, idx: int) -> _ReplicaControl:
        return _ReplicaControl(self, idx)

    def _judged_slo(self, eng):
        """The SLO tracker a swap of `eng` is judged by, or None."""
        slo = getattr(eng, "slo", None)
        if not self.burn_max or slo is None or not slo.objectives:
            return None
        return slo

    @staticmethod
    def _served(eng, sched) -> int:
        """Requests the replica has finished: its SLO tracker's terminal
        records, and what its scheduler handed off."""
        return eng.slo.requests + (sched.handoffs if sched is not None
                                   else 0)

    def _burned(self, eng) -> bool:
        slo = self._judged_slo(eng)
        if slo is None:
            return False
        burn = slo.report().get("worst_burn_rate")
        return burn is not None and burn > self.burn_max

    def _verdict(self, idx: int, sched) -> Tuple[int, int]:
        """(whether the swapped replica's bake ends, the action) at replica
        `idx`'s safe point, from the controller's state; nothing changes."""
        eng = self.engines[idx]
        swapped = any(r == idx for r, _ in self.swaps)
        rolled = any(r == idx for r, _ in self.rollbacks)
        if swapped and not rolled and self._burned(eng):
            return 0, self._ACTIONS.index("rollback")
        # served and judged under the ceiling since its swap
        unbake = int(self._baking is not None and self._baking[0] == idx
                     and self._served(eng, sched) > self._baking[1])
        if self.halted or idx != self._cursor % len(self.engines):
            return unbake, 0
        if self._baking is not None and not unbake:
            return unbake, self._ACTIONS.index("bake_wait")
        if not getattr(eng, "watching", False):
            return unbake, 0
        return unbake, self._ACTIONS.index("poll")

    def at_safe_point(self, idx: int, sched=None) -> bool:
        """Called by replica `idx` between dispatch windows. True iff its
        live params changed (a swap or a rollback): the scheduler then
        takes the engine's params."""
        with self._lock:
            verdict = self._verdict(idx, sched)
            if self._agree is not None:
                verdict = self._agree(idx, verdict)
            unbake, action = int(verdict[0]), self._ACTIONS[int(verdict[1])]
            eng = self.engines[idx]
            if action == "rollback":
                try:
                    eng.rollback()
                except ValueError:  # nothing retained to re-pin
                    return False
                self.halted = True
                self._baking = None
                ver = getattr(eng, "active_version", None)
                self.rollbacks.append((idx, ver))
                tel.event("serve/fleet_rollout", cat="serve", replica=idx,
                          action="rollback", version=ver)
                return True
            if unbake:
                self._baking = None
            if action == "bake_wait":
                self.bake_waits += 1
                return False
            if action != "poll" or not eng.poll_swap():
                return False
            self._cursor += 1
            if self._judged_slo(eng) is not None:
                self._baking = (idx, self._served(eng, sched))
            ver = getattr(eng, "active_version", None)
            self.swaps.append((idx, ver))
            tel.event("serve/fleet_rollout", cat="serve", replica=idx,
                      action="swap", version=ver)
            return True


# ------------------------------------------------------------------ fleet
class ServingFleet:
    """N replica engines behind one admission brain, one router and one
    rollout controller. `serve(requests)` runs the open-loop trace across
    the fleet and returns the completed requests; `shed`, `failed` and
    `stats` are the scheduler's fields, fleet-wide.

    Engines must be homogeneous (one compiled model); the disagg topology
    needs every replica built with `kv_host_pages > 0` (the handoff
    travels through the host tier on both sides), and over a mesh the
    same heads on every replica (`kv_shard_degree` and head placements).
    Over a mesh every rank builds and serves the same fleet (the module
    docstring); `decisions` holds the routes, handoffs and swaps in
    rank 0's order."""

    def __init__(self, engines: List[Any], prompt_inputs_fn: Callable,
                 step_inputs_fn: Callable, eos_id: Optional[int] = None,
                 topology: Optional[str] = None,
                 prefill_replicas: Optional[int] = None,
                 router: Any = None,
                 rollout_burn_max: Optional[float] = None,
                 **sched_kwargs: Any):
        if not engines:
            raise ValueError("ServingFleet needs at least one engine")
        meshed = [getattr(e, "mesh", None) is not None and e.mesh.size() > 1
                  for e in engines]
        if len(set(meshed)) > 1:
            raise ValueError("ServingFleet: every replica over the mesh or "
                             "none (replicas over a mesh: "
                             f"{[i for i, m in enumerate(meshed) if m]})")
        # over a mesh: the lockstep of the module docstring
        self.over_mesh = meshed[0]
        self.engines = list(engines)
        cfg = self.engines[0].cfg
        self.prompt_inputs_fn = prompt_inputs_fn
        self.step_inputs_fn = step_inputs_fn
        self.eos_id = eos_id
        self.sched_kwargs = dict(sched_kwargs)
        self.topology = (topology if topology is not None else
                         getattr(cfg, "serve_fleet_topology", "colocated")
                         ) or "colocated"
        if self.topology not in ("colocated", "disagg"):
            raise ValueError(f"unknown fleet topology {self.topology!r}")
        if isinstance(router, FleetRouter):
            self.router = router
        else:
            policy = (router or getattr(cfg, "serve_router", "least_loaded")
                      or "least_loaded")
            self.router = FleetRouter(policy)
        self.rollout_burn_max = float(
            rollout_burn_max if rollout_burn_max is not None
            else getattr(cfg, "serve_rollout_burn_max", 0.0) or 0.0)
        n = len(self.engines)
        if self.topology == "disagg":
            if n < 2:
                raise ValueError("disagg topology needs >= 2 replicas "
                                 "(one prefill + one decode minimum)")
            n_pre = int(prefill_replicas if prefill_replicas is not None
                        else getattr(cfg, "serve_prefill_replicas", 1) or 1)
            n_pre = max(1, min(n_pre, n - 1))
            roles = ["prefill"] * n_pre + ["decode"] * (n - n_pre)
            for eng in self.engines:
                if not getattr(eng.kv, "host_pages", 0):
                    raise ValueError(
                        "disagg topology: every replica needs "
                        "kv_host_pages > 0 (the KV handoff travels "
                        "through the host tier)")
            layouts = [eng.kv.head_layout() for eng in self.engines]
            if len(set(layouts)) > 1:
                raise ValueError(
                    "disagg topology: the replicas hold other KV heads "
                    "(kv_shard_degree, local heads, head placements): "
                    + ", ".join(f"replica {i} {lay}"
                                for i, lay in enumerate(layouts))
                    + "; a rank hands its own heads through its own host "
                    "tier, so every replica must hold the same")
        else:
            roles = ["mixed"] * n
        self.replicas = [ReplicaHandle(i, eng, roles[i])
                         for i, eng in enumerate(self.engines)]
        # fleet-level admission: permanent sheds are decided once, here,
        # before routing, by the class the replica loop uses
        eng0 = self.engines[0]
        seq = int(eng0.prefill_model.input_tensors[0].spec.shape[1])
        dispatch_ahead = max(1, int(self.sched_kwargs.get(
            "dispatch_ahead", 4)))
        spec_tokens = int(getattr(eng0, "spec_tokens", 0) or 0)
        self.admission = AdmissionControl(
            seq=seq,
            max_context=int(getattr(cfg, "serve_max_context", 0) or 0),
            overhead_tokens=dispatch_ahead + spec_tokens,
            pages_needed=eng0.kv.pages_needed,
            capacity_pages=eng0.kv.capacity_pages)
        self.slo = SLOTracker(parse_slo(getattr(cfg, "serve_slo", "")
                                        or ""))
        # serve_trace_out: the fleet exports ONE trace of the pool's
        # offered load; the replicas' own exports are cleared
        self.trace_out = str(getattr(cfg, "serve_trace_out", "") or "")
        self.rolling: Optional[RollingSwapController] = None
        self.completed: List[Request] = []
        self.shed: List[Request] = []
        self.failed: List[Request] = []
        self.stats: Dict[str, Any] = {}
        # the routes (request id, replica) in arrival order, each handoff's
        # decode replica by request id, and the rollout's swaps and
        # rollbacks: rank 0's order on every rank over a mesh
        self.decisions: Dict[str, Any] = {}
        self._shed_fleet: List[Request] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        # over a mesh: the control group (the pump's decisions) and the
        # turnstile's, made at the first threaded serve
        self._groups: Optional[Tuple[Any, Any]] = None
        self._run_lock: Any = None

    # ----------------------------------------------------------- plumbing
    def _build_sched(self, h: ReplicaHandle,
                     handoff: Optional[Callable] = None,
                     engine: Any = None,
                     exec_lock: Optional[threading.RLock] = None
                     ) -> ContinuousBatchingScheduler:
        eng = engine if engine is not None else h.engine
        sched = ContinuousBatchingScheduler(
            eng, eng.params, self.prompt_inputs_fn,
            self.step_inputs_fn, eos_id=self.eos_id, handoff=handoff,
            exec_lock=exec_lock, **self.sched_kwargs)
        if len(self.replicas) > 1:
            # one trace for the pool (serve() exports it), not N partials
            sched.trace_out = ""
        h.sched = sched
        return sched

    def _route_handoff(self, req: Request, payload: Dict,
                       src: Optional[ReplicaHandle] = None) -> None:
        """From a prefill replica's thread: deliver the committed K/V to
        the router's pick of the decode replicas (over a mesh rank 0's,
        broadcast on the prefill replica `src`'s group)."""
        pool = [x for x in self.replicas if x.role == "decode"]
        if self.over_mesh:
            pick = 0
            if rank() == 0:
                with self._lock:
                    pick = pool.index(self.router.pick(pool))
            h = pool[int(rank0_values([pick], src.engine.host_group)[0])]
            with self._lock:
                h.assigned += 1
        else:
            with self._lock:
                h = self.router.pick(pool)
                h.assigned += 1
        self.decisions["handoffs"][req.rid] = h.index
        h.feed.push((req, payload))

    def _arrival(self, req: Request, pool: List[ReplicaHandle]
                 ) -> Tuple[Optional[ReplicaHandle], float]:
        """The pump at one arrival: wait for it, then its replica (None:
        shed by fleet admission) and the time. Over a mesh rank 0 waits
        and picks, and every rank takes its pick and its time (one
        broadcast on the fleet's control group)."""
        if self.over_mesh and rank() != 0:
            pick, now = rank0_values([0, 0], self._groups[0])
            h = None if pick < 0 else self.replicas[int(pick)]
            if h is not None:
                with self._lock:
                    h.assigned += 1
            return h, now
        delay = self._t0 + req.arrival_s - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        now = time.perf_counter() - self._t0
        h = None
        if self.admission.permanent_shed_reason(req) is None:
            with self._lock:
                h = self.router.pick(pool)
                h.assigned += 1
        if self.over_mesh:
            rank0_values([-1 if h is None else h.index, now], self._groups[0])
        return h, now

    def _device_lock(self):
        """The lock every device call of every replica runs under: over a
        mesh the turnstile (rank 0's grant order)."""
        if not self.over_mesh:
            return threading.RLock()
        if self._groups is None:
            self._groups = (new_host_group(), new_host_group())
        return _Turnstile(self._groups[1])

    def _agree(self, idx: int, verdict: Tuple[int, int]) -> Tuple[int, int]:
        """Rank 0's rollout verdict for replica `idx`, on its group."""
        got = rank0_values(verdict, self.replicas[idx].engine.host_group)
        return int(got[0]), int(got[1])

    def _fleet_shed(self, req: Request, reason: str, now_s: float) -> None:
        req.outcome = "shed"
        req.shed_reason = reason
        req.finish_s = now_s
        self._shed_fleet.append(req)
        rec = terminal_record(req, now_s, 0, reason)
        self.slo.observe(rec)
        tel.event("serve/request_shed", cat="serve", reason=reason,
                  fleet=True, **rec)

    def _replica_main(self, h: ReplicaHandle) -> None:
        try:
            bind = getattr(self._run_lock, "bind", None)
            if bind is not None:
                bind(h.index)
            h.sched.run([])
        except BaseException as e:  # noqa: BLE001 - re-raised by serve()
            h.error = e

    # --------------------------------------------------------------- serve
    def serve(self, requests: List[Request],
              watch_root: Optional[str] = None,
              poll_interval_s: float = 0.05) -> List[Request]:
        """Serve the open-loop trace (`arrival_s` offsets) across the
        fleet; returns the completed requests fleet-wide. `watch_root` arms
        the rolling swap: every replica watches the durable-snapshot root
        and the `RollingSwapController` advances them one at a time. An
        exception a replica's thread raised is raised here, after every
        thread has been joined."""
        self.completed, self.shed, self.failed = [], [], []
        self._shed_fleet = []
        self.decisions = {"routes": [], "handoffs": {}, "swaps": [],
                          "rollbacks": []}
        for h in self.replicas:
            h.assigned = 0
            h.error = None
        if watch_root is not None:
            for h in self.replicas:
                h.engine.watch(watch_root, poll_interval_s=poll_interval_s)
        self._t0 = time.perf_counter()
        if len(self.replicas) == 1 and self.topology == "colocated":
            # one replica IS the plain scheduler: no feed, no thread, no
            # proxy, no added sync
            h = self.replicas[0]
            sched = self._build_sched(h)
            h.assigned = len(requests)
            sched.run(list(requests))
            self._collect()
            return list(self.completed)
        # the replicas share the card: every device call of every replica
        # is serialized under this lock and run to completion inside it
        run_lock = self._run_lock = self._device_lock()
        proxies = [_SharedRuntimeEngine(h.engine, run_lock)
                   for h in self.replicas]
        self.rolling = (RollingSwapController(
            proxies, burn_max=self.rollout_burn_max,
            **(dict(lock=run_lock, agree=self._agree) if self.over_mesh
               else {}))
            if watch_root is not None else None)
        prefill_pool = [h for h in self.replicas if h.role != "decode"]
        decode_pool = [h for h in self.replicas if h.role != "prefill"]
        for h, proxy in zip(self.replicas, proxies):
            handoff = (
                (lambda req, payload, h=h: self._route_handoff(req, payload,
                                                               h))
                if h.role == "prefill" else None)
            sched = self._build_sched(h, handoff=handoff, engine=proxy,
                                      exec_lock=run_lock)
            h.feed = (_LockstepFeed(h.engine.host_group) if self.over_mesh
                      else _Feed())
            sched.feed = h.feed
            if self.rolling is not None:
                sched.control = self.rolling.control(h.index)
            h.thread = threading.Thread(
                target=self._replica_main, args=(h,),
                name=f"fleet-replica-{h.index}", daemon=True)
        # The KV tier's refill stream waits on the CURRENT stream of the
        # thread that queues it, and the current stream is per thread: a
        # replica thread starts on the device's default stream, the one
        # its engine and cache were built and served on, and must never
        # run under another `torch.cuda.stream(...)` context.
        start = getattr(run_lock, "start", None)
        if start is not None:
            start()
        for h in self.replicas:
            h.thread.start()
        # the pump: fleet admission and routing at each request's arrival
        for req in sorted(requests, key=lambda r: (r.arrival_s, r.rid)):
            h, now = self._arrival(req, prefill_pool)
            if h is None:
                self._fleet_shed(req, self.admission.permanent_shed_reason(
                    req), now)
                continue
            self.decisions["routes"].append((req.rid, h.index))
            h.feed.push(req)
        # drain the prefill replicas first: their handoffs feed the decode
        # pool
        stages = ([prefill_pool, decode_pool] if self.topology == "disagg"
                  else [self.replicas])
        for pool in stages:
            for h in pool:
                h.feed.close()
            for h in pool:
                h.thread.join()
        close = getattr(run_lock, "close", None)
        if close is not None:
            close()
        self._collect()
        if self.trace_out and requests and (not self.over_mesh
                                            or rank() == 0):
            from flexflow_tpu_torch.serving import tracefmt
            tracefmt.save_trace(
                self.trace_out,
                tracefmt.requests_to_records(
                    sorted(requests, key=lambda r: (r.arrival_s, r.rid))),
                meta={"source": "fleet", "replicas": len(self.replicas),
                      "topology": self.topology})
        for h in self.replicas:
            if h.error is not None:
                raise h.error
        return list(self.completed)

    # ------------------------------------------------------------- results
    def _collect(self) -> None:
        wall = max(1e-9, time.perf_counter() - self._t0)
        self.completed = []
        self.shed = list(self._shed_fleet)
        self.failed = []
        per: List[Dict[str, Any]] = []
        handoffs = swaps = 0
        for h in self.replicas:
            s = h.sched
            if s is None:
                continue
            self.completed.extend(s.completed)
            self.shed.extend(s.shed)
            self.failed.extend(s.failed)
            handoffs += s.handoffs
            swaps += s.stats.get("swaps", 0)
            toks = sum(len(r.tokens) for r in s.completed)
            row = {"replica": h.index, "role": h.role,
                   "assigned": h.assigned, "completed": len(s.completed),
                   "shed": len(s.shed), "failed": len(s.failed),
                   "handoffs": s.handoffs, "tokens_out": toks,
                   "tokens_per_s": toks / wall,
                   "queue_depth": s.queue_depth,
                   "active_slots": s.active_count,
                   "swaps": s.stats.get("swaps", 0),
                   "swap_version": getattr(h.engine, "active_version",
                                           None)}
            per.append(row)
            tel.event("serve/fleet_replica", cat="serve", **row)
        self.completed.sort(key=lambda r: r.rid)
        total_toks = sum(len(r.tokens) for r in self.completed)
        self.stats = {
            "replicas": len(self.replicas), "topology": self.topology,
            "completed": len(self.completed), "shed": len(self.shed),
            "failed": len(self.failed), "handoffs": handoffs,
            "swaps": swaps, "tokens_out": total_toks,
            "tokens_per_s": total_toks / wall, "wall_s": wall,
            "per_replica": per,
        }
        if self.rolling is not None:
            self.stats["rollout_swaps"] = len(self.rolling.swaps)
            self.stats["rollout_rollbacks"] = len(self.rolling.rollbacks)
            self.stats["rollout_halted"] = self.rolling.halted
            self.decisions["swaps"] = list(self.rolling.swaps)
            self.decisions["rollbacks"] = list(self.rolling.rollbacks)
        if self.over_mesh:
            self.stats["order"] = self.decisions
        tel.event("serve/fleet", cat="serve",
                  **{k: v for k, v in self.stats.items()
                     if k not in ("per_replica", "order")})

    def report(self) -> Dict[str, Any]:
        """Fleet-wide observability: the exact cross-replica histogram
        merges and the SLO scoreboard of one tracker fed the union of every
        replica's terminal records, with the scaling signal it gives."""
        hists: Dict[str, Any] = {}
        for m in HIST_METRICS:
            hs = [h.sched.tracer.hists[m] for h in self.replicas
                  if h.sched is not None and h.sched.tracer is not None]
            hs = [h for h in hs if h.count]
            if hs:
                merged = merge_histograms(hs)
                hists[m] = {"count": merged.count,
                            "mean": merged.mean(),
                            "p50": merged.quantile(0.5),
                            "p99": merged.quantile(0.99)}
        trackers = [getattr(h.engine, "slo", None) for h in self.replicas]
        merged_slo = merge_slo_trackers(trackers + [self.slo])
        slo_report = merged_slo.report()
        return {"stats": dict(self.stats), "hists": hists,
                "slo": slo_report, "scaling": scaling_signal(slo_report)}
