"""Continuous-batching scheduler over the serving programs
(counterpart: flexflow_tpu/serving/scheduler.py).

Policy, as in the JAX package:

- ADMISSION: at every sync point, waiting requests are placed into free
  decode slots, most urgent first (`priority`, lower = more urgent, ties
  by arrival), as far as pages allow (a short free list is backpressure:
  the request stays queued). `prefill_chunk_tokens` caps the summed
  prompt length of one admission wave, so a burst of long prompts spreads
  over several prefill batches. Admitted prompts are right-padded into
  the `[slots, S]` prefill batch at their slot's row, run through the
  prefill program once ("prefill-then-join"), their K/V committed into
  the paged cache, and their first token (argmax of the logits at
  `lengths - 1`) recorded as time-to-first-token.
- DECODE: between sync points the host dispatches up to `dispatch_ahead`
  (default 4) single-token steps without synchronizing: each step's argmax
  feeds the next step as a device tensor. The window is capped at the smallest
  remaining token budget across active slots; an EOS finish inside a
  window is masked out of the committed KV advance
  (`sync_after(advances=...)`) and counted as `overdecode_tokens`.
- EVICTION: at sync points, slots whose sequence hit EOS or max-new are
  evicted (pages freed).
- SHED-OR-QUEUE (`fleet.AdmissionControl`): prompts longer than the
  prefill window or needing more pages than the pool holds shed as
  `prompt_too_long`, prompt + budget over `serve_max_context` as
  `over_max_context`; with `serve_queue_cap`, an arrival into a full
  queue sheds the least urgent waiter (or itself) as `queue_full`; with
  `serve_ttft_budget_ms`, a waiter whose wait plus the EMA prefill time
  blows the budget sheds as `ttft_budget`; a waiter past its
  `deadline_s` as `deadline`.
- WATCHDOG: with `serve_decode_timeout_ms`, a window slower than the
  budget per step evicts the longest-resident slot (outcome "timeout").
- SPECULATION: when the engine carries a draft (`compile_serving(...,
  draft=, spec_tokens=K)`), every decode is a round: K chained draft
  steps and one verify pass on the device (`engine.spec_round_step`),
  one host sync, then the longest accepted prefix is committed. The page
  reservation grows by K, and the draft's cache mirrors every admit,
  prefill and evict of the target's.

- FAULTS: KV admission, prefill and decode dispatch run under
  `run_resilient` with the scheduler's retry policy (`retry_policy=`, or
  the config's `RetryPolicy.from_config`) as the fault sites
  `serve/kv_admit`, `serve/prefill` and `serve/decode_step`
  (runtime/faults.py). A transient fault costs a retry; a permanent one
  fails only what it hit, outcome "failed": a kv_admit escalation that
  request, a prefill escalation the batch being admitted (its pages
  freed), a decode escalation the wedged slot (the window dispatched
  before it is drained first). The engine keeps serving in every case.

- TIERED KV (`kv_host_pages` > 0): a parked request keeps its slot id
  while its K/V sits in the host tier. When pages are short at admission,
  `_make_room` spills active slots (the largest remaining decode budget
  first). At each sync point with no window in flight `_rotate` issues
  refills for parked slots (in park order, as far as device pages allow)
  and rejoins those whose refill has had `prefetch_ahead` decode steps
  (or at once when nothing else is active, a counted stall). A rejoin
  re-seeds the slot's next token with its last committed one, which keeps
  the streams bitwise those of an untiered run.
- HOT-SWAP: when the engine `watch`es a snapshot root, the loop calls
  `engine.poll_swap()` only while no window is dispatched, so the swap's
  pointer flip falls between decode steps (`stats["swaps"]`).
- REQUEST TRACING (`serve_reqtrace`, on by default): a
  `reqtrace.RequestTracer` sees only timestamps the loop already took at
  its sync points, so it adds no host sync; its histograms are published
  (`serve/hist`) at the end of a run.
- TRACE EXPORT (`serve_trace_out`): the offered load is written as a
  replayable `tracefmt` trace at the end of `run()`.

Every outcome ends in one terminal record (`reqtrace.terminal_record`),
which the engine's SLO tracker classifies and which rides the telemetry
event of the outcome (`serve/request_done`, `_shed`, `_failed`; and
`serve/request_admitted`, `serve/slot_evicted`, `serve/decode_timeout`,
`serve/slot_parked`, `serve/slot_rejoined`, `serve/kv_prefetch_autotune`,
the counters `serve/queue_depth`, `serve/active_slots`,
`serve/overdecode_tokens`, `serve/spec_*`, `serve/kv_tier_*`,
`serve/kv_prefetch_*`, `serve/kv_spills`, and `serve/slo` at the end of a
run), as in JAX.

FLEET HOOKS (`fleet.ServingFleet` drives N of these loops): `feed`, a
thread-safe arrival feed drained at the top of the loop (the loop runs
until it is exhausted); `control`, the rolling swap's per-replica view,
called at the between-windows safe point in place of the engine's own
`poll_swap`; and `handoff=`, which makes this a prefill-only replica:
right after its first-token sync every admitted slot is spilled, its
K/V exported, the slot evicted and the request handed to the callback
(`handoffs` counts them), while a decode replica adopts what its feed
delivers as parked slots (`_ingest_handoffs`). Under a fleet, the
scheduler is built with `exec_lock=`, the fleet-wide lock: its own device
calls (the argmax, the syncs that read tokens back, the host-to-device
copies) then run under it, each to completion inside it. All default to
off: a standalone scheduler (no lock) runs the loop above unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.device import to_device_async
from flexflow_tpu_torch.runtime.resilience import RetryPolicy, run_resilient
from flexflow_tpu_torch.serving.kv_cache import (POS_KEY, KVPoolExhausted,
                                                 derive_prefetch_ahead,
                                                 learned_kv_transfer_seconds)
from flexflow_tpu_torch.serving.reqtrace import RequestTracer, terminal_record

_LOG = logging.getLogger("flexflow_tpu_torch")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival_s: float = 0.0        # offset from scheduler start (open loop)
    priority: int = 1             # SLO class, lower = more urgent
    deadline_s: Optional[float] = None  # TTFT deadline (after arrival)
    # filled by the scheduler:
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None
    admit_s: Optional[float] = None  # prefill dispatch (queue wait ends)
    finish_s: Optional[float] = None
    slot: Optional[int] = None
    outcome: str = ""             # "done" | "shed" | "timeout" | "failed"
    shed_reason: str = ""


def gpt2_prompt_inputs(ids: np.ndarray, lengths: np.ndarray) -> List[np.ndarray]:
    """gpt2 prefill inputs: token ids + positions 0..S-1."""
    pos = np.broadcast_to(np.arange(ids.shape[1], dtype=np.int32), ids.shape)
    return [ids.astype(np.int32), np.ascontiguousarray(pos)]


def gpt2_step_inputs(tokens, state) -> List[Any]:
    """gpt2 decode inputs: next token ids + the device-side positions (the
    index each slot's token is written at; no host sync to build them).
    Token i of a `[slots, s]` step sits at position pos+i."""
    pos = state[POS_KEY][:, None]
    s = int(tokens.shape[1])
    if s > 1:
        pos = pos + torch.arange(s, dtype=pos.dtype, device=pos.device)[None, :]
    return [tokens, pos]


def _urgency(r: Request):
    return (r.priority, r.arrival_s, r.rid)


class ContinuousBatchingScheduler:
    def __init__(self, engine, params, prompt_inputs_fn: Callable,
                 step_inputs_fn: Callable, eos_id: Optional[int] = None,
                 dispatch_ahead: int = 4,
                 ttft_budget_ms: Optional[float] = None,
                 queue_cap: Optional[int] = None,
                 decode_timeout_ms: Optional[float] = None,
                 prefill_chunk_tokens: int = 0,
                 retry_policy: Optional[RetryPolicy] = None,
                 reqtrace: Optional[bool] = None,
                 handoff: Optional[Callable] = None,
                 exec_lock: Optional[threading.RLock] = None):
        from flexflow_tpu_torch.serving.fleet import AdmissionControl

        self.engine = engine
        self.params = params
        self.prompt_inputs_fn = prompt_inputs_fn
        self.step_inputs_fn = step_inputs_fn
        self.eos_id = eos_id
        self.dispatch_ahead = max(1, int(dispatch_ahead))
        self.kv = engine.kv
        self.slots = engine.slots
        self.device = engine.device
        self.seq = int(engine.prefill_model.input_tensors[0].spec.shape[1])
        cfg = engine.cfg
        self.ttft_budget_ms = float(
            ttft_budget_ms if ttft_budget_ms is not None
            else getattr(cfg, "serve_ttft_budget_ms", 0.0))
        self.queue_cap = int(queue_cap if queue_cap is not None
                             else getattr(cfg, "serve_queue_cap", 0))
        self.decode_timeout_ms = float(
            decode_timeout_ms if decode_timeout_ms is not None
            else getattr(cfg, "serve_decode_timeout_ms", 0.0))
        self.prefill_chunk_tokens = max(0, int(prefill_chunk_tokens))
        self.max_context = int(getattr(cfg, "serve_max_context", 0) or 0)
        self.retry_policy = (retry_policy if retry_policy is not None
                             else RetryPolicy.from_config(cfg))
        self.completed: List[Request] = []
        self.shed: List[Request] = []
        self.failed: List[Request] = []
        # speculation: the draft's paged cache mirrors every admit,
        # prefill commit and evict of the target's
        self.spec_tokens = int(getattr(engine, "spec_tokens", 0) or 0)
        self.draft = getattr(engine, "draft", None)
        self._spec = self.spec_tokens > 0 and self.draft is not None
        if self._spec and self.draft.params is None:
            raise ValueError(
                "speculative scheduler: draft engine has no params (call "
                "engine.draft.init() or engine.draft.load_params first)")
        self._accept_ema = 0.0
        # tiered KV cache: prefetch_ahead is the hit/stall classifier and
        # the lead the rotation aims for; a learned transfer time would
        # re-derive it at the first measured decode step (none resolves in
        # the port: the flag value stays)
        self.tiered = bool(getattr(self.kv, "host_pages", 0))
        self.prefetch_ahead = max(1, int(
            getattr(cfg, "kv_prefetch_ahead", 2) or 2))
        self._autotune_transfer_s: Optional[float] = None
        self._autotuned = False
        if self.tiered:
            self._autotune_transfer_s = learned_kv_transfer_seconds(
                cfg, self.kv.spec, quantized=self.kv.quantized,
                machine=self.kv.machine)
        self.parked: Dict[int, Request] = {}
        self.admission = AdmissionControl(
            seq=self.seq, max_context=self.max_context,
            queue_cap=self.queue_cap, ttft_budget_ms=self.ttft_budget_ms,
            overhead_tokens=self.dispatch_ahead + self.spec_tokens,
            pages_needed=self.kv.pages_needed,
            capacity_pages=self.kv.capacity_pages)
        # fleet hooks (default off; see the module docstring)
        self.feed = None                    # the fleet's arrival feed
        self.control = None                 # the rolling swap's view
        self.handoff = handoff              # prefill-only: to the decode pool
        # under a fleet, the fleet-wide lock with run to completion;
        # standalone (None), no lock and no added sync
        self.exec_lock = exec_lock
        self._exec = (exec_lock if exec_lock is not None
                      else contextlib.nullcontext())
        if self.handoff is not None and self._spec:
            raise ValueError("prefill-only handoff does not compose with "
                             "speculative decoding (no draft-cache handoff)")
        self.handoffs = 0
        self._pending_handoffs: List = []   # (Request, payload) to adopt
        self.queue_depth = 0                # the router's live signals
        self.active_count = 0               # (ints, read across threads)
        self.stats: Dict[str, int] = {
            "shed_queue_full": 0, "shed_ttft_budget": 0, "shed_deadline": 0,
            "shed_prompt_too_long": 0, "shed_over_max_context": 0,
            "failed": 0, "evicted_wedged": 0, "decode_timeouts": 0,
            "overdecode_tokens": 0, "swaps": 0, "spec_rounds": 0,
            "spec_drafted_tokens": 0, "spec_accepted_tokens": 0}
        self._ema_serve_ms = 0.0  # EMA of the prefill wall (shed estimator)
        # per-decode-step wall seconds at materialization granularity (a
        # speculative round: per committed token)
        self.step_times: List[float] = []
        self.decode_steps = 0
        self.prefills = 0
        self.materializations = 0  # host syncs that drained decode work
        # request tracing: no tracer at all when it is off
        rt_on = (reqtrace if reqtrace is not None
                 else bool(getattr(cfg, "serve_reqtrace", True)))
        self.tracer: Optional[RequestTracer] = \
            RequestTracer() if rt_on else None
        self.slo = getattr(engine, "slo", None)
        # serve_trace_out: the offered load, exported at run() end
        self.trace_out = str(getattr(cfg, "serve_trace_out", "") or "")
        self._trace_arrivals: List[Request] = []
        self._t0 = time.perf_counter()

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _settle(self) -> None:
        """Under a fleet: the work just queued runs to completion before
        `exec_lock` is released (no device tail escapes it)."""
        if self.exec_lock is not None and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _upload(self, next_host: np.ndarray) -> torch.Tensor:
        """The next step's tokens on the device."""
        with self._exec:
            out = to_device_async(next_host, self.device)
            self._settle()
        return out

    # ----------------------------------------------------------- terminal
    def _terminal(self, req: Request, now_s: float, reason: str,
                  kv_pages: int = 0) -> Dict[str, Any]:
        """Every outcome ends here: the terminal record, classified against
        the engine's SLO objectives; it closes the request's trace."""
        rec = terminal_record(req, now_s, kv_pages, reason)
        if self.slo is not None:
            self.slo.observe(rec)
        if self.tracer is not None:
            self.tracer.on_terminal(req, now_s, rec)
        return rec

    # --------------------------------------------------------- degradation
    def _shed(self, req: Request, reason: str, now_s: float) -> None:
        req.outcome = "shed"
        req.shed_reason = reason
        req.finish_s = now_s
        self.shed.append(req)
        self.stats["shed_" + reason] += 1
        rec = self._terminal(req, now_s, reason)
        tel.event("serve/request_shed", cat="serve", reason=reason,
                  waited_s=max(0.0, now_s - req.arrival_s), **rec)

    def _fail(self, req: Request, outcome: str, now_s: float,
              err: Optional[BaseException] = None) -> None:
        """A request the watchdog evicted (outcome "timeout") or a fault
        failed ("failed", `err` logged)."""
        if err is not None:
            _LOG.warning("request %d failed: %r", req.rid, err)
        req.outcome = outcome
        req.finish_s = now_s
        req.slot = None
        self.failed.append(req)
        self.stats["failed"] += 1
        rec = self._terminal(
            req, now_s, "decode_timeout" if outcome == "timeout" else "error")
        tel.event("serve/request_failed", cat="serve",
                  error=repr(err)[:200] if err else "", **rec)

    def _enqueue(self, req: Request, waiting: List[Request],
                 now_s: float) -> None:
        """The shed-or-queue decision for one arrival
        (`fleet.AdmissionControl` decides, this sheds)."""
        if self.tracer is not None:
            self.tracer.on_submit(req, now_s)
        if self.trace_out:
            self._trace_arrivals.append(req)
        reason = self.admission.permanent_shed_reason(req)
        if reason is not None:
            self._shed(req, reason, now_s)
            return
        victim = self.admission.queue_or_displace(req, waiting)
        if victim is not None:
            self._shed(victim, "queue_full", now_s)

    def _shed_stale(self, waiting: List[Request], now_s: float) -> None:
        """Shed the waiters that can no longer be served in time."""
        for r, reason in self.admission.stale(waiting, now_s,
                                              self._ema_serve_ms):
            self._shed(r, reason, now_s)

    def _pick_wedged(self, active: Dict[int, Request]) -> int:
        """The watchdog's choice: the longest-resident slot (most tokens;
        ties to the lowest slot id)."""
        return max(active.items(),
                   key=lambda it: (len(it[1].tokens), -it[0]))[0]

    def _evict_wedged(self, active: Dict[int, Request], outcome: str,
                      now_s: float,
                      err: Optional[BaseException] = None) -> None:
        slot = self._pick_wedged(active)
        req = active.pop(slot)
        self.kv.evict(slot)
        self.kv.push()
        if self._spec:
            self.draft.kv.evict(slot)
            self.draft.kv.push()
        self.stats["evicted_wedged"] += 1
        tel.event("serve/slot_evicted", cat="serve", rid=req.rid, slot=slot,
                  outcome=outcome, tokens=len(req.tokens))
        self._fail(req, outcome, now_s, err)

    # ------------------------------------------------------------ admission
    def _admit(self, waiting: List[Request], active: Dict[int, Request],
               next_host: np.ndarray) -> bool:
        """Place as many waiting requests as slots, pages and the chunk
        budget allow (most urgent first), prefill them as one batch, commit
        K/V, record TTFT. Returns True if any were admitted. The page
        tables are pushed before the commit so the scatter sees the new
        pages."""
        free = self.kv.free_slots()
        batch: List[Request] = []
        chunk_used = 0
        waiting.sort(key=_urgency)
        while waiting and free:
            req = waiting[0]
            if self.prefill_chunk_tokens and batch and \
                    chunk_used + len(req.prompt) > self.prefill_chunk_tokens:
                break  # chunked admission: the rest joins the next wave
            # a verify pass caches up to K entries past the committed
            # extent, so the reservation grows by K: no write of the window
            # may land on a page the slot does not own
            need = (len(req.prompt) + req.max_new_tokens
                    + self.dispatch_ahead + self.spec_tokens)
            if not self.kv.can_admit(need):
                # tiered: spill active slots to the host tier to make room
                # before conceding backpressure
                if not (self.tiered and self._make_room(need, active)):
                    break  # page backpressure: keep queued
            slot = free[0]
            try:
                run_resilient(
                    "serve/kv_admit",
                    lambda s=slot, r=req, n=need:
                        self.kv.admit(s, len(r.prompt), n),
                    policy=self.retry_policy)
            except KVPoolExhausted:
                break
            except Exception as e:  # noqa: BLE001 - an escalated fault:
                waiting.pop(0)  # this request fails, the rest stay queued
                self._fail(req, "failed", self._now(), e)
                continue
            if self._spec:
                try:  # mirror the reservation in the draft's cache
                    self.draft.kv.admit(slot, len(req.prompt), need)
                except KVPoolExhausted:
                    self.kv.evict(slot)
                    break
            free.pop(0)
            req.slot = slot
            chunk_used += len(req.prompt)
            batch.append(waiting.pop(0))
        if not batch:
            return False
        self.kv.push()
        if self._spec:
            self.draft.kv.push()
        ids = np.zeros((self.slots, self.seq), np.int32)
        lengths = np.zeros((self.slots,), np.int32)
        for req in batch:
            n = min(len(req.prompt), self.seq)
            ids[req.slot, :n] = req.prompt[:n]
            lengths[req.slot] = n
        all_slots = np.arange(self.slots, dtype=np.int32)
        t_pre = time.perf_counter()
        try:
            logits, kv_state = run_resilient(
                "serve/prefill",
                lambda: self.engine.prefill(
                    self.params, self.prompt_inputs_fn(ids, lengths)),
                policy=self.retry_policy)
        except Exception as e:  # noqa: BLE001 - an escalated fault fails
            self._fail_batch(batch, e)  # only the batch being admitted
            return False
        self.kv.commit_prefill(kv_state, all_slots, lengths)
        if self._spec:
            # the draft prefills the same prompt batch into its own cache:
            # from here the two caches' positions move together
            try:
                _, dkv_state = run_resilient(
                    "serve/prefill",
                    lambda: self.draft.prefill(
                        self.draft.params, self.prompt_inputs_fn(ids,
                                                                 lengths)),
                    policy=self.retry_policy)
            except Exception as e:  # noqa: BLE001
                self._fail_batch(batch, e)
                return False
            self.draft.kv.commit_prefill(dkv_state, all_slots, lengths)
        self.prefills += 1
        # first token: argmax at each row's last real position, taken on
        # the device; the sync that brings it back is the TTFT
        with self._exec:
            last = to_device_async(
                np.maximum(lengths - 1, 0).astype(np.int64), logits.device)
            rows = torch.arange(self.slots, device=logits.device)
            first_tok = logits[rows, last].argmax(dim=-1).cpu().numpy()
        t_first = time.perf_counter()
        serve_ms = 1e3 * (t_first - t_pre)
        self._ema_serve_ms = (serve_ms if not self._ema_serve_ms
                              else 0.5 * self._ema_serve_ms + 0.5 * serve_ms)
        t_pre_off, t_first_off = t_pre - self._t0, t_first - self._t0
        for req in batch:
            first = int(first_tok[req.slot])
            req.tokens.append(first)
            req.ttft_s = t_first_off - req.arrival_s
            req.admit_s = t_pre_off
            next_host[req.slot, 0] = first
            active[req.slot] = req
            if self.tracer is not None:
                # the queue stage closes at the prefill dispatch, the
                # prefill stage at the TTFT sync: both times taken above
                self.tracer.on_admit(req, t_pre_off, t_first_off,
                                     wave=self.prefills)
            tel.event("serve/request_admitted", cat="serve", rid=req.rid,
                      slot=req.slot, prompt_len=int(lengths[req.slot]),
                      priority=req.priority, ttft_s=req.ttft_s,
                      queue_wait_s=max(0.0, req.admit_s - req.arrival_s))
        return True

    def _fail_batch(self, batch: List[Request], err: BaseException) -> None:
        """A prefill that escalated: its requests fail and their pages (in
        both caches) come back."""
        for req in batch:
            self.kv.evict(req.slot)
            if self._spec:
                self.draft.kv.evict(req.slot)
            self._fail(req, "failed", self._now(), err)
        self.kv.push()
        if self._spec:
            self.draft.kv.push()

    # ---------------------------------------------------------- tier rotation
    def _park(self, slot: int, active: Dict[int, Request]) -> None:
        """Spill one active slot to the host tier. Called at sync points
        only (the window was just materialized), so the request's tokens
        and the cache's position mirror agree on the committed extent."""
        req = active.pop(slot)
        self.kv.spill(slot, self.decode_steps)
        if self._spec:
            self.draft.kv.spill(slot, self.decode_steps)
        self.parked[slot] = req
        tel.event("serve/slot_parked", cat="serve", rid=req.rid, slot=slot,
                  tokens=len(req.tokens))

    def _make_room(self, need: int, active: Dict[int, Request]) -> bool:
        """Spill active slots (the largest remaining decode budget first:
        the request farthest from finishing gives up its device pages)
        until `need` pages fit. The spills' tables are published at once,
        so a failed admission afterwards never leaves a parked slot active
        on the device."""
        spilled = False
        while not self.kv.can_admit(need):
            cands = [s for s in active
                     if self.kv.can_spill(s)
                     and (not self._spec or self.draft.kv.can_spill(s))]
            if not cands:
                break
            slot = max(cands, key=lambda s: (
                active[s].max_new_tokens - len(active[s].tokens), -s))
            self._park(slot, active)
            spilled = True
        if spilled:
            self.kv.push()
            if self._spec:
                self.draft.kv.push()
        return self.kv.can_admit(need)

    def _rotate(self, active: Dict[int, Request], next_host: np.ndarray,
                now_s: float) -> bool:
        """One rotation round at a sync point: issue refills for parked
        slots (in park order, as far as device pages allow), then rejoin
        the slots whose refill has had `prefetch_ahead` decode steps, or
        at once when nothing is active (a counted stall). Returns True when
        the cache's tables changed."""
        changed = False
        for slot in list(self.parked):
            if slot in self.kv._inflight:
                continue
            if not self.kv.prefetch(slot, self.decode_steps):
                break  # device pages short: retry at the next sync point
            if self._spec:
                self.draft.kv.prefetch(slot, self.decode_steps)
            changed = True
        for slot in list(self.parked):
            issued = self.kv._inflight.get(slot)
            if issued is None:
                continue
            lead = self.decode_steps - issued
            if lead < self.prefetch_ahead and active:
                continue  # not ready and decode has other work
            stalled = self.kv.join(slot, self.decode_steps,
                                   self.prefetch_ahead)
            if self._spec:
                self.draft.kv.join(slot, self.decode_steps,
                                   self.prefetch_ahead)
            req = self.parked.pop(slot)
            # the next step consumes the last committed token at the kept
            # position: the spill path stays bitwise the resident one
            next_host[slot, 0] = req.tokens[-1]
            active[slot] = req
            changed = True
            if self.tracer is not None:
                # the parked interval is its own stage of the request
                self.tracer.stage(req, "kv_prefetch", now_s,
                                  stalled=int(stalled),
                                  pages=len(self.kv._slot_pages.get(slot, ())))
            tel.event("serve/slot_rejoined", cat="serve", rid=req.rid,
                      slot=slot, stalled=int(stalled), lead_steps=int(lead))
        if changed:
            self.kv.push()
            if self._spec:
                self.draft.kv.push()
            self._emit_tier()
        return changed

    def _maybe_autotune(self, decode_step_s: float) -> None:
        """The first measured decode step sets the lead from a learned
        transfer time: ceil(transfer s / step s). With none (always, in
        the port: no learned cost model yet) the flag value stays."""
        if self._autotune_transfer_s is None or self._autotuned:
            return
        self._autotuned = True
        tuned = derive_prefetch_ahead(self._autotune_transfer_s,
                                      decode_step_s, self.prefetch_ahead)
        tel.event("serve/kv_prefetch_autotune", cat="serve",
                  learned_transfer_s=float(self._autotune_transfer_s),
                  decode_step_s=float(decode_step_s),
                  prefetch_ahead=int(tuned),
                  fallback=int(self.prefetch_ahead))
        self.prefetch_ahead = tuned

    # -------------------------------------------------- disaggregated handoff
    def _handoff_all(self, active: Dict[int, Request]) -> None:
        """Prefill-only replica: right after the first-token sync, every
        admitted slot is spilled to the host tier, its K/V exported, the
        slot evicted and the request handed to the decode pool through
        `handoff`. A slot that cannot spill (host pages short) stays and
        decodes here: the colocated fallback, never a drop."""
        moved = False
        for slot in list(active):
            if not self.kv.can_spill(slot):
                continue
            req = active.pop(slot)
            self.kv.spill(slot, self.decode_steps)
            payload = self.kv.export_parked(slot)
            self.kv.evict(slot)
            req.slot = None
            moved = True
            self.handoffs += 1
            tel.event("serve/request_handoff", cat="serve", rid=req.rid,
                      pages=int(payload["pages"]), tokens=len(req.tokens))
            self.handoff(req, payload)
        if moved:
            self.kv.push()

    def _ingest_handoffs(self, now_s: float) -> None:
        """Decode side of the handoff: adopt each pending payload into the
        host tier as a PARKED slot (position kept), so the rotation refills
        and rejoins it, bitwise the spill path. Short of a free slot or of
        host pages, the payload stays pending (backpressure, retried at the
        next sync point)."""
        still: List = []
        for req, payload in self._pending_handoffs:
            free = self.kv.free_slots()
            if not free or not self.kv.can_import(payload):
                still.append((req, payload))
                continue
            slot = free[0]
            self.kv.import_parked(slot, payload)
            req.slot = slot
            self.parked[slot] = req
            if self.tracer is not None:
                self.tracer.on_submit(req, now_s)
            tel.event("serve/request_adopted", cat="serve", rid=req.rid,
                      slot=slot, pages=int(payload["pages"]))
        self._pending_handoffs = still

    def _emit_tier(self) -> None:
        ts = self.kv.tier_stats()
        tel.counter("serve/kv_tier_hot_pages", ts["kv_hot_pages"],
                    cat="serve")
        tel.counter("serve/kv_tier_cold_pages", ts["kv_cold_pages"],
                    cat="serve")
        tel.counter("serve/kv_prefetch_hits", ts["kv_prefetch_hits"],
                    cat="serve")
        tel.counter("serve/kv_prefetch_stalls", ts["kv_prefetch_stalls"],
                    cat="serve")
        tel.counter("serve/kv_spills", ts["kv_spills"], cat="serve")

    # ------------------------------------------------------------- finish
    def _finish(self, req: Request, now_s: float) -> None:
        req.outcome = "done"
        req.finish_s = now_s
        kv_pages = len(self.kv._slot_pages.get(req.slot, ()))
        self.kv.evict(req.slot)
        if self._spec:
            self.draft.kv.evict(req.slot)
        self.completed.append(req)
        reason = ("eos" if self.eos_id is not None
                  and self.eos_id in req.tokens else "max_new_tokens")
        rec = self._terminal(req, now_s, reason, kv_pages=kv_pages)
        tel.event("serve/request_done", cat="serve",
                  tokens=len(req.tokens), **rec)

    def _truncate(self, req: Request) -> bool:
        """Apply EOS/max-len to a request's token list; True = finished."""
        toks = req.tokens
        if self.eos_id is not None and self.eos_id in toks:
            del toks[toks.index(self.eos_id) + 1:]
            return True
        if len(toks) >= req.max_new_tokens:
            del toks[req.max_new_tokens:]
            return True
        return False

    def _window_cap(self, active: Dict[int, Request]) -> int:
        """Dispatch-window length: `dispatch_ahead`, capped at the smallest
        remaining token budget across active slots."""
        if not active:
            return self.dispatch_ahead
        rem = min(r.max_new_tokens - len(r.tokens) for r in active.values())
        return max(1, min(self.dispatch_ahead, rem))

    def _watchdog(self, active: Dict[int, Request], per_step_s: float) -> None:
        """A window slower than the per-step budget evicts the
        longest-resident slot instead of letting it stall its neighbours."""
        if self.decode_timeout_ms and active and \
                1e3 * per_step_s > self.decode_timeout_ms:
            self.stats["decode_timeouts"] += 1
            tel.event("serve/decode_timeout", cat="serve",
                      per_step_ms=1e3 * per_step_s,
                      budget_ms=self.decode_timeout_ms)
            self._evict_wedged(active, "timeout", self._now())

    def _materialize(self, window_toks: List[torch.Tensor], state,
                     active: Dict[int, Request], window_t0: float) -> np.ndarray:
        """Drain a dispatched window: one host sync pulls every step's
        tokens, advances the host KV mirrors (per slot: an EOS finish inside
        the window is masked out of the committed advance), evicts finished
        slots and applies the watchdog. Returns the last step's tokens."""
        with self._exec:
            mats = torch.cat(window_toks, dim=1).cpu().numpy()  # [slots, steps]
        steps = mats.shape[1]
        t_now = time.perf_counter()
        self.materializations += 1
        per_step = (t_now - window_t0) / steps
        self.step_times.extend([per_step] * steps)
        self._maybe_autotune(per_step)
        adv = np.zeros((self.slots,), np.int32)
        finished: List[int] = []
        for slot, req in active.items():
            prev = len(req.tokens)
            req.tokens.extend(int(t) for t in mats[slot])
            if self._truncate(req):
                kept = max(0, len(req.tokens) - prev)
                adv[slot] = kept
                self.stats["overdecode_tokens"] += steps - kept
                finished.append(slot)
            else:
                adv[slot] = steps
        if self.tracer is not None:
            # the drained window, charged to every slot that decoded in it
            # at the time this sync already took
            self.tracer.on_decode_window(
                list(active.values()), t_now - self._t0, steps, per_step,
                {slot: int(adv[slot]) for slot in active})
        self.kv.adopt(state)
        self.kv.sync_after(steps, advances=adv)
        for slot in finished:
            self._finish(active.pop(slot), self._now())
        if self.stats["overdecode_tokens"]:
            tel.counter("serve/overdecode_tokens",
                        self.stats["overdecode_tokens"], cat="serve")
        self._watchdog(active, per_step)
        return mats[:, -1:].copy()

    # --------------------------------------------------------- speculation
    def _spec_round(self, active: Dict[int, Request],
                    next_host: np.ndarray) -> np.ndarray:
        """One speculative round: K chained greedy draft steps and one
        verify pass over `[last, d1..dK]` on the device, one host sync,
        then the longest accepted prefix is committed. Every committed
        token is the verify pass's argmax (a mismatch commits the target's
        correction), so greedy streams are those of plain decode. Full
        acceptance commits K, not K+1: the draft never cached d_K, and the
        next round would find a hole in its cache.

        The verify pass wrote K+1 entries past the committed extent and the
        draft K, in place; only the positions roll back. Those entries are
        never read stale: the next round writes position pos+i before any
        query reads it (query i sees keys up to pos+i)."""
        K = self.spec_tokens
        t0 = time.perf_counter()
        with self._exec:
            last = to_device_async(next_host, self.device)
            t_pred_dev, ver_in, tstate, dstate = self.engine.spec_round_step(
                self.params, self.draft.params, self.kv.state,
                self.draft.kv.state, last, self.step_inputs_fn)
            # the round's one host sync: the verify argmax and the drafts
            both = torch.cat([t_pred_dev, ver_in[:, 1:]],
                             dim=1).cpu().numpy()
        t_pred, drafted = both[:, :K + 1], both[:, K + 1:]
        wall = time.perf_counter() - t0
        self.materializations += 1
        t_end_off = (t0 + wall) - self._t0
        match = drafted == t_pred[:, :-1]                    # [slots, K]
        adv = np.zeros((self.slots,), np.int32)
        out = next_host.copy()
        finished: List[int] = []
        round_accept = 0
        max_commit = 1
        for slot, req in active.items():
            m = match[slot]
            j = K if m.all() else int(m.argmin())  # accepted draft tokens
            ncommit = min(j + 1, K)
            committed = [int(t) for t in t_pred[slot, :ncommit]]
            prev = len(req.tokens)
            req.tokens.extend(committed)
            round_accept += j
            if self._truncate(req):
                kept = max(0, len(req.tokens) - prev)
                adv[slot] = kept
                self.stats["overdecode_tokens"] += ncommit - kept
                finished.append(slot)
            else:
                adv[slot] = ncommit
                out[slot, 0] = committed[-1]
            max_commit = max(max_commit, ncommit)
            if self.tracer is not None:
                self.tracer.on_spec_round(
                    req, t_end_off, drafted=K, committed=ncommit,
                    rejected=K - min(j, K))
        for kv, st in ((self.kv, tstate), (self.draft.kv, dstate)):
            # re-publish the committed extent: the speculative advance on
            # the device (K+1 for the verify pass, K for the draft) rolls
            # back to what acceptance kept
            kv.adopt(st)
            kv.sync_after(0, advances=adv)
            kv.push()
        for slot in finished:
            self._finish(active.pop(slot), self._now())
        round_drafted = K * max(1, len(finished) + len(active))
        self.stats["spec_rounds"] += 1
        self.stats["spec_drafted_tokens"] += round_drafted
        self.stats["spec_accepted_tokens"] += round_accept
        rate = round_accept / round_drafted
        self._accept_ema = (rate if self.stats["spec_rounds"] == 1
                            else 0.9 * self._accept_ema + 0.1 * rate)
        tel.counter("serve/spec_drafted_tokens",
                    self.stats["spec_drafted_tokens"], cat="serve")
        tel.counter("serve/spec_accepted_tokens",
                    self.stats["spec_accepted_tokens"], cat="serve")
        tel.counter("serve/spec_accept_rate", self._accept_ema, cat="serve")
        per_tok = wall / max_commit
        self.step_times.extend([per_tok] * max_commit)
        self._maybe_autotune(per_tok)
        if self.tracer is not None:
            self.tracer.hists["decode_step"].add(per_tok, n=max_commit)
        self.decode_steps += K + 1
        self._watchdog(active, wall / (K + 1))
        return out

    # --------------------------------------------------------------- loop
    def run(self, requests: List[Request]) -> List[Request]:
        """Serve `requests` (arrival_s offsets define the open-loop trace)
        to completion; returns the COMPLETED ones with tokens and latency
        fields filled. Shed requests land in `self.shed`, timed-out and
        failed ones in `self.failed`, each with its outcome and reason."""
        self._t0 = time.perf_counter()
        if self.tracer is not None:
            self.tracer.begin(self._t0)
        queue = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        waiting: List[Request] = []
        active: Dict[int, Request] = {}
        next_host = np.zeros((self.slots, 1), np.int32)
        state = self.kv.state
        next_dev = self._upload(next_host)
        window_toks: List[torch.Tensor] = []  # dispatched, unmaterialized
        window_t0 = time.perf_counter()

        while (queue or waiting or active or self.parked
               or self._pending_handoffs
               or (self.feed is not None and not self.feed.exhausted)):
            now = self._now()
            if self.feed is not None:
                # the fleet delivers arrivals (and handed-off prefills)
                # while the loop runs
                for item in self.feed.drain():
                    if isinstance(item, tuple):
                        self._pending_handoffs.append(item)
                    else:
                        self._enqueue(item, waiting, now)
            while queue and queue[0].arrival_s <= now:
                self._enqueue(queue.popleft(), waiting, now)
            self.queue_depth = len(waiting)
            self.active_count = len(active)
            tel.counter("serve/queue_depth", len(waiting), cat="serve")
            tel.counter("serve/active_slots", len(active), cat="serve")
            want_sync = (len(window_toks) >= self._window_cap(active)
                         or (waiting and self.kv.free_slots())
                         or bool(self.parked)
                         or bool(self._pending_handoffs)
                         or not active)
            if want_sync and window_toks:
                next_host = self._materialize(window_toks, state, active,
                                              window_t0)
                window_toks = []
                state = self.kv.state
                window_t0 = time.perf_counter()
            if not window_toks and (self.control is not None
                                    or self.engine.watching):
                # the swap's safe point: nothing dispatched holds params.
                # Under a fleet the rolling controller decides whether this
                # replica may advance (or must roll back) here.
                if (self.control.at_safe_point(self)
                        if self.control is not None
                        else self.engine.poll_swap()):
                    self.params = self.engine.params
                    self.stats["swaps"] += 1
                    state = self.kv.state
                    if self.tracer is not None:
                        # mark it in every in-flight request's timeline
                        self.tracer.on_swap(list(active.values()),
                                            self._now(),
                                            self.engine.active_version)
            if waiting:
                self._shed_stale(waiting, self._now())
            if self._pending_handoffs and not window_toks:
                # decode side of the disaggregated topology: adopt handed-off
                # prefills into the host tier; the rotation below carries
                # them to the device
                self._ingest_handoffs(self._now())
            if self.parked and not window_toks:
                # tier rotation before admission: rejoining slots claim
                # device pages ahead of new arrivals (they are older)
                self._rotate(active, next_host, self._now())
            if waiting and self.kv.free_slots():
                if self._admit(waiting, active, next_host):
                    state = self.kv.state
                    next_dev = self._upload(next_host)
                    window_t0 = time.perf_counter()
            if self.handoff is not None and active and not window_toks:
                # prefill replica: what it admitted leaves for the decode
                # pool right after its first-token sync
                self._handoff_all(active)
                state = self.kv.state
            if self.tiered and not window_toks:
                # rotation and spills change the tables outside _admit's
                # refresh; re-anchor only with no step in flight (then the
                # cache's state and the host's tokens agree)
                state = self.kv.state
                next_dev = self._upload(next_host)
            if not active:
                if queue and not waiting:
                    # open loop: idle until the next arrival (short naps
                    # when watching, so snapshot polls go on)
                    wait = max(0.0, queue[0].arrival_s - self._now())
                    time.sleep(min(wait, 0.05)
                               if (self.engine.watching
                                   or self.control is not None) else wait)
                elif self.feed is not None and not waiting \
                        and not self.parked and not self._pending_handoffs:
                    # a fed loop with nothing in hand naps instead of
                    # spinning on the (still open) feed
                    time.sleep(0.002)
                continue
            if self._spec:
                # a round is its own sync point: no dispatch-ahead window
                try:
                    next_host = run_resilient(
                        "serve/decode_step",
                        lambda nh=next_host: self._spec_round(active, nh),
                        policy=self.retry_policy)
                except Exception as e:  # noqa: BLE001 - a permanent fault
                    if active:
                        self._evict_wedged(active, "failed", self._now(), e)
                state = self.kv.state
                next_dev = self._upload(next_host)
                continue
            inputs = self.step_inputs_fn(next_dev, state)
            try:
                logits, state = run_resilient(
                    "serve/decode_step",
                    lambda s=state, ins=inputs:
                        self.engine.decode_step(self.params, s, ins),
                    policy=self.retry_policy)
            except Exception as e:  # noqa: BLE001 - a permanent decode
                # fault: drain what was dispatched, then evict the wedged
                # slot; every other slot keeps serving
                if window_toks:
                    next_host = self._materialize(window_toks, state, active,
                                                  window_t0)
                    window_toks = []
                if active:
                    self._evict_wedged(active, "failed", self._now(), e)
                state = self.kv.state
                next_dev = self._upload(next_host)
                window_t0 = time.perf_counter()
                continue
            with self._exec:
                # the one launch the scheduler owns (the engine's own calls
                # serialize inside the fleet's proxy)
                next_dev = torch.argmax(logits[:, -1, :], dim=-1).to(
                    torch.int32)[:, None]
                self._settle()
            window_toks.append(next_dev)
            self.decode_steps += 1
        if self.tiered:
            # the final tier ledger, into telemetry and into stats
            self._emit_tier()
            self.stats.update(self.kv.tier_stats())
        if self.tracer is not None:
            self.tracer.emit_hists()
        if self.slo is not None and tel.enabled():
            tel.event("serve/slo", cat="serve", report=self.slo.report())
        if getattr(self.engine.cfg, "profile_ops", False) and tel.enabled():
            # profile_ops: this run's prefill and decode ops as op/attr
            # rows, normalized by the run's own step times
            try:
                self.engine.op_attribution(
                    step_time_s=(float(np.median(self.step_times))
                                 if self.step_times else None),
                    prefill_step_time_s=(self._ema_serve_ms / 1e3
                                         if self._ema_serve_ms else None))
            except Exception as e:  # noqa: BLE001 - a served run stands
                _LOG.warning("serving op attribution failed: %r", e)
        if self.trace_out and self._trace_arrivals:
            from flexflow_tpu_torch.serving import tracefmt
            tracefmt.save_trace(
                self.trace_out,
                tracefmt.requests_to_records(
                    sorted(self._trace_arrivals,
                           key=lambda r: (r.arrival_s, r.rid))),
                meta={"source": "scheduler", "slots": self.slots,
                      "seq": self.seq})
        return self.completed
