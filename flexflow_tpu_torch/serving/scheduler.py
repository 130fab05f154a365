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
- DECODE: between sync points the host dispatches up to `DISPATCH_AHEAD`
  single-token steps without synchronizing: each step's argmax feeds the
  next step as a device tensor. The window is capped at the smallest
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

Every outcome ends in one terminal record (`reqtrace.terminal_record`),
which the engine's SLO tracker classifies. Not ported yet: fault retries
(`run_resilient`; a fault raises out of `run`), request tracing, the host
KV tier, hot-swap and the fleet hooks. The constructor raises
`NotImplementedError` where a caller asks for them.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from flexflow_tpu_torch.serving.kv_cache import POS_KEY, KVPoolExhausted
from flexflow_tpu_torch.serving.reqtrace import terminal_record

# decode steps dispatched between two host syncs (the JAX default)
DISPATCH_AHEAD = 4


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
    outcome: str = ""             # "done" | "shed" | "timeout"
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
                 ttft_budget_ms: Optional[float] = None,
                 queue_cap: Optional[int] = None,
                 decode_timeout_ms: Optional[float] = None,
                 prefill_chunk_tokens: int = 0,
                 retry_policy=None, reqtrace: Optional[bool] = None,
                 handoff: Optional[Callable] = None):
        if retry_policy is not None:
            raise NotImplementedError("retry_policy: fault retries "
                                      "(run_resilient) are not ported yet")
        if reqtrace:
            raise NotImplementedError("reqtrace: request tracing is not "
                                      "ported yet")
        if handoff is not None:
            raise NotImplementedError("handoff: the fleet's disaggregated "
                                      "prefill is not ported yet")
        from flexflow_tpu_torch.serving.fleet import AdmissionControl

        self.engine = engine
        self.params = params
        self.prompt_inputs_fn = prompt_inputs_fn
        self.step_inputs_fn = step_inputs_fn
        self.eos_id = eos_id
        self.dispatch_ahead = DISPATCH_AHEAD
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
        self.admission = AdmissionControl(
            seq=self.seq, max_context=self.max_context,
            queue_cap=self.queue_cap, ttft_budget_ms=self.ttft_budget_ms,
            overhead_tokens=self.dispatch_ahead + self.spec_tokens,
            pages_needed=self.kv.pages_needed,
            capacity_pages=self.kv.capacity_pages)
        self.stats: Dict[str, int] = {
            "shed_queue_full": 0, "shed_ttft_budget": 0, "shed_deadline": 0,
            "shed_prompt_too_long": 0, "shed_over_max_context": 0,
            "failed": 0, "evicted_wedged": 0, "decode_timeouts": 0,
            "overdecode_tokens": 0, "spec_rounds": 0,
            "spec_drafted_tokens": 0, "spec_accepted_tokens": 0}
        self._ema_serve_ms = 0.0  # EMA of the prefill wall (shed estimator)
        # per-decode-step wall seconds at materialization granularity (a
        # speculative round: per committed token)
        self.step_times: List[float] = []
        self.decode_steps = 0
        self.prefills = 0
        self.materializations = 0  # host syncs that drained decode work
        self.slo = getattr(engine, "slo", None)
        self._t0 = time.perf_counter()

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    # ----------------------------------------------------------- terminal
    def _terminal(self, req: Request, now_s: float, reason: str,
                  kv_pages: int = 0) -> Dict[str, Any]:
        """Every outcome ends here: the terminal record, classified against
        the engine's SLO objectives."""
        rec = terminal_record(req, now_s, kv_pages, reason)
        if self.slo is not None:
            self.slo.observe(rec)
        return rec

    # --------------------------------------------------------- degradation
    def _shed(self, req: Request, reason: str, now_s: float) -> None:
        req.outcome = "shed"
        req.shed_reason = reason
        req.finish_s = now_s
        self.shed.append(req)
        self.stats["shed_" + reason] += 1
        self._terminal(req, now_s, reason)

    def _fail(self, req: Request, now_s: float) -> None:
        """A request the watchdog evicted: outcome "timeout". (The JAX
        scheduler also fails requests on faults, as "failed"; here a fault
        raises out of `run`.)"""
        req.outcome = "timeout"
        req.finish_s = now_s
        req.slot = None
        self.failed.append(req)
        self.stats["failed"] += 1
        self._terminal(req, now_s, "decode_timeout")

    def _enqueue(self, req: Request, waiting: List[Request],
                 now_s: float) -> None:
        """The shed-or-queue decision for one arrival
        (`fleet.AdmissionControl` decides, this sheds)."""
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

    def _evict_wedged(self, active: Dict[int, Request], now_s: float) -> None:
        slot = self._pick_wedged(active)
        req = active.pop(slot)
        self.kv.evict(slot)
        self.kv.push()
        if self._spec:
            self.draft.kv.evict(slot)
            self.draft.kv.push()
        self.stats["evicted_wedged"] += 1
        self._fail(req, now_s)

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
                break  # page backpressure: keep queued
            slot = free[0]
            try:
                self.kv.admit(slot, len(req.prompt), need)
            except KVPoolExhausted:
                break
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
        logits, kv_state = self.engine.prefill(
            self.params, self.prompt_inputs_fn(ids, lengths))
        self.kv.commit_prefill(kv_state, all_slots, lengths)
        if self._spec:
            # the draft prefills the same prompt batch into its own cache:
            # from here the two caches' positions move together
            _, dkv_state = self.draft.prefill(
                self.draft.params, self.prompt_inputs_fn(ids, lengths))
            self.draft.kv.commit_prefill(dkv_state, all_slots, lengths)
        self.prefills += 1
        # first token: argmax at each row's last real position, taken on
        # the device; the sync that brings it back is the TTFT
        last = torch.from_numpy(np.maximum(lengths - 1, 0)).long().to(logits.device)
        rows = torch.arange(self.slots, device=logits.device)
        first_tok = logits[rows, last].argmax(dim=-1).cpu().numpy()
        t_first = time.perf_counter()
        serve_ms = 1e3 * (t_first - t_pre)
        self._ema_serve_ms = (serve_ms if not self._ema_serve_ms
                              else 0.5 * self._ema_serve_ms + 0.5 * serve_ms)
        for req in batch:
            first = int(first_tok[req.slot])
            req.tokens.append(first)
            req.ttft_s = (t_first - self._t0) - req.arrival_s
            req.admit_s = t_pre - self._t0
            next_host[req.slot, 0] = first
            active[req.slot] = req
        return True

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
        self._terminal(req, now_s, reason, kv_pages=kv_pages)

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
        """Dispatch-window length: `DISPATCH_AHEAD`, capped at the smallest
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
            self._evict_wedged(active, self._now())

    def _materialize(self, window_toks: List[torch.Tensor], state,
                     active: Dict[int, Request], window_t0: float) -> np.ndarray:
        """Drain a dispatched window: one host sync pulls every step's
        tokens, advances the host KV mirrors (per slot: an EOS finish inside
        the window is masked out of the committed advance), evicts finished
        slots and applies the watchdog. Returns the last step's tokens."""
        mats = torch.cat(window_toks, dim=1).cpu().numpy()   # [slots, steps]
        steps = mats.shape[1]
        t_now = time.perf_counter()
        self.materializations += 1
        per_step = (t_now - window_t0) / steps
        self.step_times.extend([per_step] * steps)
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
        self.kv.adopt(state)
        self.kv.sync_after(steps, advances=adv)
        for slot in finished:
            self._finish(active.pop(slot), self._now())
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
        last = torch.from_numpy(next_host).to(self.device)
        t_pred_dev, ver_in, tstate, dstate = self.engine.spec_round_step(
            self.params, self.draft.params, self.kv.state,
            self.draft.kv.state, last, self.step_inputs_fn)
        # the round's one host sync: the verify argmax and the drafts
        both = torch.cat([t_pred_dev, ver_in[:, 1:]], dim=1).cpu().numpy()
        t_pred, drafted = both[:, :K + 1], both[:, K + 1:]
        wall = time.perf_counter() - t0
        self.materializations += 1
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
        per_tok = wall / max_commit
        self.step_times.extend([per_tok] * max_commit)
        self.decode_steps += K + 1
        self._watchdog(active, wall / (K + 1))
        return out

    # --------------------------------------------------------------- loop
    def run(self, requests: List[Request]) -> List[Request]:
        """Serve `requests` (arrival_s offsets define the open-loop trace)
        to completion; returns the COMPLETED ones with tokens and latency
        fields filled. Shed requests land in `self.shed`, timed-out ones in
        `self.failed`, each with its outcome and reason."""
        self._t0 = time.perf_counter()
        queue = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        waiting: List[Request] = []
        active: Dict[int, Request] = {}
        next_host = np.zeros((self.slots, 1), np.int32)
        state = self.kv.state
        next_dev = torch.from_numpy(next_host).to(self.device)
        window_toks: List[torch.Tensor] = []  # dispatched, unmaterialized
        window_t0 = time.perf_counter()

        while queue or waiting or active:
            now = self._now()
            while queue and queue[0].arrival_s <= now:
                self._enqueue(queue.popleft(), waiting, now)
            want_sync = (len(window_toks) >= self._window_cap(active)
                         or (waiting and self.kv.free_slots())
                         or not active)
            if want_sync and window_toks:
                next_host = self._materialize(window_toks, state, active,
                                              window_t0)
                window_toks = []
                state = self.kv.state
                window_t0 = time.perf_counter()
            if waiting:
                self._shed_stale(waiting, self._now())
            if waiting and self.kv.free_slots():
                if self._admit(waiting, active, next_host):
                    state = self.kv.state
                    next_dev = torch.from_numpy(next_host).to(self.device)
                    window_t0 = time.perf_counter()
            if not active:
                if queue and not waiting:
                    # open loop: idle until the next arrival
                    time.sleep(max(0.0, queue[0].arrival_s - self._now()))
                continue
            if self._spec:
                # a round is its own sync point: no dispatch-ahead window
                next_host = self._spec_round(active, next_host)
                state = self.kv.state
                next_dev = torch.from_numpy(next_host).to(self.device)
                continue
            inputs = self.step_inputs_fn(next_dev, state)
            logits, state = self.engine.decode_step(self.params, state, inputs)
            next_dev = torch.argmax(logits[:, -1, :], dim=-1).to(
                torch.int32)[:, None]
            window_toks.append(next_dev)
            self.decode_steps += 1
        return self.completed
