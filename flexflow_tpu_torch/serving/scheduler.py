"""Continuous-batching scheduler over the two serving programs
(counterpart: flexflow_tpu/serving/scheduler.py).

Policy, as in the JAX package:

- ADMISSION: at every sync point, waiting requests are placed into free
  decode slots in arrival order as far as pages allow (a short free list is backpressure:
  the request stays queued). Admitted prompts are right-padded into the
  `[slots, S]` prefill batch at their slot's row, run through the prefill
  program once ("prefill-then-join"), their K/V committed into the paged
  cache, and their first token (argmax of the logits at `lengths - 1`)
  recorded as time-to-first-token.
- DECODE: between sync points the host dispatches up to `DISPATCH_AHEAD`
  single-token steps without synchronizing: each step's argmax feeds the
  next step as a device tensor. The window is capped at the smallest
  remaining token budget across active slots; an EOS finish inside a
  window is masked out of the committed KV advance
  (`sync_after(advances=...)`) and counted as `overdecode_tokens`.
- EVICTION: at sync points, slots whose sequence hit EOS or max-new are
  evicted (pages freed).

Prompts longer than the prefill window, or needing more pages than the
pool holds, are shed as `prompt_too_long`. Request priorities, SLO
shedding, tracing, fault retries, speculation, the host KV tier and the
fleet hooks of the JAX scheduler are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from flexflow_tpu_torch.serving.kv_cache import POS_KEY, KVPoolExhausted

# decode steps dispatched between two host syncs (the JAX default)
DISPATCH_AHEAD = 4


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival_s: float = 0.0        # offset from scheduler start (open loop)
    # filled by the scheduler:
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None
    admit_s: Optional[float] = None
    finish_s: Optional[float] = None
    slot: Optional[int] = None
    outcome: str = ""             # "done" | "shed"
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


class ContinuousBatchingScheduler:
    def __init__(self, engine, params, prompt_inputs_fn: Callable,
                 step_inputs_fn: Callable, eos_id: Optional[int] = None):
        self.engine = engine
        self.params = params
        self.prompt_inputs_fn = prompt_inputs_fn
        self.step_inputs_fn = step_inputs_fn
        self.eos_id = eos_id
        self.kv = engine.kv
        self.slots = engine.slots
        self.device = engine.device
        self.seq = int(engine.prefill_model.input_tensors[0].spec.shape[1])
        self.completed: List[Request] = []
        self.shed: List[Request] = []
        self.stats: Dict[str, int] = {"shed_prompt_too_long": 0,
                                      "overdecode_tokens": 0}
        # per-decode-step wall seconds at materialization granularity
        self.step_times: List[float] = []
        self.decode_steps = 0
        self.prefills = 0
        self._t0 = time.perf_counter()

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    # ------------------------------------------------------------ admission
    def _enqueue(self, req: Request, waiting: List[Request], now_s: float) -> None:
        need = len(req.prompt) + req.max_new_tokens + DISPATCH_AHEAD
        if len(req.prompt) > self.seq or \
                self.kv.pages_needed(need) > self.kv.capacity_pages():
            # the prefill window is fixed at `seq`; truncating would serve
            # a different request than the one sent
            req.outcome, req.shed_reason, req.finish_s = \
                "shed", "prompt_too_long", now_s
            self.shed.append(req)
            self.stats["shed_prompt_too_long"] += 1
            return
        waiting.append(req)

    def _admit(self, waiting: List[Request], active: Dict[int, Request],
               next_host: np.ndarray) -> bool:
        """Place as many waiting requests as slots/pages allow (in arrival
        order), prefill them as one batch, commit K/V, record TTFT.
        Returns True if any were admitted. The page table is pushed before
        the commit so the scatter sees the new pages."""
        free = self.kv.free_slots()
        batch: List[Request] = []
        while waiting and free:
            req = waiting[0]
            need = len(req.prompt) + req.max_new_tokens + DISPATCH_AHEAD
            if not self.kv.can_admit(need):
                break  # page backpressure: keep queued
            slot = free.pop(0)
            try:
                self.kv.admit(slot, len(req.prompt), need)
            except KVPoolExhausted:
                break
            req.slot = slot
            batch.append(waiting.pop(0))
        if not batch:
            return False
        self.kv.push()
        ids = np.zeros((self.slots, self.seq), np.int32)
        lengths = np.zeros((self.slots,), np.int32)
        for req in batch:
            n = len(req.prompt)
            ids[req.slot, :n] = req.prompt
            lengths[req.slot] = n
        t_pre = time.perf_counter()
        logits, kv_state = self.engine.prefill(
            self.params, self.prompt_inputs_fn(ids, lengths))
        self.kv.commit_prefill(kv_state, np.arange(self.slots, dtype=np.int32),
                               lengths)
        self.prefills += 1
        # first token: argmax at each row's last real position, taken on
        # the device; the sync that brings it back is the TTFT
        last = torch.from_numpy(np.maximum(lengths - 1, 0)).long().to(logits.device)
        rows = torch.arange(self.slots, device=logits.device)
        first_tok = logits[rows, last].argmax(dim=-1).cpu().numpy()
        t_first = time.perf_counter()
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
        self.kv.evict(req.slot)
        self.completed.append(req)

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
            return DISPATCH_AHEAD
        rem = min(r.max_new_tokens - len(r.tokens) for r in active.values())
        return max(1, min(DISPATCH_AHEAD, rem))

    def _materialize(self, window_toks: List[torch.Tensor], state,
                     active: Dict[int, Request], window_t0: float) -> np.ndarray:
        """Drain a dispatched window: one host sync pulls every step's
        tokens, advances the host KV mirrors (per slot: an EOS finish inside
        the window is masked out of the committed advance) and evicts
        finished slots. Returns the last step's tokens."""
        mats = torch.cat(window_toks, dim=1).cpu().numpy()   # [slots, steps]
        steps = mats.shape[1]
        t_now = time.perf_counter()
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
        return mats[:, -1:].copy()

    # --------------------------------------------------------------- loop
    def run(self, requests: List[Request]) -> List[Request]:
        """Serve `requests` (arrival_s offsets define the open-loop trace)
        to completion; returns the COMPLETED ones with tokens and latency
        fields filled. Shed requests land in `self.shed`."""
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
            inputs = self.step_inputs_fn(next_dev, state)
            logits, state = self.engine.decode_step(self.params, state, inputs)
            next_dev = torch.argmax(logits[:, -1, :], dim=-1).to(
                torch.int32)[:, None]
            window_toks.append(next_dev)
            self.decode_steps += 1
        return self.completed
