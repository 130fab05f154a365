"""The admission policy (counterpart: flexflow_tpu/serving/fleet.py,
`AdmissionControl`).

`AdmissionControl` makes the shed-or-queue decisions: permanent sheds,
queue-cap displacement and the deadline/TTFT-budget sweep. It decides
only; the scheduler that owns the request sheds it and writes its
terminal record. The JAX module's router, replica pools and rolling
hot-swap are not ported yet.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from flexflow_tpu_torch.serving.scheduler import Request, _urgency


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
