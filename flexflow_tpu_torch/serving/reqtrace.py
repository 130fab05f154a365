"""The unified terminal record of a served request (counterpart:
flexflow_tpu/serving/reqtrace.py, `terminal_record`).

Every outcome (done, shed, failed, timeout) ends in one record with the
same fields, which the SLO tracker (`health.SLOTracker`) classifies. The
JAX module's `RequestTracer` and streaming histograms are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict


def terminal_record(req, now_s: float, kv_pages: int,
                    reason: str) -> Dict[str, Any]:
    """The terminal record of any outcome, from fields the scheduler
    already fills. per_token_s is the mean decode time after the first
    token (None below 2 tokens)."""
    tokens_out = len(req.tokens)
    total_s = max(0.0, now_s - req.arrival_s)
    queue_wait_s = (req.admit_s - req.arrival_s
                    if getattr(req, "admit_s", None) is not None
                    else total_s)
    per_token_s = None
    if req.ttft_s is not None and tokens_out >= 2:
        per_token_s = max(0.0, total_s - req.ttft_s) / (tokens_out - 1)
    return {"rid": req.rid, "priority": req.priority,
            "outcome": req.outcome, "outcome_reason": reason,
            "queue_wait_s": max(0.0, queue_wait_s),
            "ttft_s": req.ttft_s, "per_token_s": per_token_s,
            "tokens_in": len(req.prompt), "tokens_out": tokens_out,
            "kv_pages": int(kv_pages), "total_s": total_s}
