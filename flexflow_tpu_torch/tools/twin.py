"""Replay a request trace through the capacity twin
(counterpart: tools/twin.py).

Offline answers to "what happens to the TTFT p99 if we add a replica,
raise spec K, flip the KV dtype or shrink the device pool?": record live
traffic with `--serve-trace-out` (or save any generated trace), then
replay it here under another configuration. The report has the live
serving schema (terminal records, histograms, the SLO scoreboard), the
scaling-signal timeline and a replicas -> capacity curve.

The flags are FFConfig's:

    python -m flexflow_tpu_torch.tools.twin --twin-trace trace.jsonl \\
        [--twin-replicas N] [--twin-out report.json] \\
        [--serve-slo ttft_p99_ms=...] [--max-batch-slots N] \\
        [--kv-page-size N] [--serve-spec-tokens K] [--kv-host-pages N] \\
        [--serve-fleet-topology disagg] ...
    python -m flexflow_tpu_torch.tools.twin --check   # smoke, no trace

Without a machine the twin prices by the H100 preset's roofline; it
needs no card.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional


def spec_from_config(cfg, records, meta: Dict[str, Any]):
    """A TwinSpec from the FFConfig serving knobs; what the config cannot
    know (the prefill window, the decode budget) comes from the trace's
    meta when it holds them, else from the trace's shapes."""
    from flexflow_tpu_torch.serving.twin import TwinSpec

    max_in = max((r.tokens_in for r in records), default=8)
    max_new = max((r.max_tokens for r in records), default=8)
    seq = int(meta.get("seq") or max(8, max_in))
    slots = int(meta.get("slots") or cfg.max_batch_slots)
    replicas = int(cfg.twin_replicas or cfg.serve_replicas or 1)
    return TwinSpec(
        replicas=replicas, slots=slots, seq=seq,
        page_size=cfg.kv_page_size, max_decode_len=max_new,
        host_pages=cfg.kv_host_pages,
        spec_tokens=cfg.serve_spec_tokens,
        queue_cap=cfg.serve_queue_cap,
        ttft_budget_ms=cfg.serve_ttft_budget_ms,
        max_context=cfg.serve_max_context,
        prefetch_ahead=cfg.kv_prefetch_ahead,
        router=cfg.serve_router, slo=cfg.serve_slo,
        topology=cfg.serve_fleet_topology,
        prefill_replicas=cfg.serve_prefill_replicas,
        scale_itemsize=4 if cfg.kv_cache_dtype == "int8" else 0,
        itemsize=1 if cfg.kv_cache_dtype == "int8" else 4)


def run(cfg, out_path: str = "") -> Dict[str, Any]:
    from flexflow_tpu_torch.serving import tracefmt
    from flexflow_tpu_torch.serving.twin import (TwinCosts, capacity_curve,
                                                 simulate)

    trace = tracefmt.load_trace(cfg.twin_trace)
    if not trace.records:
        raise SystemExit(f"{cfg.twin_trace}: no records")
    spec = spec_from_config(cfg, trace.records, trace.meta)
    costs = TwinCosts.resolve(spec.kv_spec(), cfg=cfg, slots=spec.slots)
    res = simulate(trace.records, spec, costs)
    report = res.report()
    report["trace"] = {"path": cfg.twin_trace, "records": len(trace),
                       "skipped": trace.skipped, "meta": trace.meta}
    report["spec"] = {k: getattr(spec, k) for k in (
        "replicas", "slots", "seq", "page_size", "spec_tokens",
        "host_pages", "topology", "router", "slo")}
    report["costs"] = {"decode_step_s": costs.decode_step_s,
                       "prefill_base_s": costs.prefill_base_s,
                       "kv_transfer_page_s": costs.kv_transfer_page_s,
                       "source": costs.source}
    report["capacity_curve"] = capacity_curve(
        trace.records, spec, costs, replicas=(1, 2, 4))
    text = json.dumps(report, indent=1, default=float)
    if out_path:
        with open(out_path, "w") as f:
            f.write(text + "\n")
        print(f"twin report -> {out_path}")
    else:
        print(text)
    return report


def _check() -> int:
    """Smoke: generate -> save -> load -> replay -> report, with no card
    and no trace file, deterministic."""
    import os
    import tempfile

    import numpy as np

    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.serving import tracefmt
    from flexflow_tpu_torch.serving.twin import TwinCosts, TwinSpec, simulate

    rng = np.random.default_rng(0)
    recs = tracefmt.poisson_records(rng, 40, rate=10.0, vocab=256,
                                    prompt_len=4, max_new=8)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.jsonl")
        tracefmt.save_trace(path, recs, meta={"seq": 16, "slots": 4})
        cfg = FFConfig.parse_args(
            ["--twin-trace", path, "--twin-replicas", "2",
             "--serve-slo", "ttft_p99_ms=500", "--kv-page-size", "4"])
        report = run(cfg)
    assert report["stats"]["completed"] == 40, report["stats"]
    assert report["stats"]["shed"] == 0
    assert report["scaling"]["action"] in (
        "steady", "scale_in", "scale_out", "objective_flip")
    caps = [c["capacity_rps"] for c in report["capacity_curve"]]
    assert caps == sorted(caps), f"capacity curve not monotone: {caps}"
    # determinism: the same trace, spec and costs give the same stats
    spec = TwinSpec(replicas=2, slots=4, seq=16, page_size=4,
                    max_decode_len=8, slo="ttft_p99_ms=500")
    costs = TwinCosts.analytic(spec.kv_spec())
    s1 = simulate(recs, spec, costs).stats
    s2 = simulate(recs, spec, costs).stats
    assert s1 == s2, "twin replay is not deterministic"
    print("twin --check OK")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--check" in argv:
        return _check()
    from flexflow_tpu_torch import FFConfig

    cfg = FFConfig.parse_args(argv)
    if not cfg.twin_trace:
        raise SystemExit("twin: --twin-trace TRACE.jsonl required "
                         "(record one with --serve-trace-out, or --check)")
    run(cfg, out_path=cfg.twin_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
