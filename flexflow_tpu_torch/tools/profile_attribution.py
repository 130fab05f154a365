"""Per-op attribution evidence run (counterpart:
tools/profile_attribution.py).

Fits the GPT-2 twin (vocab 256, seq 16, d_model 64, 4 heads, SGD) with
telemetry and `profile_ops` on, runs the per-op attribution join
(flexflow_tpu_torch/attribution.py) and verifies the contract end to end:

  * per-op attributed times sum to the MEASURED per-update step time
    within attribution.SUM_TOLERANCE (15%),
  * every op row carries predicted cost, measured time, roofline bound
    and MFU,
  * the per-op drift top-K names the worst-mispriced op,
  * the span_dataset tool of this package compiles the run's telemetry
    dir into a non-empty featurized corpus.

The fit runs on the card unless `--device cpu` is given.

Usage:
    python -m flexflow_tpu_torch.tools.profile_attribution [--out r.json]
        [--epochs N] [--blocks N] [--telemetry-dir D] [--device cpu]
    python -m flexflow_tpu_torch.tools.profile_attribution --check
        [--device cpu]

`--out` has no default: without it the result is printed, not written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional


def _build_twin(tdir: str, blocks: int, batch: int = 8,
                device: str = "cuda"):
    """The GPT-2 twin (the bench family's standard subject): a scaled
    GPT-2 compiled with telemetry and per-op profiling on. Its head dim
    (16) is one the flash kernels do not cover, and the port's attention
    raises on the card rather than fall back: the twin compiles with
    fusion off (the attention's einsum path, the plain loss) wherever the
    kernels' gate refuses its shape, as `--no-fusion` would, and keeps the
    fused SGD update (`--fused-optimizer on`)."""
    import torch

    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.kernels.flash_attention import flash_supported
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2

    gcfg = GPT2Config(vocab=256, seq=16, d_model=64, heads=4,
                      layers=blocks, dropout=0.0)
    fusion = flash_supported(gcfg.seq, gcfg.seq, gcfg.d_model // gcfg.heads,
                             torch.float32, causal=True,
                             batch_heads=batch * gcfg.heads)
    cfg = FFConfig(batch_size=batch, only_data_parallel=True,
                   telemetry_dir=tdir, profile_ops=True,
                   enable_fusion=fusion, fused_optimizer="on")
    m = FFModel(cfg)
    build_gpt2(m, gcfg, batch=batch)
    cm = m.compile(SGDOptimizer(lr=0.01),
                   loss_type="sparse_categorical_crossentropy", metrics=[],
                   device=device)
    cm.init(seed=0)
    return m, cm, gcfg


def run(epochs: int = 3, blocks: int = 2, batch: int = 8,
        telemetry_dir: Optional[str] = None,
        verbose: bool = True, device: str = "cuda") -> Dict[str, Any]:
    import numpy as np

    from flexflow_tpu_torch import attribution, telemetry
    from flexflow_tpu_torch.tools import span_dataset

    own_tmp = None
    if telemetry_dir is None:
        own_tmp = tempfile.TemporaryDirectory()
        telemetry_dir = os.path.join(own_tmp.name, "telemetry")
    try:
        m, cm, gcfg = _build_twin(telemetry_dir, blocks, batch, device)
        rng = np.random.default_rng(0)
        n = batch * 8
        ids = rng.integers(0, gcfg.vocab, size=(n, gcfg.seq)).astype("int32")
        pos = np.broadcast_to(np.arange(gcfg.seq, dtype="int32"),
                              (n, gcfg.seq)).copy()
        y = rng.integers(0, gcfg.vocab, size=(n, gcfg.seq)).astype("int32")
        # >= 2 epochs: the drift monitor needs a post-warm-up window for
        # an honest measured step time
        cm.fit([ids, pos], y, epochs=max(2, epochs), verbose=False)
        report = cm.op_attribution(print_table=verbose)
        telemetry.flush()
        corpus = span_dataset.build(telemetry_dir, out_path=None, quiet=True)

        step = report["step_time_s"]
        att = report["attributed_total_s"]
        rows = report["rows"]
        result: Dict[str, Any] = {
            "model": f"gpt2 twin ({blocks} blocks, vocab={gcfg.vocab}, "
                     f"seq={gcfg.seq}, d_model={gcfg.d_model})",
            "device": str(cm.device),
            "fusion": cm.cfg.enable_fusion,
            "batch": batch,
            "epochs": max(2, epochs),
            "source": report["source"],
            "rows": len(rows),
            "step_time_s": step,
            "attributed_total_s": att,
            "attributed_over_step": (att / step) if step else None,
            "coverage": report["coverage"],
            "sum_tolerance": attribution.SUM_TOLERANCE,
            "worst_mispriced_op": (report["top_drift"]["rows"][0]["layer"]
                                   if report["top_drift"]["rows"] else None),
            "top_drift_explained": report["top_drift"]["explained"],
            "bandwidth_bound_ops": sum(1 for r in rows
                                       if r["bound"] == "bandwidth"),
            "compute_bound_ops": sum(1 for r in rows
                                     if r["bound"] == "compute"),
            "corpus_rows": len(corpus),
            "top_ops": [{k: r[k] for k in
                         ("layer", "op", "predicted_s", "attributed_s",
                          "roofline_s", "mfu", "bound")}
                        for r in rows[:8]],
            "worst_by_error": _worst_by_error(rows),
        }
        return result
    finally:
        from flexflow_tpu_torch import telemetry

        telemetry.shutdown()
        if own_tmp is not None:
            own_tmp.cleanup()


def _worst_by_error(rows: List[Dict[str, Any]]) -> Optional[str]:
    """The op whose predicted cost is furthest from its attributed time
    (what the drift top-K must name first)."""
    priced = [r for r in rows if r.get("predicted_s") is not None]
    if not priced:
        return None
    return max(priced, key=lambda r: abs(r["attributed_s"]
                                         - r["predicted_s"]))["layer"]


def verify(result: Dict[str, Any], report_rows_checked: bool = True) -> None:
    """The acceptance assertions (shared by --check and the full run)."""
    from flexflow_tpu_torch import attribution

    assert result["rows"] > 0, "no op rows attributed"
    step, att = result["step_time_s"], result["attributed_total_s"]
    assert step and step > 0, "no measured step time (fit didn't record " \
                              "drift windows)"
    assert abs(att - step) / step <= attribution.SUM_TOLERANCE, \
        f"attributed {att:.6f}s vs measured step {step:.6f}s " \
        f"(> {attribution.SUM_TOLERANCE:.0%})"
    assert result["worst_mispriced_op"], "per-op drift top-K is empty"
    assert result["worst_mispriced_op"] == result["worst_by_error"], \
        (f"drift top-K names {result['worst_mispriced_op']}, the largest "
         f"|attributed - predicted| is {result['worst_by_error']}")
    assert result["corpus_rows"] > 0, "span_dataset corpus is empty"
    if report_rows_checked:
        for r in result["top_ops"]:
            for k in ("predicted_s", "attributed_s", "roofline_s", "mfu"):
                assert r.get(k) is not None, (k, r)
            assert r.get("bound") in ("compute", "bandwidth"), r


def _check(device: str = "cuda") -> int:
    result = run(epochs=2, blocks=1, verbose=False, device=device)
    verify(result)
    print(f"profile_attribution --check OK ({result['rows']} op rows, "
          f"attributed/step={result['attributed_over_step']:.3f}, "
          f"worst={result['worst_mispriced_op']}, "
          f"corpus={result['corpus_rows']} rows)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        "flexflow_tpu_torch.tools.profile_attribution", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None,
                    help="write the result JSON here (default: print only)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--telemetry-dir", default=None,
                    help="keep the run's telemetry (default: temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="device of the fit (default: the card)")
    ap.add_argument("--check", action="store_true",
                    help="smoke: small twin, assert the acceptance "
                         "contract, write nothing")
    args = ap.parse_args(argv)
    if args.check:
        return _check(args.device)
    result = run(epochs=args.epochs, blocks=args.blocks,
                 telemetry_dir=args.telemetry_dir, device=args.device)
    verify(result)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}: ", end="")
    print(f"{result['rows']} op rows, "
          f"attributed/step={result['attributed_over_step']:.3f}, "
          f"worst mispriced={result['worst_mispriced_op']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
