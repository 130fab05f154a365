"""Flagship step-time decomposition — where does the non-MFU time go?
(counterpart: tools/perf_probe.py)

Times GPT-2 medium config #5 (b8, seq 1024, bf16, dropout 0) under
controlled variants and prints the deltas:

  adam_step      the benchmarked full training step (baseline)
  sgd_step       optimizer delta: Adam's moment traffic vs plain SGD
  identity_loss  CE delta: softmax-CE over the 50k vocab vs mean(logits)
  fwd_only       forward pass alone (bwd+update = step - fwd)

Timing follows the calibrate tool's protocol (`calibrate.time_windows`):
warm-up calls, then windows of back-to-back calls each ended by a device
sync, the median window's mean, and each variant's spread ((max - min) /
median over its windows) printed beside it. The model runs on the card
unless `--device cpu` is given.

    python -m flexflow_tpu_torch.tools.perf_probe [--iters 20]
        [--windows 3] [--telemetry-dir D] [--device cpu]
"""

from __future__ import annotations

import argparse
import gc
import sys


def probe(iters: int = 20, windows: int = 3, device: str = "cuda"):
    import numpy as np
    import torch

    from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,
                                    SGDOptimizer)
    from flexflow_tpu_torch import random as ff_random
    from flexflow_tpu_torch.device import resolve_device
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2
    from flexflow_tpu_torch.tools.calibrate import time_windows

    dev = resolve_device(device)
    cfg = GPT2Config.medium()
    cfg.dropout = 0.0
    batch = 8
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab, size=(batch, cfg.seq))
                           .astype(np.int32)).to(dev)
    pos = torch.from_numpy(np.tile(np.arange(cfg.seq, dtype=np.int32),
                                   (batch, 1))).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           size=(batch, cfg.seq))
                              .astype(np.int32)).to(dev)
    key = ff_random.key(0)

    def build(optimizer, loss_type):
        m = FFModel(FFConfig(batch_size=batch, compute_dtype="bfloat16",
                             only_data_parallel=True))
        build_gpt2(m, cfg, batch=batch)
        cm = m.compile(optimizer, loss_type=loss_type, metrics=[],
                       device=dev)
        cm.init(seed=0)
        return cm

    def time_steps(cm):
        def step(i):
            (cm.params, cm.opt_state, cm.state, _loss, _) = cm.train_step(
                cm.params, cm.opt_state, cm.state, [ids, pos], labels,
                ff_random.fold_in(key, i))
        return time_windows(step, dev, windows=windows, iters=iters,
                            warmup=2)

    def time_fwd(cm):
        def fwd(_i):
            cm.infer(cm.params, cm.state, [ids, pos])
        return time_windows(fwd, dev, windows=windows, iters=iters,
                            warmup=2)

    def free():
        gc.collect()  # FFModel and its CompiledModel refer to each other
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    timed = {}
    cm = build(AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy")
    timed["fwd_only"] = time_fwd(cm)
    timed["adam_step"] = time_steps(cm)
    del cm
    free()
    cm = build(SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy")
    timed["sgd_step"] = time_steps(cm)
    del cm
    free()
    cm = build(AdamOptimizer(alpha=1e-4), "identity")
    timed["identity_loss_step"] = time_steps(cm)
    del cm
    free()

    out = {f"{k}_ms": t["s"] * 1e3 for k, t in timed.items()}
    out["optimizer_delta_ms"] = out["adam_step_ms"] - out["sgd_step_ms"]
    out["ce_delta_ms"] = out["adam_step_ms"] - out["identity_loss_step_ms"]
    out["bwd_update_ms"] = out["adam_step_ms"] - out["fwd_only_ms"]
    out.update({f"{k}_spread": t["spread"] for k, t in timed.items()})
    _emit_telemetry(out, iters=iters, windows=windows)
    return out


def _emit_telemetry(out, **meta):
    """Land the probe's measurements in the unified span stream when a sink
    is active (--telemetry-dir here, or a prior telemetry.configure in the
    process): one `probe/<variant>` span per measurement, dur = the
    measured per-step time, so probe runs join the same corpus
    trace_report/span_dataset read instead of living on stdout only."""
    from flexflow_tpu_torch import telemetry as tel

    if not tel.enabled():
        return
    now = tel.now_us()
    for k, v in out.items():
        # deltas are derived, not measurements — record the timed variants
        if not k.endswith("_ms") or k.endswith("_delta_ms") \
                or k == "bwd_update_ms":
            continue
        tel.record(f"probe/{k[:-3]}", now - v * 1e3, now, cat="probe",
                   step_ms=float(v), **meta)
    tel.event("probe/summary", cat="probe",
              **{k: float(v) for k, v in out.items()}, **meta)
    tel.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("flexflow_tpu_torch.tools.perf_probe",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--telemetry-dir", default="",
                    help="also emit probe/<variant> spans into this "
                         "telemetry dir (unified span stream)")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the card)")
    args = ap.parse_args(argv)
    if args.telemetry_dir:
        from flexflow_tpu_torch import telemetry

        telemetry.configure(args.telemetry_dir)
    for k, v in probe(args.iters, args.windows, args.device).items():
        print(f"{k:26s} {v:9.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
