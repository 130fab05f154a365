"""Cost-model calibration harness: analytic vs simulated vs measured vs
whole-step time (counterpart: tools/calibrate.py).

Reference analog: the simulator's fidelity contract — per-op costs come
from real on-device microbenchmarks (Op::inner_measure_operator_cost,
src/runtime/model.cu:38-74) and are trusted to predict the iteration time.
This harness quantifies that error per workload, under the data-parallel
strategy on `MachineSpec.detect()` (the "h100" preset on the card,
"cpu-sim" on the CPU):

  analytic   = Σ per-layer analytic roofline op_time
  simulated  = the event-driven task-graph replay of the same strategy
               (search/simulator.py: the same per-op costs on per-stream
               timelines plus the optimizer's update tasks)
  measured   = Σ per-layer MeasuredCost op_time (each op alone, on the
               device, in the compute dtype)
  step       = the real train_step (forward, backward, SGD update)

Timing protocol (`time_windows`, shared with perf_probe): warm-up calls,
then `windows` windows of `iters` back-to-back calls, each window ended by
a device sync; the step is the median window's mean, and the spread
((max - min) / median over the windows) is published beside it. There is
no transport floor to subtract: the host drives the card directly, and
the sync that closes a window costs what `sync_floor_s` measures (a
`torch.cuda.synchronize()` on an idle device, a few microseconds on an
H100 host).

Reliability rule: a row is `reliable` when its shortest window lasts at
least MIN_WINDOW_OVER_SYNC (100) times the sync floor, so the closing sync
is under 1% of what a window times, and its spread is at most MAX_SPREAD
(0.25), so the host's noise does not decide the ratio. An unreliable row
keeps its numbers and is marked, not dropped.

`measure_overlap` asks whether independent memory-bound work hides behind
a tensor-core matmul chain: on the same stream (the negative control: one
stream runs its kernels in order) and on a second CUDA stream (the way a
collective's kernels run beside compute). Nothing here changes a machine
preset.

The entry point runs on the card unless `--device cpu` is given, and
writes a report only where `--out` says:

    python -m flexflow_tpu_torch.tools.calibrate [--workloads mlp,cnn]
        [--out calibration.md] [--device cpu] [--no-overlap]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Any, Callable, Dict, List, Optional

MIN_WINDOW_OVER_SYNC = 100.0
MAX_SPREAD = 0.25
WORKLOADS = ("mlp", "cnn", "gpt2_block", "gpt2_medium_block", "gpt2_medium")


# ------------------------------------------------------------------ timing
def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sync_floor_s(device, reps: int = 50) -> float:
    """The median cost of the sync that ends a window, on an idle device
    (0 on the CPU, where nothing is queued)."""
    import torch

    if torch.device(device).type != "cuda":
        return 0.0
    sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        torch.cuda.synchronize(device)
        ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


def time_windows(call: Callable[[int], Any], device, windows: int = 3,
                 iters: int = 5, warmup: int = 2) -> Dict[str, Any]:
    """Seconds a call: `warmup` calls, then `windows` windows of `iters`
    calls (`call(i)`, i counting on from the warm-up), each ended by a
    device sync. Returns the median window's mean, every window's mean,
    the spread and the shortest window's length."""
    i = 0
    for _ in range(warmup):
        call(i)
        i += 1
    sync(device)
    per = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            call(i)
            i += 1
        sync(device)
        per.append((time.perf_counter() - t0) / iters)
    med = float(statistics.median(per))
    return {"s": med, "windows_s": per,
            "spread": (max(per) - min(per)) / med if med > 0 else 0.0,
            "min_window_s": min(per) * iters}


def reliable(timing: Dict[str, Any], floor_s: float) -> bool:
    """The module's reliability rule."""
    return (timing["min_window_s"] >= MIN_WINDOW_OVER_SYNC * floor_s
            and timing["spread"] <= MAX_SPREAD)


# --------------------------------------------------------------- workloads
def _workloads():
    import numpy as np

    from flexflow_tpu_torch import FFConfig, FFModel

    def mlp():
        m = FFModel(FFConfig(batch_size=64, only_data_parallel=True))
        x = m.create_tensor([64, 512], name="x")
        h = m.dense(x, 1024, activation="relu", name="fc1")
        h = m.dense(h, 1024, activation="relu", name="fc2")
        m.dense(h, 10, name="head")
        y = np.random.default_rng(0).integers(0, 10, size=(64,)).astype(np.int32)
        return m, np.random.default_rng(1).normal(size=(64, 512)).astype(np.float32), y

    def cnn():
        m = FFModel(FFConfig(batch_size=32, only_data_parallel=True))
        x = m.create_tensor([32, 3, 32, 32], name="x")
        h = m.conv2d(x, 32, 3, 3, padding_h=1, padding_w=1, activation="relu", name="c1")
        h = m.pool2d(h, 2, 2, 2, 2, name="p1")
        h = m.conv2d(h, 64, 3, 3, padding_h=1, padding_w=1, activation="relu", name="c2")
        h = m.pool2d(h, 2, 2, 2, 2, name="p2")
        h = m.flat(h, name="flat")
        m.dense(h, 10, name="head")
        y = np.random.default_rng(0).integers(0, 10, size=(32,)).astype(np.int32)
        return m, np.random.default_rng(1).normal(size=(32, 3, 32, 32)).astype(np.float32), y

    def gpt2_block():
        from flexflow_tpu_torch.models import GPT2Config, build_gpt2

        cfg = GPT2Config(vocab=2048, seq=64, d_model=256, heads=4, layers=1,
                         dropout=0.0)
        m = FFModel(FFConfig(batch_size=4, only_data_parallel=True))
        build_gpt2(m, cfg, batch=4)
        rng = np.random.default_rng(0)
        ids = rng.integers(0, cfg.vocab, size=(4, 64)).astype(np.int32)
        pos = np.tile(np.arange(64, dtype=np.int32), (4, 1))
        lab = rng.integers(0, cfg.vocab, size=(4, 64)).astype(np.int32)
        return m, [ids, pos], lab

    def _gpt2_medium(layers):
        # the shapes the search ranks: b8, seq 1024, d_model 1024, bf16
        from flexflow_tpu_torch.models import GPT2Config, build_gpt2

        cfg = GPT2Config.medium()
        cfg.layers = layers
        cfg.dropout = 0.0
        m = FFModel(FFConfig(batch_size=8, compute_dtype="bfloat16",
                             only_data_parallel=True))
        build_gpt2(m, cfg, batch=8)
        rng = np.random.default_rng(0)
        ids = rng.integers(0, cfg.vocab, size=(8, cfg.seq)).astype(np.int32)
        pos = np.tile(np.arange(cfg.seq, dtype=np.int32), (8, 1))
        lab = rng.integers(0, cfg.vocab, size=(8, cfg.seq)).astype(np.int32)
        return m, [ids, pos], lab

    return [("mlp", mlp), ("cnn", cnn), ("gpt2_block", gpt2_block),
            # one production-width block, and the full model (config #5)
            ("gpt2_medium_block", lambda: _gpt2_medium(1)),
            ("gpt2_medium", lambda: _gpt2_medium(24))]


def predicted(model, machine) -> Dict[str, Any]:
    """The DP strategy's choices and its analytic and simulated times."""
    from flexflow_tpu_torch.search.dp import search_graph
    from flexflow_tpu_torch.search.simulator import simulate_strategy

    r = search_graph(model, machine, enable_parameter=False,
                     enable_attribute=False)
    analytic = sum(r.choices[l.name].op_time(l, machine)
                   for l in model.layers)
    simulated = simulate_strategy(model, r.choices, machine).makespan
    return {"choices": r.choices, "analytic_s": analytic,
            "simulated_s": simulated}


def calibrate(names=None, device: str = "cuda", windows: int = 3,
              iters: int = 5, measured_costs: Optional[dict] = None):
    """The rows of the named workloads (all five by default) and the
    machine. `measured_costs` maps a compute dtype to a MeasuredCost to
    reuse (its cache holds ops measured before); the others are made
    here."""
    import numpy as np
    import torch

    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch import random as ff_random
    from flexflow_tpu_torch.device import resolve_device
    from flexflow_tpu_torch.parallel.machine import MachineSpec
    from flexflow_tpu_torch.search.measure import MeasuredCost

    dev = resolve_device(device)
    machine = MachineSpec.detect(device=dev)
    floor = sync_floor_s(dev)
    mcs = dict(measured_costs or {})
    rows = []
    for name, build in _workloads():
        if names and name not in names:
            continue
        model, x, y = build()
        pred = predicted(model, machine)
        choices = pred["choices"]
        dtype = model.config.compute_dtype
        mc = mcs.get(dtype)
        if mc is None:
            mc = mcs[dtype] = MeasuredCost(
                machine, repeats=5, warmup=2, device=dev, compute_dtype=dtype,
                enable_fusion=model.config.enable_fusion)
        measured = sum(mc.op_time(l, choices[l.name]) for l in model.layers)

        loss_t = ("sparse_categorical_crossentropy"
                  if np.asarray(y).dtype == np.int32 else "mean_squared_error")
        cm = model.compile(SGDOptimizer(lr=0.01), loss_type=loss_t,
                           metrics=[], device=dev)
        cm.init(seed=0)
        xs = x if isinstance(x, list) else [x]
        dx = [torch.from_numpy(a).to(dev) for a in xs]
        dy = torch.from_numpy(y).to(dev)
        key = ff_random.key(0)
        losses = []

        def step(i):
            (cm.params, cm.opt_state, cm.state, loss, _) = cm.train_step(
                cm.params, cm.opt_state, cm.state, dx, dy,
                ff_random.fold_in(key, i))
            losses.append(loss)

        t = time_windows(step, dev, windows=windows, iters=iters)
        best = t["s"]
        row = {
            "workload": name,
            "compute_dtype": dtype,
            "analytic_ms": pred["analytic_s"] * 1e3,
            "simulated_ms": pred["simulated_s"] * 1e3,
            "measured_ms": measured * 1e3,
            "step_ms": best * 1e3,
            "step_windows_ms": [w * 1e3 for w in t["windows_s"]],
            "spread": t["spread"],
            "sync_floor_ms": floor * 1e3,
            "reliable": reliable(t, floor),
            "analytic_over_step": pred["analytic_s"] / best,
            "simulated_over_step": pred["simulated_s"] / best,
            "measured_over_step": measured / best,
            "last_loss": float(losses[-1]),
        }
        rows.append(row)
        del cm, model
    return rows, machine


# ---------------------------------------------------------- overlap probe
def measure_overlap(device: str = "cuda", n: int = 4096,
                    elems: int = 64 * 1024 * 1024, mem_steps: int = 8,
                    reps: int = 30, windows: int = 5) -> Dict[str, Any]:
    """Does independent memory-bound work (`mem_steps` chained elementwise
    scales of `elems` f32) hide behind a chain of 8 (n x n) bf16 matmuls?
    Each is timed alone and both together, on the same stream and with
    the scales on a second stream; `mem_steps` makes the two chains take
    comparable times (on an H100 ~1.4 and ~1.8 ms), so that the ratio
    below is not the noise of the shorter one. overlap_frac = (t_mm +
    t_mem - t_both) / min(t_mm, t_mem), clipped to [0, 1]; None where a
    time is degenerate. Every call feeds its output back as the next
    one's input, so the calls cannot run ahead of each other; each time
    is the median of `windows` windows of `reps` calls. On the CPU there
    is no second stream: that variant is not measured there."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    gen = torch.Generator(device="cpu").manual_seed(0)
    a = torch.randn((n, n), generator=gen).to(dev, torch.bfloat16)
    w = torch.randn((n, n), generator=gen).to(dev, torch.bfloat16)
    big = torch.randn((elems,), generator=gen).to(dev)
    inv = 1.0 / float(np.sqrt(n))

    def mm(x):
        for _ in range(8):
            # rescale inside the loop: each n-deep product grows the
            # elements ~sqrt(n)x, which would overflow the fed-back state
            x = (x @ w) * inv
        return x

    def mem(b):
        for _ in range(mem_steps):
            b = b * 1.0001
        return b

    side = torch.cuda.Stream(dev) if on_card else None

    def both_two(s):
        x, b = s
        main = torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            b2 = mem(b)
        x2 = mm(x)
        main.wait_stream(side)
        b2.record_stream(main)
        return x2, b2

    def chained(fn, state):
        box = [fn(state)]

        def call(_i):
            box[0] = fn(box[0])
        t = time_windows(call, dev, windows=windows, iters=reps, warmup=1)
        return t["s"]

    t_mm = chained(mm, a)
    t_mem = chained(mem, big)
    t_same = chained(lambda s: (mm(s[0]), mem(s[1])), (a, big))
    t_two = chained(both_two, (a, big)) if on_card else None

    def frac(t_both):
        if t_both is None or min(t_mm, t_mem, t_both) <= 1e-6:
            return None
        f = (t_mm + t_mem - t_both) / max(1e-12, min(t_mm, t_mem))
        return float(np.clip(f, 0.0, 1.0))

    return {"device": str(dev), "n": n, "elems": elems,
            "mem_steps": mem_steps,
            "t_mm_ms": t_mm * 1e3, "t_mem_ms": t_mem * 1e3,
            "t_both_same_stream_ms": t_same * 1e3,
            "t_both_two_streams_ms": (None if t_two is None
                                      else t_two * 1e3),
            "overlap_frac_same_stream": frac(t_same),
            "overlap_frac_two_streams": frac(t_two)}


# ------------------------------------------------------------------ report
def write_report(rows, machine, path: str, overlap=None,
                 device: str = "cuda") -> str:
    """Write the calibration table (and the overlap probe) to `path`."""
    import torch

    dev = torch.device(device)
    name = (f"`{torch.cuda.get_device_name(dev)}` (CUDA)"
            if dev.type == "cuda" else "`cpu`")
    fmt = "{:.5g}".format
    lines = [
        "# Cost-model calibration of flexflow_tpu_torch",
        "",
        f"Device: {name}; "
        f"machine model chip: `{machine.chip}`. Produced by "
        "`python -m flexflow_tpu_torch.tools.calibrate`.",
        "",
        "Columns: per-layer **analytic** roofline sum, the **simulated** "
        "task-graph replay, the per-layer isolated **measured** sum and "
        "the real whole **step** (forward, backward, SGD update), all "
        "under the data-parallel strategy. Ratios are predicted/actual "
        "(1.0 is perfect). The step is the median of windows ended by a "
        "device sync; spread = (max - min) / median over the windows.",
        "",
        "| workload | analytic (ms) | simulated (ms) | measured-sum (ms) | "
        "step (ms) | spread | analytic/step | simulated/step | "
        "measured/step | reliable |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['workload']} | {fmt(r['analytic_ms'])} | "
            f"{fmt(r['simulated_ms'])} | {fmt(r['measured_ms'])} | "
            f"{fmt(r['step_ms'])} | {fmt(r['spread'])} | "
            f"{fmt(r['analytic_over_step'])} | "
            f"{fmt(r['simulated_over_step'])} | "
            f"{fmt(r['measured_over_step'])} | "
            f"{'yes' if r['reliable'] else 'no'} |")
    lines += ["", f"A row is reliable when its shortest window lasts at "
              f"least {MIN_WINDOW_OVER_SYNC:g}x the sync floor and its "
              f"spread is at most {MAX_SPREAD:g}.", ""]
    if overlap is not None:
        def ms(v):
            return "not measured" if v is None else f"{v:.3f} ms"

        def fr(v):
            return "not measured" if v is None else f"{v:.3f}"
        lines += [
            "## Overlap probe",
            "",
            f"Eight ({overlap['n']} x {overlap['n']}) bf16 matmuls and "
            f"{overlap['mem_steps']} independent scales of "
            f"{overlap['elems']} f32, timed alone and together: on one "
            "stream (the negative control) and with the scales on a second "
            "stream.",
            "",
            f"- t(matmuls) = {ms(overlap['t_mm_ms'])}, t(scales) = "
            f"{ms(overlap['t_mem_ms'])}",
            f"- same stream: t(both) = "
            f"{ms(overlap['t_both_same_stream_ms'])}, overlap_frac = "
            f"{fr(overlap['overlap_frac_same_stream'])}",
            f"- two streams: t(both) = "
            f"{ms(overlap['t_both_two_streams_ms'])}, overlap_frac = "
            f"{fr(overlap['overlap_frac_two_streams'])}",
            "",
            f"The machine model's overlap_frac is {machine.overlap_frac:g}; "
            "this probe does not change it.",
            "",
        ]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        "flexflow_tpu_torch.tools.calibrate", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None,
                    help="write the markdown report here (default: none)")
    ap.add_argument("--workloads", default="",
                    help=f"comma-separated subset of {','.join(WORKLOADS)}")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the card)")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--no-overlap", action="store_true",
                    help="skip the overlap probe")
    args = ap.parse_args(argv)
    names = [w for w in args.workloads.split(",") if w] or None
    unknown = set(names or ()) - set(WORKLOADS)
    if unknown:
        ap.error(f"unknown workloads {sorted(unknown)}")
    rows, machine = calibrate(names, args.device, args.windows, args.iters)
    overlap = None if args.no_overlap else measure_overlap(args.device)
    for r in rows:
        print(r)
    if overlap is not None:
        print(overlap)
    if args.out:
        path = write_report(rows, machine, args.out, overlap=overlap,
                            device=args.device)
        print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
