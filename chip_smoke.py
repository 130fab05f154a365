"""Chip smoke of the PyTorch/CUDA port: build, check and serve on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure (nothing is caught to let the run exit 0):

1. Environment: the card's name and power limit (nvidia-smi), then every
   kernel of the serving path built from flexflow_tpu_torch/csrc/ by one
   nvcc per source, all started together, with the build time.
2. Kernels against their plain PyTorch versions on the card, at the shapes
   the GPT-2 medium serving path gives them, in bf16 and in f32 (TF32 is
   off for every float32 product here, so f32 is compared at 1e-4). Each
   kernel is timed with CUDA events (L2 flushed before every launch)
   beside its plain version, one library call computing the same function
   (timed here only; the port never calls it) and its bound.
3. Serving: GPT-2 medium at full width and depth with random weights from
   the seed, bf16 compute, 8 slots, 16 requests of 32 new tokens, through
   `compile_serving` and `ContinuousBatchingScheduler`, once with the
   compute-dtype KV cache and once with the int8 cache. Every launch
   counter is set to 0 just before each run and read just after; a kernel
   of the path that was not launched fails the run. Each run's first
   prefill is repeated through the plain versions and compared.
4. Where the time goes: after each run, torch.profiler over two prefills
   and 16 decode steps of that engine (8 slots busy): host wall time per
   call, the device's busy time and idle share, the top kernels.

The line before the last is `{"kernels": [...]}`; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# the card's published peaks (H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12   # outside the tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# GPT-2 medium serving shapes (models/gpt2.py GPT2Config.medium)
SLOTS, SEQ, HEADS, HEAD_DIM, LAYERS = 8, 1024, 16, 64, 24
PAGE, NEW_TOKENS, REQUESTS = 16, 32, 16
CTX = -(-(SEQ + NEW_TOKENS) // PAGE) * PAGE        # 1056 cached positions


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
class Timer:
    """Median milliseconds of one call, from CUDA events around each
    launch, with the L2 cache flushed before every launch (the serving
    path finds each layer's inputs cold)."""

    def __init__(self, reps: int = 20, warmup: int = 3):
        self.reps, self.warmup = reps, warmup
        self.flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bound(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------- kernels
def check_flash(timer, gen):
    from flexflow_tpu_torch.kernels import flash_attention as fa

    b, h, s, d = SLOTS, HEADS, SEQ, HEAD_DIM
    scale = d ** -0.5
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   .to(dt) for _ in range(3))
        out = fa.flash_attention_qkv(q, k, v, causal=True, scale=scale)
        torch.cuda.synchronize()
        ref = fa._fwd_plain(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), True, scale)[0].transpose(1, 2)
        errs[dt] = float((out.float() - ref.float()).abs().max())
        if not errs[dt] <= TOL[dt]:
            fail(f"flash {dt}: max err {errs[dt]} > {TOL[dt]}")
        log(f"flash_attention {tuple(q.shape)} {dt} causal: max abs err "
            f"{errs[dt]:.3e} (tolerance {TOL[dt]})")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # bf16, (b,h,s,d)
    ms = timer(lambda: fa.flash_attention_qkv(q, k, v, causal=True,
                                              scale=scale))
    plain_ms = timer(lambda: fa._fwd_plain(qt, kt, vt, True, scale))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale))
    n = b * h * s * d
    bound_ms, bound_by = bound(4 * n * 2 + b * h * s * 4,
                               4 * b * h * d * s * (s + 1) / 2, BF16_FLOPS)
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/flash_attention.cu",
            "replaces": "flexflow_tpu/kernels/flash_attention.py:151",
            "shape": [b, s, h, d], "dtype": "bfloat16", "causal": True,
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_f32": errs[torch.float32],
            "tolerance": TOL[torch.bfloat16], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library": "torch.nn.functional.scaled_dot_product_attention"}


def check_dequant(timer, gen, seed):
    from flexflow_tpu_torch.kernels import dequant_attention as da
    from flexflow_tpu_torch.serving.kv_cache import kv_quantize

    b, s, h, d, L = SLOTS, 1, HEADS, HEAD_DIM, CTX
    scale = d ** -0.5
    kq, ks = kv_quantize(torch.randn((b, L, h, d), generator=gen,
                                     device="cuda"))
    vq, vs = kv_quantize(torch.randn((b, L, h, d), generator=gen,
                                     device="cuda"))
    # cached extents as the serving run meets them: prompt 32..992 plus
    # up to 32 decoded tokens
    pos_np = np.random.default_rng(seed).integers(32, SEQ, size=b)
    pos = torch.from_numpy(pos_np.astype(np.int32)).cuda()
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        qh = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
        out = da.dequant_decode_attention(qh, kq, ks, vq, vs, pos, scale)
        torch.cuda.synchronize()
        ref = da._plain(qh, kq, ks, vq, vs, pos, scale)
        errs[dt] = float((out.float() - ref.float()).abs().max())
        if not errs[dt] <= TOL[dt]:
            fail(f"dequant {dt}: max err {errs[dt]} > {TOL[dt]}")
        log(f"dequant_decode_attention q {tuple(qh.shape)} {dt} vs int8 "
            f"context {tuple(kq.shape)}: max abs err {errs[dt]:.3e} "
            f"(tolerance {TOL[dt]})")
    ms = timer(lambda: da.dequant_decode_attention(qh, kq, ks, vq, vs, pos,
                                                   scale))
    plain_ms = timer(lambda: da._plain(qh, kq, ks, vq, vs, pos, scale))
    keep = (torch.arange(L, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]      # (b, 1, 1, L)

    def library():
        kf = (kq.float() * ks[..., None]).to(qh.dtype).transpose(1, 2)
        vf = (vq.float() * vs[..., None]).to(qh.dtype).transpose(1, 2)
        return F.scaled_dot_product_attention(qh.transpose(1, 2), kf, vf,
                                              attn_mask=keep, scale=scale)
    lib_ms = timer(library)
    # this run's data needs keys 0..pos+s-1 of each slot: int8 K and V
    # values plus their f32 scales, the queries, the output and pos
    keys = float((pos_np + s).sum())
    nbytes = keys * h * (2 * d + 2 * 4) + 2 * b * s * h * d * 2 + 4 * b
    bound_ms, bound_by = bound(nbytes, 4 * keys * h * s * d + 2 * keys * h * d,
                               F32_FLOPS)
    return {"name": "dequant_decode_attention", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/dequant_attention.cu",
            "replaces": "flexflow_tpu/kernels/dequant_attention.py:69",
            "shape": [b, s, h, d], "context": L, "dtype": "bfloat16",
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_f32": errs[torch.float32],
            "tolerance": TOL[torch.bfloat16], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library": "dequantize + scaled_dot_product_attention"}


# ---------------------------------------------------------------- serving
class PlainKernels:
    """Swap each kernel wrapper's launch for its plain version, to run the
    same program through the plain versions on the card. Fails if a kernel
    was launched inside the block all the same (the swap missed it)."""

    def __enter__(self):
        from flexflow_tpu_torch.kernels import dequant_attention as da
        from flexflow_tpu_torch.kernels import flash_attention as fa
        self.mods = (fa, da)
        self.counts = [m.launches for m in self.mods]
        self.saved = [(fa, "_fwd_cuda", fa._fwd_cuda), (da, "_cuda", da._cuda)]
        fa._fwd_cuda = fa._fwd_plain
        da._cuda = da._plain
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        if [m.launches for m in self.mods] != self.counts:
            fail("a kernel launched inside the plain-version run")


def serve(engine, params, prompts, label: str):
    """One scheduler run over `prompts`, with every launch counter set to
    0 just before it; returns the summary (counts read just after)."""
    from flexflow_tpu_torch.kernels import dequant_attention as da
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            Request, gpt2_prompt_inputs,
                                            gpt2_step_inputs)

    first, finite = {}, []
    prefill, decode_step = engine.prefill, engine.decode_step

    def watched_prefill(p, inputs):
        logits, kv = prefill(p, inputs)
        first.setdefault("inputs", inputs)
        first.setdefault("logits", logits)
        finite.append(torch.isfinite(logits).all())
        return logits, kv

    def watched_decode(p, state, inputs):
        logits, ns = decode_step(p, state, inputs)
        finite.append(torch.isfinite(logits).all())
        return logits, ns

    engine.prefill, engine.decode_step = watched_prefill, watched_decode
    reqs = [Request(rid=i, prompt=prompt, max_new_tokens=NEW_TOKENS)
            for i, prompt in enumerate(prompts)]
    sched = ContinuousBatchingScheduler(engine, params, gpt2_prompt_inputs,
                                        gpt2_step_inputs)
    dev = engine.device
    sync(dev)
    fa.launches = da.launches = 0
    t0 = time.perf_counter()
    done = sched.run(reqs)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = {"flash_attention_fwd": fa.launches,
              "dequant_decode_attention": da.launches}
    engine.prefill, engine.decode_step = prefill, decode_step

    if len(done) != len(prompts) or sched.shed:
        fail(f"{label}: {len(done)} of {len(prompts)} requests completed")
    for r in done:
        if len(r.tokens) != NEW_TOKENS or not all(
                0 <= t < engine.model.layers[-1].params["out_dim"]
                for t in r.tokens):
            fail(f"{label}: request {r.rid} has {len(r.tokens)} tokens")
    if not bool(torch.stack(finite).all()):
        fail(f"{label}: non-finite logits")

    # the first prefill again, through the plain versions
    lengths = np.array([len(p) for p in prompts[:engine.slots]])
    rows = torch.arange(len(lengths), device=dev)
    last = torch.from_numpy(lengths - 1).to(dev)
    with PlainKernels(), torch.no_grad():
        plain, _ = prefill(params, first["inputs"])
    got = first["logits"][rows, last].float()
    want = plain[rows, last].float()
    err = float((got - want).abs().max())
    if not err <= TOL[torch.bfloat16]:
        fail(f"{label}: first prefill through the kernels vs plain: "
             f"max err {err} > {TOL[torch.bfloat16]}")
    ttft = np.array([r.ttft_s for r in done])
    tokens = sum(len(r.tokens) for r in done)
    return {"kv_cache_dtype": label, "requests": len(done),
            "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
            "ttft_p99_ms": 1e3 * float(np.percentile(ttft, 99)),
            "decode_step_p50_ms": 1e3 * float(np.median(sched.step_times)),
            "prefills": sched.prefills, "decode_steps": sched.decode_steps,
            "launches": counts, "first_prefill_max_err_vs_plain": err,
            "logit_abs_max": float(got.abs().max())}


def _device_profile(fn, reps: int, dev: torch.device) -> dict:
    """Run `fn` `reps` times under torch.profiler: host wall time per call,
    the device's busy time (union of kernel intervals) and idle share, and
    the kernels that took the most device time. Empty when the profiler
    records no kernel (then the device split is not measured)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync(dev)
        wall_us = 1e6 * (time.perf_counter() - t0)
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return {"device": "not measured (the profiler saw no kernel)"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy, cur_s = busy + cur_e - cur_s, s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name: dict = {}
    for e in kern:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"calls": reps, "wall_ms_per_call": wall_us / reps / 1e3,
            "device_busy_ms_per_call": busy / reps / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "kernel_launches_per_call": len(kern) / reps,
            "top_kernels": [{"name": n[:80], "ms_per_call": t / reps / 1e3,
                             "launches_per_call": c / reps}
                            for n, (t, c) in top]}


def profile_engine(engine, params, prompts) -> dict:
    """Where a prefill and a decode step spend their time: the first
    wave's prompts prefilled into every slot, then decode steps over all
    slots, each phase in its own profiled window."""
    from flexflow_tpu_torch.serving import gpt2_prompt_inputs, gpt2_step_inputs

    kv, slots = engine.kv, engine.slots
    seq = int(engine.prefill_model.input_tensors[0].spec.shape[1])
    ids = np.zeros((slots, seq), np.int32)
    lengths = np.zeros((slots,), np.int32)
    for s, p in enumerate(prompts[:slots]):
        ids[s, :len(p)], lengths[s] = p, len(p)
        kv.admit(s, len(p), len(p) + NEW_TOKENS)
    kv.push()
    inputs = gpt2_prompt_inputs(ids, lengths)
    dev = engine.device
    out = {"prefill": _device_profile(lambda: engine.prefill(params, inputs),
                                      2, dev)}
    _, kv_state = engine.prefill(params, inputs)
    kv.commit_prefill(kv_state, np.arange(slots, dtype=np.int32), lengths)
    box = {"state": kv.state,
           "tok": torch.ones((slots, 1), dtype=torch.int32, device=dev)}

    def step():
        st = box["state"]
        logits, box["state"] = engine.decode_step(
            params, st, gpt2_step_inputs(box["tok"], st))
        box["tok"] = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    steps = NEW_TOKENS // 2
    out["decode_step"] = _device_profile(step, steps, dev)
    kv.adopt(box["state"])
    kv.sync_after(steps)
    for s in range(slots):
        kv.evict(s)
    kv.push()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs on the GPU")

    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.kernels._build import build_all, build_log
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2
    from flexflow_tpu_torch.serving import compile_serving

    # TF32 off: float32 products run in full float32 in every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off (torch.backends.cuda.matmul and cudnn)")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- 1. build
    kernels = ("flash_attention", "dequant_attention")
    t0 = time.perf_counter()
    paths = build_all(kernels)
    log(f"built {len(paths)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in kernels:
        for line in build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = Timer()
    rows = [check_flash(timer, gen), check_dequant(timer, gen, args.seed)]
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")

    # ---- 3. serve GPT-2 medium, compute-dtype KV then int8 KV
    gc = GPT2Config.medium()
    rng = np.random.default_rng(args.seed)
    prompts = [[int(t) for t in rng.integers(0, gc.vocab, size=n)]
               for n in rng.integers(32, 993, size=REQUESTS)]
    warm = [p[:32] for p in prompts[:2]]
    runs, params = [], None
    for kv in ("auto", "int8"):
        cfg = FFConfig(seed=args.seed, compute_dtype="bfloat16",
                       max_batch_slots=SLOTS, kv_page_size=PAGE,
                       max_decode_len=NEW_TOKENS, kv_cache_dtype=kv)
        model = FFModel(cfg)
        build_gpt2(model, gc, batch=SLOTS)
        t0 = time.perf_counter()
        engine = compile_serving(model)
        params = (engine.init(seed=args.seed) if params is None
                  else engine.load_params(params))
        torch.cuda.synchronize()
        log(f"[{kv}] engine on {engine.device}, params "
            f"{engine.memory_stats()['actual_param_bytes'] / 2**20:.0f} MiB, "
            f"KV cache {engine.memory_stats()['actual_kv_cache_bytes'] / 2**20:.0f}"
            f" MiB, set up in {time.perf_counter() - t0:.1f} s")
        serve(engine, params, warm, f"{kv} warm-up")
        run = serve(engine, params, prompts, kv)
        log(f"[{kv}] {run['tokens_per_s']:.1f} tokens/s, TTFT p50 "
            f"{run['ttft_p50_ms']:.1f} ms p99 {run['ttft_p99_ms']:.1f} ms, "
            f"decode step p50 {run['decode_step_p50_ms']:.2f} ms, "
            f"launches {run['launches']}")
        run["profile"] = profile_engine(engine, params, prompts)
        for phase, prof in run["profile"].items():
            if "wall_ms_per_call" in prof:
                log(f"[{kv}] {phase}: {prof['wall_ms_per_call']:.2f} ms wall, "
                    f"device busy {prof['device_busy_ms_per_call']:.2f} ms, "
                    f"idle share {prof['device_idle_share']:.3f}, "
                    f"{prof['kernel_launches_per_call']:.0f} kernel launches")
        runs.append(run)
        del engine
        torch.cuda.empty_cache()

    flash_runs = [r["launches"]["flash_attention_fwd"] for r in runs]
    deq_runs = [r["launches"]["dequant_decode_attention"] for r in runs]
    if min(flash_runs) <= 0:
        fail(f"flash kernel not launched on the serving path: {flash_runs}")
    if deq_runs[1] <= 0 or deq_runs[0] != 0:
        fail(f"dequant kernel launches per run (auto, int8): {deq_runs}")
    rows[0]["launches"] = sum(flash_runs)
    rows[1]["launches"] = sum(deq_runs)
    for r in rows:
        r["card"] = card
    log(json.dumps({"serve": runs}))
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
