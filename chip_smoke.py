"""Chip smoke of the PyTorch/CUDA port: build, check, serve and train on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure (nothing is caught to let the run exit 0):

1. Environment: the card's name and power limit (nvidia-smi), then every
   kernel of the serving and training paths built from
   flexflow_tpu_torch/csrc/ by one nvcc per source (five sources), all
   started together, with the build time, and the registers and spills
   that ptxas reports for each kernel (the three bf16 tensor-core
   kernels, flash forward, dQ and dK/dV, among them).
2. Kernels against their plain PyTorch versions on the card, at the shapes
   the GPT-2 medium paths give them, in bf16 and in f32 (TF32 is off for
   every float32 product here, so f32 is compared at 1e-4): the flash
   forward and the int8 dequant decode at the serving shapes (the decode
   through the page table, over a pool of 8 x 66 + 1 pages of 16 under a
   shuffled table, and through its gathered call), the flash
   backward's dQ and dK/dV at the training shape (8, 1024, 16, 64) causal,
   the fused Adam over GPT-2 medium's real param set (f32 and bf16
   moments, weight decay 0 and 0.01), the fused cross-entropy forward and
   backward at (8192, 50304) (GPT-2 medium's vocab padded to 128, bf16 and
   f32), and the fused SGD with and without a momentum trace over the
   padded model's param set. Each kernel is timed with CUDA
   events (L2 flushed before every launch, the device held busy while the
   host enqueues it; see `Timer`) beside its plain version, one
   library call computing the same function (timed here only; the port
   never calls it) and its bound. Each optimizer kernel is timed in turns
   with its library call, with the card's clocks read before and after,
   and its row carries the median of the per-pair ratios
   (`library_ratio`). The rows of the flash forward, dQ and dK/dV also
   carry their achieved TFLOP/s, their share of the bound and their
   design, the dequant decode's its share of the bound, its design and
   the timer's floor for a call that small (one tiny kernel). The
   forward's lse is held to the plain lse at 1e-4, and its bf16 O element
   by element to a bound on the rounding of P (see
   `flash_bf16_o_bound`); bf16 dQ is held element by element to a bound
   on the rounding of dS (`_dq_bf16_bound` in the flash module).
3. Serving: GPT-2 medium at full width and depth with random weights from
   the seed, bf16 compute, 8 slots, 16 requests of 32 new tokens, through
   `compile_serving` and `ContinuousBatchingScheduler`, once with the
   compute-dtype KV cache and once with the int8 cache. Every launch
   counter is set to 0 just before each run and read just after; a kernel
   of the path that was not launched fails the run. Each run's first
   prefill is repeated through the plain versions and compared.
4. Where the time goes: after each run, torch.profiler over two prefills
   and 16 decode steps of that engine (8 slots busy): host wall time per
   call, the device's busy time and idle share, the top kernels, and the
   host's `aten::index` calls (gathers); the int8 decode step fails if it
   gathers once a layer or more (on the host, or a gather kernel among the
   top kernels).
5. Training, through `FFModel.compile` and the `CompiledModel`:
   (a) gradient check: GPT-2 medium widths at 2 layers, one step through
       the kernels and one through the plain versions from the same
       params, in f32 and bf16: loss, every gradient, the updated params;
   (b) GPT-2 medium at full depth, b8, seq 1024, dropout 0, bf16, Adam
       1e-4: 2 warm-up and 10 timed steps on one batch, with step time,
       samples/s, tokens/s, MFU, peak memory and the loss at every step;
       the launch counters are set to 0 before the 12 steps and read after,
       and each step must have launched the flash forward, dQ and dK/dV
       once per layer, Adam once and nothing else; the optimizer's pointer
       table must be built in the first step and never again;
   (c) one `fit` epoch over 4 batches with `sync_every=0`, no table built;
   (d) torch.profiler over two train steps;
   (e) gradient check as (a), with the vocab padded to 128 (the fused
       cross-entropy kernels) and SGD with momentum (the fused SGD kernel);
       the update compared is -lr times the stored trace, and every
       updated param is held to the rounding bound of `sgd_param_excess`;
   (f) GPT-2 medium at full depth with the vocab padded to 128, b8, seq
       1024, bf16, SGD(0.01, momentum 0.9): 2 warm-up and 10 timed steps,
       reported and checked as (b); each step must launch the flash
       forward, dQ and dK/dV once per layer, each cross-entropy kernel and
       the SGD kernel once, and nothing else;
   (g) one `fit` epoch over 4 batches with `accum_steps=2`, SGD(0.01)
       without momentum, `sync_every=0`: 2 updates, 4 launches of each
       cross-entropy kernel and 2 of the trace-less SGD kernel, one table
       built;
   (h) torch.profiler over two steps of (f).

The line before the last is `{"kernels": [...]}`; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from gc import collect as collect_garbage

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
BATCH, LR, TRAIN_STEPS, WARMUP_STEPS = 8, 1e-4, 10, 2
# the padded-vocab SGD path: GPT2Config(vocab_pad_to=128) gives lm_head
# 50304 columns, which the fused cross-entropy gate admits; labels stay
# below GPT-2's true vocab of 50257
PAD_TO, PAD_VOCAB, GPT2_VOCAB, SGD_LR = 128, 50304, 50257, 0.01
PAGE, NEW_TOKENS, REQUESTS = 16, 32, 16
# the design of the kernels redesigned for the tensor cores
TC_DESIGN = {
    "flash_attention_fwd": "mma.sync m16n8k16 bf16, 2 m-tiles a warp, "
                           "cp.async x2 (K, V), bf16 smem padded rows, "
                           "P in registers",
    "flash_attention_dq": "mma.sync m16n8k16 bf16, cp.async x2 (K, V), "
                          "bf16 smem padded rows, Q and dO fragments held, "
                          "dS in registers",
    "flash_attention_dkv": "mma.sync m16n8k16 bf16, cp.async x2 (Q, dO, "
                           "lse, delta), bf16 smem padded rows, P^T and "
                           "dS^T in registers"}
DEQUANT_DESIGN = ("split-K: grid (slot x head, 128-key chunk), 4 warps a "
                  "block each on its own 32-key tile, page table read in "
                  "the kernel, cp.async into per-warp buffers, f32 "
                  "softmax, int8 widened by byte permute, warps merged in "
                  "shared memory, chunks by the last block's atomic ticket")
CTX = -(-(SEQ + NEW_TOKENS) // PAGE) * PAGE        # 1056 cached positions
LSE_TOL = 1e-4   # the forward's lse: f32 sums of up to 1024 exponentials


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
    path finds each layer's inputs cold). The device is held busy (a
    spin) while the host enqueues the call, so that the events time the
    device's work and not the host's: the spin lasts ~1 ms, or about twice
    the host's enqueue of the call in the warm-up where that is longer (the
    optimizer wrappers walk ~390 leaves in Python)."""

    HOLD_CYCLES = 2_000_000   # ~1 ms at the H100's clocks

    def __init__(self, reps: int = 20, warmup: int = 3):
        self.reps, self.warmup = reps, warmup
        self.flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")

    def hold_for(self, *fns) -> int:
        """Warm up each call; the spin, in cycles, that covers twice the
        median host enqueue of the slowest call."""
        enqueue_ms = 0.0
        for fn in fns:
            times = []
            for _ in range(self.warmup):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times.append(1e3 * (time.perf_counter() - t0))
            enqueue_ms = max(enqueue_ms, float(np.median(times)))
        torch.cuda.synchronize()
        return max(self.HOLD_CYCLES, int(2 * enqueue_ms * self.HOLD_CYCLES))

    def once(self, fn, hold: int) -> float:
        self.flush.zero_()
        torch.cuda._sleep(hold)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def __call__(self, fn) -> float:
        hold = self.hold_for(fn)
        return float(np.median([self.once(fn, hold)
                                for _ in range(self.reps)]))

    def alternate(self, kernel, library) -> dict:
        """The kernel and its library call timed in turns (kernel, library,
        kernel, ...), each with the same flush and spin: their medians and
        the median of the per-pair ratios kernel / library."""
        hold = self.hold_for(kernel, library)
        pairs = [(self.once(kernel, hold), self.once(library, hold))
                 for _ in range(self.reps)]
        k, lib = np.array(pairs).T
        return {"ms": float(np.median(k)), "library_ms": float(np.median(lib)),
                "library_ratio": float(np.median(k / lib)),
                "hold_cycles": hold}


def clocks() -> str:
    """The card's SM and memory clocks now (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bound(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tc_fields(name: str, flops: float, ms: float, bound_ms: float) -> dict:
    """What the rows of the redesigned kernels carry beside the others."""
    return {"tflops": flops / (ms * 1e-3) / 1e12, "bound_share": bound_ms / ms,
            "design": TC_DESIGN[name]}


def port_kernel_names() -> tuple:
    """The `__global__` functions of the port's CUDA sources: the names
    its kernels carry in a profile."""
    from flexflow_tpu_torch.kernels._build import CSRC_DIR

    return tuple(sorted({name for src in CSRC_DIR.glob("*.cu")
                         for name in re.findall(
                             r"__global__\s+void\s+(?:__launch_bounds__"
                             r"\([^)]*\)\s+)?(\w+)\s*\(", src.read_text())}))


def flash_bf16_o_bound(q, k, v, causal: bool, scale: float):
    """The largest |O - plain O| allowed, element by element, for the bf16
    forward on (b, h, s, d) views. Both round each p_j to bf16 before P.V,
    but from exp(s - m) against other maxima (the kernel's running max,
    the plain version's final one), so each term p_j v_j / l carries its
    own rounding error in each: at most 2**-8 relative, with a standard
    deviation below 2**-7 / sqrt(12), so below 2**-7 / sqrt(6) in their
    difference. Allowed: ten standard deviations of that sum, 10 * 2**-7 /
    sqrt(6) * sqrt(sum_j (p_j v_j)**2) / l, capped at its worst case 2**-7
    * sum_j p_j |v_j| / l, plus 2 bf16 ulps of |O| for O's own rounding."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(s.shape[-2], s.shape[-1], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)                     # p_j / l
    vf = v.float()
    o = p @ vf
    rss = torch.sqrt((p * p) @ (vf * vf))
    noise = torch.minimum(10 * 2 ** -7 / 6 ** 0.5 * rss, 2 ** -7 * (p @ vf.abs()))
    _, e = torch.frexp(o.abs().clamp_min(torch.finfo(torch.float32).tiny))
    return noise + 2 * torch.ldexp(torch.full_like(o, 2 ** -7), e - 1)


# ---------------------------------------------------------------- kernels
def check_flash(timer, gen):
    from flexflow_tpu_torch.kernels import flash_attention as fa

    b, h, s, d = SLOTS, HEADS, SEQ, HEAD_DIM
    scale = d ** -0.5
    errs, lse_errs = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   .to(dt) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # (b, h, s, d)
        out, lse = fa._fwd(qt, kt, vt, True, scale)
        torch.cuda.synchronize()
        ref, ref_lse = fa._fwd_plain(qt, kt, vt, True, scale)
        errs[dt] = float((out.float() - ref.float()).abs().max())
        lse_errs[dt] = float((lse - ref_lse).abs().max())
        if not errs[dt] <= TOL[dt]:
            fail(f"flash {dt}: max err {errs[dt]} > {TOL[dt]}")
        if not lse_errs[dt] <= LSE_TOL:
            fail(f"flash {dt}: lse err {lse_errs[dt]} > {LSE_TOL}")
        log(f"flash_attention {tuple(q.shape)} {dt} causal: max abs err "
            f"{errs[dt]:.3e} (tolerance {TOL[dt]}), lse {lse_errs[dt]:.3e} "
            f"(tolerance {LSE_TOL})")
        if dt == torch.bfloat16:
            excess = float(((out.float() - ref.float()).abs()
                            / flash_bf16_o_bound(qt, kt, vt, True, scale))
                           .max())
            if not excess <= 1.0:
                fail(f"flash bf16: O exceeds its element bound {excess}x")
            log(f"flash_attention bf16: O at most {excess:.3f} of its "
                "element-wise rounding bound")
    ms = timer(lambda: fa.flash_attention_qkv(q, k, v, causal=True,
                                              scale=scale))
    plain_ms = timer(lambda: fa._fwd_plain(qt, kt, vt, True, scale))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale))
    n = b * h * s * d
    flops = 4 * b * h * d * s * (s + 1) / 2
    bound_ms, bound_by = bound(4 * n * 2 + b * h * s * 4, flops, BF16_FLOPS)
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/flash_attention.cu",
            "replaces": "flexflow_tpu/kernels/flash_attention.py:151",
            "shape": [b, s, h, d], "dtype": "bfloat16", "causal": True,
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_f32": errs[torch.float32],
            "tolerance": TOL[torch.bfloat16], "o_bound_share": excess,
            "lse_err": lse_errs[torch.bfloat16],
            "lse_err_f32": lse_errs[torch.float32], "lse_tolerance": LSE_TOL,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library": "torch.nn.functional.scaled_dot_product_attention",
            **tc_fields("flash_attention_fwd", flops, ms, bound_ms)}


def check_dequant(timer, gen, seed):
    from flexflow_tpu_torch.kernels import dequant_attention as da
    from flexflow_tpu_torch.serving.kv_cache import kv_quantize

    b, s, h, d, L = SLOTS, 1, HEADS, HEAD_DIM, CTX
    pages_per_slot = L // PAGE
    scale = d ** -0.5
    pool = (b * pages_per_slot + 1, PAGE, h, d)
    kq, ks = kv_quantize(torch.randn(pool, generator=gen, device="cuda"))
    vq, vs = kv_quantize(torch.randn(pool, generator=gen, device="cuda"))
    # a shuffled page table: every page but the scratch page 0 belongs to
    # one slot, in an order drawn from the seed
    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.arange(1, pool[0])).reshape(b, pages_per_slot)
    table = torch.from_numpy(ids.astype(np.int32)).cuda()
    # cached extents as the serving run meets them: prompt 32..992 plus
    # up to 32 decoded tokens
    pos_np = rng.integers(32, SEQ, size=b)
    pos = torch.from_numpy(pos_np.astype(np.int32)).cuda()
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        qh = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
        out = da.paged_dequant_decode_attention(qh, kq, ks, vq, vs, table,
                                                pos, scale)
        torch.cuda.synchronize()
        ref = da._paged_plain(qh, kq, ks, vq, vs, table, pos, scale)
        errs[dt] = float((out.float() - ref.float()).abs().max())
        # the gathered call: the same kernel with each context one page
        gathered = [t[table.long()].reshape(b, L, *t.shape[2:])
                    for t in (kq, ks, vq, vs)]
        g_out = da.dequant_decode_attention(qh, *gathered, pos, scale)
        torch.cuda.synchronize()
        g_err = float((g_out.float() - da._plain(qh, *gathered, pos, scale)
                       .float()).abs().max())
        if not max(errs[dt], g_err) <= TOL[dt]:
            fail(f"dequant {dt}: max err paged {errs[dt]} gathered {g_err} "
                 f"> {TOL[dt]}")
        log(f"paged_dequant_decode_attention q {tuple(qh.shape)} {dt} vs int8 "
            f"pool {pool} under a shuffled table of {pages_per_slot} pages a "
            f"slot: max abs err {errs[dt]:.3e}, gathered call {g_err:.3e} "
            f"(tolerance {TOL[dt]})")
    ms = timer(lambda: da.paged_dequant_decode_attention(
        qh, kq, ks, vq, vs, table, pos, scale))
    plain_ms = timer(lambda: da._paged_plain(qh, kq, ks, vq, vs, table, pos,
                                             scale))
    keep = (torch.arange(L, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]      # (b, 1, 1, L)
    ptl = table.long()

    def library():
        kf = (kq[ptl].reshape(b, L, h, d).float()
              * ks[ptl].reshape(b, L, h)[..., None]).to(qh.dtype)
        vf = (vq[ptl].reshape(b, L, h, d).float()
              * vs[ptl].reshape(b, L, h)[..., None]).to(qh.dtype)
        return F.scaled_dot_product_attention(
            qh.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2),
            attn_mask=keep, scale=scale)
    lib_ms = timer(library)
    # what this timer reads for one launch of a kernel with no work to
    # speak of: the floor under a call this small
    one = torch.empty(1, device="cuda")
    floor_ms = timer(lambda: one.zero_())
    # this run's data needs keys 0..pos+s-1 of each slot: int8 K and V
    # values plus their f32 scales, the page ids that address them, the
    # queries, the output and pos
    keys = np.minimum(pos_np + s, L)
    nbytes = (float(keys.sum()) * h * (2 * d + 2 * 4)
              + 4 * float((-(-keys // PAGE)).sum())
              + 2 * b * s * h * d * 2 + 4 * b)
    bound_ms, bound_by = bound(nbytes, 4 * float(keys.sum()) * h * s * d
                               + 2 * float(keys.sum()) * h * d, F32_FLOPS)
    return {"name": "dequant_decode_attention", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/dequant_attention.cu",
            "replaces": "flexflow_tpu/kernels/dequant_attention.py:69",
            "shape": [b, s, h, d], "context": L, "page": PAGE,
            "pool_pages": pool[0], "dtype": "bfloat16",
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_f32": errs[torch.float32],
            "tolerance": TOL[torch.bfloat16], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library": "page gather + dequantize + "
                       "scaled_dot_product_attention",
            "bound_share": bound_ms / ms, "launch_floor_ms": floor_ms,
            "design": DEQUANT_DESIGN}


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|): the backward's outputs sum
    up to 1024 products, so their scale grows with the sequence."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def check_flash_bwd(timer, gen):
    """dQ and dK/dV at the training shape, against their plain versions,
    with the saved lse and delta of the forward; bf16 dQ also element by
    element against `_dq_bf16_bound`."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    b, h, s, d = BATCH, HEADS, SEQ, HEAD_DIM
    scale = d ** -0.5
    errs = {"dq": {}, "dkv": {}}
    for dt in (torch.float32, torch.bfloat16):
        # (b, s, h, d) storage viewed as (b, h, s, d), as the lowering has it
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                       .to(dt).transpose(1, 2) for _ in range(4))
        o, lse = fa._fwd(q, k, v, True, scale)
        delta = fa._delta(o, do).contiguous()
        args = (q, k, v, do, lse, delta, True, scale)
        dq = fa._dq_cuda(*args)
        dk, dv = fa._dkv_cuda(*args)
        torch.cuda.synchronize()
        pairs = {"dq": [(dq, fa._dq_plain(*args))],
                 "dkv": list(zip((dk, dv), fa._dkv_plain(*args)))}
        for name, outs in pairs.items():
            abs_err = max(float((a.float() - r.float()).abs().max())
                          for a, r in outs)
            scaled = max(rel_err(a, r) for a, r in outs)
            errs[name][dt] = abs_err
            if not scaled <= TOL[dt]:
                fail(f"flash {name} {dt}: error {scaled} > {TOL[dt]}")
            log(f"flash_attention_{name} {(b, s, h, d)} {dt} causal: max abs "
                f"err {abs_err:.3e}, over max(1, max |plain|) {scaled:.3e} "
                f"(tolerance {TOL[dt]})")
        if dt == torch.bfloat16:
            want = pairs["dq"][0][1].float()
            dq_bound = fa._dq_bf16_bound(*args)
            dq_elem = {
                "dq_bound_share": float(((dq.float() - want).abs()
                                         / dq_bound).max()),
                "median_abs_plain": float(want.abs().median()),
                "median_element_bound": float(dq_bound.median())}
            del want, dq_bound
            if not dq_elem["dq_bound_share"] <= 1.0:
                fail("flash dq bf16: exceeds its element bound "
                     f"{dq_elem['dq_bound_share']}x")
            log(f"flash_attention_dq bf16: at most "
                f"{dq_elem['dq_bound_share']:.3f} of its element-wise "
                f"rounding bound; median bound "
                f"{dq_elem['median_element_bound']:.3e}, median |plain| "
                f"{dq_elem['median_abs_plain']:.3e}")
    ms = {"dq": timer(lambda: fa._dq_cuda(*args)),
          "dkv": timer(lambda: fa._dkv_cuda(*args))}
    plain_ms = {"dq": timer(lambda: fa._dq_plain(*args)),
                "dkv": timer(lambda: fa._dkv_plain(*args))}
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                         scale=scale)
    lib_ms = timer(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                               retain_graph=True))
    n = b * h * s * d
    pairs = b * h * s * (s + 1) / 2        # causal (q, k) pairs
    rows = []
    for name, n_out, matmuls, src_line in (("dq", 1, 3, 274),
                                           ("dkv", 2, 4, 284)):
        # reads q, k, v, dO (bf16) and lse, delta (f32); writes the outputs
        nbytes = 4 * n * 2 + 2 * b * h * s * 4 + n_out * n * 2
        flops = matmuls * 2 * pairs * d
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
        row = {
            "name": f"flash_attention_{name}", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"flexflow_tpu/kernels/flash_attention.py:{src_line}",
            "shape": [b, s, h, d], "dtype": "bfloat16", "causal": True,
            "max_abs_err": errs[name][torch.bfloat16],
            "max_abs_err_f32": errs[name][torch.float32],
            "tolerance": TOL[torch.bfloat16],
            "tolerance_of": "max abs err / max(1, max |plain|)", "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            "library": "scaled_dot_product_attention backward (dQ, dK and "
                       "dV together)"}
        row.update(tc_fields(row["name"], flops, ms[name], bound_ms))
        if name == "dq":
            row.update(dq_elem)
        rows.append(row)
    return rows


def medium_param_specs(vocab_pad_to: int = 0):
    """GPT-2 medium's weight specs, in the order the CompiledModel holds
    them."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.core.graph import topo_order
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2

    model = FFModel(FFConfig(batch_size=BATCH))
    gc = GPT2Config.medium()
    gc.dropout, gc.vocab_pad_to = 0.0, vocab_pad_to
    build_gpt2(model, gc, batch=BATCH)
    return [(l.name, w, spec) for l in topo_order(model.layers)
            for w, spec in sorted(l.weight_specs.items())]


def against_library(timer, name: str, kernel, library) -> dict:
    """`Timer.alternate` of an optimizer kernel and its library call, with
    the card's SM and memory clocks read just before and just after (the
    optimizer kernels' times move between runs more than the others')."""
    before = clocks()
    out = timer.alternate(kernel, library)
    out["clocks_sm_mem"] = [before, clocks()]
    log(f"{name}: {out['ms']:.4f} ms against the library's "
        f"{out['library_ms']:.4f} ms, timed in turns, median ratio "
        f"{out['library_ratio']:.3f}, spin {out['hold_cycles']} cycles; "
        f"clocks (SM, memory) before {before}, after "
        f"{out['clocks_sm_mem'][1]}")
    return out


def check_adam(timer, gen):
    """The one-launch Adam over GPT-2 medium's 406 M params against its
    plain version (f32 and bf16 moments, weight decay 0 and 0.01), from
    moments already warm (count 2 -> 3)."""
    from flexflow_tpu_torch import AdamOptimizer
    from flexflow_tpu_torch.kernels import fused_optim as fo

    specs = medium_param_specs()

    def leaves(scale, dtype=torch.float32, positive=False):
        out = []
        for _, _, spec in specs:
            t = torch.randn(spec.shape, generator=gen, device="cuda") * scale
            out.append((t.abs() if positive else t).to(dtype))
        return out

    params, grads = leaves(0.02), leaves(1e-3)
    n_params = sum(p.numel() for p in params)
    errs = {}
    for sd in ("float32", "bfloat16"):
        for wd in (0.0, 0.01):
            plan = fo.plan_for(AdamOptimizer(alpha=LR, weight_decay=wd,
                                             state_dtype=sd))
            md = plan["state_dtype"]
            mus, nus = leaves(1e-3, md), leaves(1e-6, md, positive=True)
            runs = []
            for fn in (fo._adam_cuda, fo._adam_plain):
                ps = [p.clone() for p in params]
                ms_, ns_ = [m.clone() for m in mus], [v.clone() for v in nus]
                fn(plan, grads, ms_, ns_, ps, 3)
                runs.append((ps, ms_, ns_))
            torch.cuda.synchronize()
            (pk, mk, nk), (pp, mp, np_) = runs
            err = max(float((a - b).abs().max()) for a, b in zip(pk, pp))
            # moments: max abs err over max |plain| per tensor; a stored
            # bf16 moment may sit one bf16 ulp (2**-8) away
            merr = max(float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp_min(1e-30))
                       for a, b in zip(mk + nk, mp + np_))
            mtol = 1e-6 if md == torch.float32 else 2 ** -7
            errs[(sd, wd)] = err
            if not (err <= 1e-6 and merr <= mtol):
                fail(f"fused Adam {sd} wd={wd}: param err {err}, moment "
                     f"relative err {merr}")
            log(f"fused_adam {n_params} params, {sd} moments, wd {wd}: max "
                f"abs param err {err:.3e} (tolerance 1e-6), moment err "
                f"{merr:.3e} (max abs / max |plain|, tolerance {mtol:.1e})")
            del runs, pk, mk, nk, pp, mp, np_
    # timed: f32 moments, wd 0 (the training path's configuration)
    plan = fo.plan_for(AdamOptimizer(alpha=LR))
    mus, nus = leaves(1e-3), leaves(1e-6, positive=True)
    plain_ms = timer(lambda: fo._adam_plain(plan, grads, mus, nus, params, 3))
    lib_params = [p.clone() for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g
    opt = torch.optim.Adam(lib_params, lr=LR, fused=True)
    times = against_library(
        timer, "fused_adam",
        lambda: fo._adam_cuda(plan, grads, mus, nus, params, 3), opt.step)
    bound_ms, bound_by = bound(28.0 * n_params, 15.0 * n_params, F32_FLOPS)
    return {"name": "fused_adam", "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/fused_optim.cu",
            "replaces": "flexflow_tpu/kernels/fused_optim.py:140",
            "params": n_params, "leaves": len(params),
            "moment_dtype": "float32", "weight_decay": 0.0,
            "max_abs_err": errs[("float32", 0.0)],
            "max_abs_err_by_config": {f"{k[0]} wd={k[1]}": v
                                      for k, v in errs.items()},
            "tolerance": 1e-6, **times, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library": "torch.optim.Adam(fused=True).step"}


def ulp_err(got, want) -> float:
    """max over elements of |got - want| in ulps of got's dtype, the ulp
    taken at the larger of the two magnitudes."""
    eps = torch.finfo(got.dtype).eps                 # f32 2**-23, bf16 2**-7
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(
        torch.finfo(torch.float32).tiny)
    _, e = torch.frexp(mag)                          # mag in [2**(e-1), 2**e)
    ulp = torch.ldexp(torch.full_like(mag, eps), e - 1)
    return float(((g - w).abs() / ulp).max())


# Fused cross-entropy tolerances. Forward: lse and the row losses (values
# near 11) are f32 sums of 50304 exponentials taken in another order than
# the plain version's: 1e-5 absolute. Backward, from the same lse, element
# by element in ulps of the logits' dtype: the kernel's expf and PyTorch's
# exp may differ in the last bit, which can move an f32 dx by up to 2 ulps
# (the product with g/N rounds again) and round a bf16 dx one ulp the
# other way.
CE_TOL = {"fwd": 1e-5, "bwd_ulps": {torch.float32: 2, torch.bfloat16: 1}}


def check_fused_ce(timer, gen):
    """Both cross-entropy kernels at the padded training shape (8192,
    50304), labels in [0, 50257), against their plain versions in f32 and
    bf16; timed in bf16 (the path's dtype)."""
    from flexflow_tpu_torch.kernels import fused_ce as fc

    n, v = BATCH * SEQ, PAD_VOCAB
    y = torch.randint(0, GPT2_VOCAB, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    g = torch.ones((), device="cuda")
    gs = g / n
    errs = {"fwd": {}, "bwd": {}, "bwd_ulps": {}}
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn((n, v), generator=gen, device="cuda") * 2.0).to(dt)
        loss, lse = fc._fwd_cuda(x, y)
        dx = fc._bwd_cuda(x, y, lse, g)
        torch.cuda.synchronize()
        rloss, rlse = fc._fwd_plain(x, y)
        errs["fwd"][dt] = max(float((loss - rloss).abs().max()),
                              float((lse - rlse).abs().max()))
        rdx = fc._bwd_plain(x, y, lse, gs)
        errs["bwd"][dt] = float((dx.float() - rdx.float()).abs().max())
        errs["bwd_ulps"][dt] = ulp_err(dx, rdx)
        log(f"fused_ce ({n}, {v}) {dt}: forward max abs err (loss, lse) "
            f"{errs['fwd'][dt]:.3e} (tolerance {CE_TOL['fwd']}), backward "
            f"max abs err {errs['bwd'][dt]:.3e}, {errs['bwd_ulps'][dt]:g} "
            f"ulps of {dt} element by element (tolerance "
            f"{CE_TOL['bwd_ulps'][dt]})")
        if not (errs["fwd"][dt] <= CE_TOL["fwd"]
                and errs["bwd_ulps"][dt] <= CE_TOL["bwd_ulps"][dt]):
            fail(f"fused cross-entropy {dt}: {errs}")
        del loss, lse, dx, rloss, rlse, rdx
        torch.cuda.empty_cache()
    # timed in bf16: x is the last dtype of the loop
    _, lse = fc._fwd_cuda(x, y)
    y64 = y.long()
    fwd = {"ms": timer(lambda: fc._fwd_cuda(x, y)),
           "plain_ms": timer(lambda: fc._fwd_plain(x, y)),
           "library_ms": timer(lambda: F.cross_entropy(x.float(), y64))}
    xs = x.detach().requires_grad_()
    out = F.cross_entropy(xs.float(), y64)
    bwd = {"ms": timer(lambda: fc._bwd_cuda(x, y, lse, g)),
           "plain_ms": timer(lambda: fc._bwd_plain(x, y, lse, gs)),
           "library_ms": timer(lambda: torch.autograd.grad(
               out, (xs,), retain_graph=True))}
    del xs, out
    nv = float(n) * v
    rows = []
    for name, times, nbytes, src_line, lib in (
            ("fused_ce_fwd", fwd, nv * 2 + 4 * n + 8 * n, 139,
             "torch.nn.functional.cross_entropy(x.float(), y) (the unfused "
             "path's loss)"),
            ("fused_ce_bwd", bwd, 2 * nv * 2 + 8 * n + 4, 184,
             "backward of cross_entropy(x.float(), y) to the bf16 logits")):
        # a max, a subtraction, an exp and an add (fwd) or a subtraction,
        # an exp and a product (bwd) per element, in f32
        bound_ms, bound_by = bound(nbytes, 4 * nv, F32_FLOPS)
        k = name[-3:]
        tol = ({"tolerance": CE_TOL["fwd"], "tolerance_of": "max abs err"}
               if k == "fwd" else
               {"max_ulp_err": errs["bwd_ulps"][torch.bfloat16],
                "max_ulp_err_f32": errs["bwd_ulps"][torch.float32],
                "tolerance": CE_TOL["bwd_ulps"][torch.bfloat16],
                "tolerance_f32": CE_TOL["bwd_ulps"][torch.float32],
                "tolerance_of": "max ulps of the dtype, element by element"})
        rows.append({
            "name": name, "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/fused_ce.cu",
            "replaces": f"flexflow_tpu/kernels/fused_ce.py:{src_line}",
            "shape": [n, v], "dtype": "bfloat16",
            "max_abs_err": errs[k][torch.bfloat16],
            "max_abs_err_f32": errs[k][torch.float32], **tol, **times,
            "bound_ms": bound_ms, "bound_by": bound_by, "library": lib})
    return rows


def check_sgd(timer, gen):
    """The one-launch SGD over the padded GPT-2 medium param set against
    its plain version (no momentum, momentum 0.9, momentum 0.9 with weight
    decay 0.01, nesterov): equal to 1e-6, bit for bit expected. Timed in
    the two configurations the training paths run: SGD(0.01, momentum 0.9)
    with a trace, SGD(0.01) without."""
    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch.kernels import fused_optim as fo

    specs = medium_param_specs(PAD_TO)

    def leaves(scale):
        return [torch.randn(spec.shape, generator=gen, device="cuda") * scale
                for _, _, spec in specs]

    params, grads = leaves(0.02), leaves(1e-3)
    n_params = sum(p.numel() for p in params)
    configs = {"sgd": dict(lr=SGD_LR),
               "momentum": dict(lr=SGD_LR, momentum=0.9),
               "momentum wd=0.01": dict(lr=SGD_LR, momentum=0.9,
                                        weight_decay=0.01),
               "nesterov": dict(lr=SGD_LR, momentum=0.9, nesterov=True)}
    errs = {}
    for cname, kw in configs.items():
        plan = fo.plan_for(SGDOptimizer(**kw))
        traces = leaves(1e-3) if plan["momentum"] else None
        runs = []
        for fn in (fo._sgd_cuda, fo._sgd_plain):
            ps = [p.clone() for p in params]
            ts = None if traces is None else [t.clone() for t in traces]
            fn(plan, grads, ts, ps)
            runs.append(ps + (ts or []))
        torch.cuda.synchronize()
        errs[cname] = max(float((a - b).abs().max())
                          for a, b in zip(*runs))
        log(f"fused_sgd {n_params} params, {cname}: max abs err (params and "
            f"trace) {errs[cname]:.3e} (tolerance 1e-6)")
        if not errs[cname] <= 1e-6:
            fail(f"fused SGD {cname}: max abs err {errs[cname]}")
        del runs, traces
    rows = []
    for name, cname, src_line, bytes_per, flops_per in (
            ("fused_sgd", "momentum", 180, 20.0, 4.0),
            ("fused_sgd_plain", "sgd", 169, 12.0, 2.0)):
        kw = configs[cname]
        plan = fo.plan_for(SGDOptimizer(**kw))
        traces = leaves(1e-3) if plan["momentum"] else None
        plain_ms = timer(lambda: fo._sgd_plain(plan, grads, traces, params))
        lib_params = [p.clone() for p in params]
        for p, g in zip(lib_params, grads):
            p.grad = g
        mom = kw.get("momentum", 0.0)
        try:
            opt = torch.optim.SGD(lib_params, lr=SGD_LR, momentum=mom,
                                  fused=True)
            opt.step()
            lib = "torch.optim.SGD(fused=True).step"
        except (TypeError, RuntimeError):
            opt = torch.optim.SGD(lib_params, lr=SGD_LR, momentum=mom,
                                  foreach=True)
            lib = "torch.optim.SGD(foreach=True).step"
        times = against_library(
            timer, name, lambda: fo._sgd_cuda(plan, grads, traces, params),
            opt.step)
        del opt, lib_params, traces
        # g, p (and the trace) read once, p (and the trace) written once
        bound_ms, bound_by = bound(bytes_per * n_params, flops_per * n_params,
                                   F32_FLOPS)
        rows.append({
            "name": name, "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/fused_optim.cu",
            "replaces": f"flexflow_tpu/kernels/fused_optim.py:{src_line}",
            "params": n_params, "leaves": len(params), "config": kw,
            "max_abs_err": max(v for c, v in errs.items()
                               if (c == "sgd") == (name == "fused_sgd_plain")),
            "max_abs_err_by_config": errs, "tolerance": 1e-6, **times,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library": lib})
    return rows


# ---------------------------------------------------------------- serving
class PlainKernels:
    """Swap each kernel wrapper's launch for its plain version, to run the
    same program through the plain versions on the card. Fails if a kernel
    was launched inside the block all the same (the swap missed it)."""

    def __enter__(self):
        from flexflow_tpu_torch.kernels import dequant_attention as da
        from flexflow_tpu_torch.kernels import flash_attention as fa
        from flexflow_tpu_torch.kernels import fused_ce as fc
        from flexflow_tpu_torch.kernels import fused_optim as fo
        self.counts = launch_counts()
        swaps = [(fa, "_fwd_cuda", fa._fwd_plain),
                 (da, "_cuda", da._paged_plain),
                 (fa, "_dq_cuda", fa._dq_plain),
                 (fa, "_dkv_cuda", fa._dkv_plain),
                 (fo, "_adam_cuda", fo._adam_plain),
                 (fc, "_fwd_cuda", fc._fwd_plain),
                 # the kernel divides the cotangent by N on the card
                 (fc, "_bwd_cuda", lambda x2, y2, lse, g: fc._bwd_plain(
                     x2, y2, lse, g / x2.shape[0])),
                 (fo, "_sgd_cuda", fo._sgd_plain)]
        self.saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        if launch_counts() != self.counts:
            fail("a kernel launched inside the plain-version run")


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter, by the kernel's name."""
    from flexflow_tpu_torch.kernels import dequant_attention as da
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_ce as fc
    from flexflow_tpu_torch.kernels import fused_optim as fo
    return {"flash_attention_fwd": fa.launches,
            "flash_attention_dq": fa.launches_dq,
            "flash_attention_dkv": fa.launches_dkv,
            "dequant_decode_attention": da.launches,
            "fused_adam": fo.launches,
            "fused_ce_fwd": fc.launches_fwd,
            "fused_ce_bwd": fc.launches_bwd,
            "fused_sgd": fo.launches_sgd,
            "fused_sgd_plain": fo.launches_sgd_plain}


def zero_launch_counts() -> None:
    from flexflow_tpu_torch.kernels import dequant_attention as da
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_ce as fc
    from flexflow_tpu_torch.kernels import fused_optim as fo
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    da.launches = fo.launches = 0
    fc.launches_fwd = fc.launches_bwd = 0
    fo.launches_sgd = fo.launches_sgd_plain = 0


def serve(engine, params, prompts, label: str):
    """One scheduler run over `prompts`, with every launch counter set to
    0 just before it; returns the summary (counts read just after)."""
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
    zero_launch_counts()
    t0 = time.perf_counter()
    done = sched.run(reqs)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = launch_counts()
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
    events = prof.events()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    # gathers `pool[table]` (and any other advanced-index read) on the host
    gathers = sum(e.name == "aten::index" for e in events)
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    port: dict = {}
    port_name = re.compile(r"\b(" + "|".join(port_kernel_names()) + r")[<(]")
    for n, (t, c) in by_name.items():
        m = port_name.search(n)
        if m:
            pt, pc = port.get(m.group(1), (0.0, 0))
            port[m.group(1)] = (pt + t, pc + c)
    return {"calls": reps, "wall_ms_per_call": wall_us / reps / 1e3,
            "device_busy_ms_per_call": busy / reps / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "kernel_launches_per_call": len(kern) / reps,
            "aten_index_per_call": gathers / reps,
            "top_kernels": [{"name": n[:80], "ms_per_call": t / reps / 1e3,
                             "launches_per_call": c / reps}
                            for n, (t, c) in top],
            "port_kernels": {n: {"ms_per_call": t / reps / 1e3,
                                 "launches_per_call": c / reps}
                             for n, (t, c) in sorted(port.items())}}


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


# --------------------------------------------------------------- training
def gpt2_train_model(seed: int, layers: int, compute_dtype: str,
                     optimizer=None, vocab_pad_to: int = 0):
    """GPT-2 medium widths at `layers` deep, dropout 0, compiled for
    training with `optimizer` (Adam(1e-4) when None) and sparse CE, the
    lm_head padded to a multiple of `vocab_pad_to`, weights from the
    seed."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2

    gc = GPT2Config.medium()
    gc.layers, gc.dropout, gc.vocab_pad_to = layers, 0.0, vocab_pad_to
    model = FFModel(FFConfig(batch_size=BATCH, compute_dtype=compute_dtype,
                             seed=seed))
    build_gpt2(model, gc, batch=BATCH)
    cm = model.compile(optimizer or AdamOptimizer(alpha=LR),
                       "sparse_categorical_crossentropy", [])
    cm.init(seed=seed)
    return gc, model, cm


def train_batch(seed: int, vocab: int, n: int = BATCH):
    """ids, positions and labels as bench.py draws them, on the card."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(n, SEQ)).astype(np.int32)
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (n, 1))
    labels = rng.integers(0, vocab, size=(n, SEQ)).astype(np.int32)
    return ids, pos, labels


def l2_rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# (a): loss relative difference, gradient relative L2, relative L2 of the
# step's update to the params. f32 (TF32 off) differs by summation order
# only; bf16 by a bf16 rounding that lands the other way where an f32 sum
# differs in its last bits, through 2 layers of backward. Adam's first step
# is -lr sign(g) (up to eps), so the update's relative L2 is about
# 2 sqrt(share of elements whose gradient sign differs): the gradients
# near 0, where the bf16 noise decides the sign; 0.3 allows 2%.
GRAD_TOL = {"float32": {"loss": 1e-5, "grad": 1e-4, "update": 1e-3},
            "bfloat16": {"loss": 1e-2, "grad": 5e-2, "update": 3e-1}}
# (e), SGD with momentum: the update compared is the one the optimizer
# applies, -lr t', read from the trace it stores, not p' - p (where the
# params' own ulp swamps updates of a few ulps, e.g. on LayerNorm gains
# near 1). From a zero trace t' = g exactly, so the update is held to the
# gradient's tolerance.
GRAD_TOL_SGD = {dt: dict(tol, update=tol["grad"])
                for dt, tol in GRAD_TOL.items()}


def sgd_param_excess(p_k, p_p, d_k, d_p) -> float:
    """Each updated param is p' = fl(p + d) from the same p, with d the
    applied update, so IEEE rounding gives |p'_k - p'_p| <= |d_k - d_p| +
    one ulp of the larger p'. Returns the largest excess over that bound
    (<= 0 when it holds), in float64."""
    big = torch.maximum(p_k.abs(), p_p.abs())
    ulp = (torch.nextafter(big, torch.full_like(big, float("inf")))
           - big).double()
    return float(((p_k.double() - p_p.double()).abs()
                  - (d_k.double() - d_p.double()).abs() - ulp).max())


def train_grad_check(seed: int, optimizer_fn=None, vocab_pad_to: int = 0,
                     tols=GRAD_TOL, tag: str = "train") -> dict:
    """One step through the kernels and one through the plain versions,
    from the same params, at GPT-2 medium widths and 2 layers, with the
    optimizer `optimizer_fn()` (Adam(1e-4) when None). The key bias `bk`
    is left out of the gradient and update checks: its gradient is zero in
    exact arithmetic (the softmax cancels it), so both runs hold rounding
    noise there. Under SGD with momentum (no weight decay) the update is
    -lr t' from the stored trace, and every updated param is held to
    `sgd_param_excess`."""
    out = {}
    for dt in ("float32", "bfloat16"):
        gc, _, cm = gpt2_train_model(
            seed, 2, dt, optimizer_fn() if optimizer_fn else None,
            vocab_pad_to)
        sgd_lr = (cm.optimizer.lr if "trace" in cm.opt_state else None)
        ids, pos, labels = train_batch(seed + 1, gc.vocab)
        inputs = [torch.from_numpy(ids).cuda(), torch.from_numpy(pos).cuda()]
        label = torch.from_numpy(labels).cuda()
        p0 = {l: {w: t.detach().clone() for w, t in ws.items()}
              for l, ws in cm.params.items()}
        loss_k, _, _, g_k = cm.value_and_grads(cm.params, cm.state, inputs,
                                               label)
        with PlainKernels():
            loss_p, _, _, g_p = cm.value_and_grads(cm.params, cm.state,
                                                   inputs, label)
        grad_err = max(l2_rel(g_k[l][w], g_p[l][w])
                       for l in g_k for w in g_k[l] if w != "bk")
        updated, after = [], []
        for plain in (False, True):
            cm.load_params(p0)
            if plain:
                with PlainKernels():
                    cm.train_step(cm.params, cm.opt_state, cm.state, inputs,
                                  label)
            else:
                cm.train_step(cm.params, cm.opt_state, cm.state, inputs, label)
            after.append({l: {w: t.detach() for w, t in ws.items()}
                          for l, ws in cm.params.items()})
            updated.append({l: {w: (-sgd_lr * cm.opt_state["trace"][l][w]
                                    if sgd_lr is not None
                                    else t - p0[l][w])
                                for w, t in ws.items()}
                            for l, ws in after[-1].items()})
        upd_err = max(l2_rel(updated[0][l][w], updated[1][l][w])
                      for l in p0 for w in p0[l] if w != "bk")
        loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        tol = tols[dt]
        out[dt] = {"loss_kernels": float(loss_k), "loss_plain": float(loss_p),
                   "loss_rel_err": loss_err, "grad_rel_l2_max": grad_err,
                   "update_rel_l2_max": upd_err,
                   "update_read_as": ("-lr * trace" if sgd_lr is not None
                                      else "p' - p"), "tolerance": tol}
        ok = (loss_err <= tol["loss"] and grad_err <= tol["grad"]
              and upd_err <= tol["update"])
        excess = ""
        if sgd_lr is not None:
            out[dt]["param_excess_max"] = max(
                sgd_param_excess(after[0][l][w], after[1][l][w],
                                 updated[0][l][w], updated[1][l][w])
                for l in p0 for w in p0[l])
            ok = ok and out[dt]["param_excess_max"] <= 0.0
            excess = (f", params' worst excess over the rounding bound "
                      f"{out[dt]['param_excess_max']:.2e} (tolerance 0)")
        log(f"[{tag} {dt}, 2 layers] loss {float(loss_k):.6f} vs plain "
            f"{float(loss_p):.6f} (rel {loss_err:.2e}), worst gradient rel L2 "
            f"{grad_err:.2e}, worst update ({out[dt]['update_read_as']}) rel "
            f"L2 {upd_err:.2e}{excess} (tolerances {tol})")
        if not ok:
            fail(f"training step through the kernels vs plain ({dt}): "
                 f"{out[dt]}")
        del cm, g_k, g_p, updated, after, p0
        torch.cuda.empty_cache()
    return out


def train_full(seed: int, optimizer, vocab_pad_to: int, exact: dict,
               tag: str) -> tuple:
    """GPT-2 medium at full depth: 2 warm-up and 10 timed steps on one
    batch, the launch counters zeroed before the 12 steps and read after.
    `exact` gives every kernel's launches per step (a kernel it does not
    name must not launch). The optimizer's pointer table must be built
    in the first step and never again. Returns (summary, compiled model,
    device inputs, label)."""
    from flexflow_tpu_torch.kernels import fused_optim as fo

    gc, model, cm = gpt2_train_model(seed, LAYERS, "bfloat16", optimizer,
                                     vocab_pad_to)
    ids, pos, labels = train_batch(seed, gc.vocab)
    inputs = [torch.from_numpy(ids).cuda(), torch.from_numpy(pos).cuda()]
    label = torch.from_numpy(labels).cuda()
    losses = []

    def step():
        (cm.params, cm.opt_state, cm.state, loss, _) = cm.train_step(
            cm.params, cm.opt_state, cm.state, inputs, label)
        losses.append(loss)

    torch.cuda.synchronize()
    # an earlier model is freed only by the collector (FFModel and its
    # CompiledModel refer to each other): collect it before the peak is
    # reset, so that the peak counts this model's memory alone
    collect_garbage()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    builds0 = fo.table_builds
    for _ in range(WARMUP_STEPS):
        step()
    torch.cuda.synchronize()
    builds = [fo.table_builds - builds0]
    windows = []
    for _ in range(TRAIN_STEPS // 2):
        t0 = time.perf_counter()
        step()
        step()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / 2)
    counts = launch_counts()
    builds.append(fo.table_builds - builds0 - builds[0])
    steps = WARMUP_STEPS + TRAIN_STEPS
    loss_vals = [float(x) for x in losses]
    step_s = float(np.median(windows))
    tokens = BATCH * SEQ
    summary = {
        "model": "gpt2-medium", "layers": LAYERS, "batch": BATCH, "seq": SEQ,
        "vocab_pad_to": vocab_pad_to,
        "lm_head_columns": int(cm.params["lm_head"]["kernel"].shape[1]),
        "compute_dtype": "bfloat16",
        "optimizer": (f"{type(optimizer).__name__}({vars(optimizer)})"
                      if optimizer else f"Adam({LR})"),
        "params": sum(t.numel() for ws in cm.params.values()
                      for t in ws.values()), "steps": steps,
        "step_ms_median": 1e3 * step_s,
        "step_ms_windows": [1e3 * w for w in windows],
        "samples_per_s": BATCH / step_s, "tokens_per_s": tokens / step_s,
        "mfu": gc.flops_per_token() * tokens / step_s / BF16_FLOPS,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "losses": loss_vals, "launches": counts,
        "table_builds_warmup_timed": builds}
    log(f"[{tag}] step {summary['step_ms_median']:.1f} ms "
        f"(windows {', '.join(f'{w:.1f}' for w in summary['step_ms_windows'])})"
        f", {summary['samples_per_s']:.2f} samples/s, "
        f"{summary['tokens_per_s']:.0f} tokens/s, MFU "
        f"{100 * summary['mfu']:.2f}%, peak "
        f"{summary['max_memory_allocated_gib']:.1f} GiB")
    log(f"[{tag}] losses {' '.join(f'{x:.4f}' for x in loss_vals)}")
    log(f"[{tag}] launches over {steps} steps: {counts}; optimizer table "
        f"builds in the warm-up and timed steps: {builds}")
    if not all(np.isfinite(loss_vals)):
        fail(f"non-finite training loss: {loss_vals}")
    if not loss_vals[-1] < loss_vals[0]:
        fail(f"training loss did not fall: {loss_vals}")
    want = {name: exact.get(name, 0) * steps for name in counts}
    if counts != want:
        fail(f"{tag}: launches over {steps} steps {counts}, expected {want}")
    if builds != [1, 0]:
        fail(f"{tag}: the optimizer's pointer table was built {builds} "
             f"times in the warm-up and timed steps, expected [1, 0]")
    return summary, cm, inputs, label


def train_fit(cm, vocab: int, seed: int) -> dict:
    """One fit epoch over 4 batches with the loss read only at its end."""
    from flexflow_tpu_torch.kernels import fused_optim as fo

    ids, pos, labels = train_batch(seed + 2, vocab, n=4 * BATCH)
    torch.cuda.synchronize()
    zero_launch_counts()
    builds0 = fo.table_builds
    t0 = time.perf_counter()
    hist = cm.fit([ids, pos], labels, epochs=1, verbose=False, sync_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    out = {"history": hist, "step_stats": dict(cm.step_stats),
           "wall_s": wall, "launches": counts,
           "table_builds": fo.table_builds - builds0}
    log(f"[train fit] loss {hist[0]['loss']:.4f}, "
        f"{hist[0]['samples_per_sec']:.2f} samples/s, step_stats "
        f"{cm.step_stats}, launches {counts}, optimizer table builds "
        f"{out['table_builds']}")
    if not np.isfinite(hist[0]["loss"]) or cm.step_stats != {
            "dispatches": 4, "host_syncs": 0} or out["table_builds"] != 0:
        fail(f"fit epoch: {out}")
    if min(counts[n] for n in ("flash_attention_fwd", "flash_attention_dq",
                               "flash_attention_dkv", "fused_adam")) <= 0:
        fail(f"fit did not launch every training kernel: {counts}")
    return out


def train_accum_fit(seed: int) -> dict:
    """(g): GPT-2 medium at full depth with the vocab padded to 128 and
    SGD(0.01) without momentum: one fit epoch over 4 batches with
    accum_steps=2 and the loss read only at its end, the launch counters
    zeroed just before it: 2 updates, each of 2 microbatches."""
    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch.kernels import fused_optim as fo

    _, _, cm = gpt2_train_model(seed, LAYERS, "bfloat16",
                                SGDOptimizer(lr=SGD_LR), PAD_TO)
    ids, pos, labels = train_batch(seed + 3, GPT2_VOCAB, n=4 * BATCH)
    torch.cuda.synchronize()
    zero_launch_counts()
    builds0 = fo.table_builds
    t0 = time.perf_counter()
    hist = cm.fit([ids, pos], labels, epochs=1, verbose=False, sync_every=0,
                  accum_steps=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want = {name: 0 for name in counts}
    want.update({"flash_attention_fwd": 4 * LAYERS,
                 "flash_attention_dq": 4 * LAYERS,
                 "flash_attention_dkv": 4 * LAYERS,
                 "fused_ce_fwd": 4, "fused_ce_bwd": 4, "fused_sgd_plain": 2})
    out = {"history": hist, "step_stats": dict(cm.step_stats),
           "wall_s": wall, "launches": counts,
           "table_builds": fo.table_builds - builds0}
    log(f"[train accum fit] loss {hist[0]['loss']:.4f}, "
        f"{hist[0]['samples_per_sec']:.2f} samples/s, step_stats "
        f"{cm.step_stats}, launches {counts}, optimizer table builds "
        f"{out['table_builds']}")
    if not np.isfinite(hist[0]["loss"]) or cm.step_stats != {
            "dispatches": 2, "host_syncs": 0} or out["table_builds"] != 1:
        fail(f"accum_steps=2 fit epoch: {out}")
    if counts != want:
        fail(f"accum_steps=2 fit epoch: launches {counts}, expected {want}")
    return out


def profile_train(cm, inputs, label, tag: str) -> dict:
    """torch.profiler over two train steps of `cm` on one batch."""
    def step():
        (cm.params, cm.opt_state, cm.state, _, _) = cm.train_step(
            cm.params, cm.opt_state, cm.state, inputs, label)
    prof = _device_profile(step, 2, cm.device)
    if "wall_ms_per_call" in prof:
        log(f"[{tag}] step: {prof['wall_ms_per_call']:.2f} ms wall, device "
            f"busy {prof['device_busy_ms_per_call']:.2f} ms, idle share "
            f"{prof['device_idle_share']:.3f}, "
            f"{prof['kernel_launches_per_call']:.0f} kernel launches")
        for k in prof["top_kernels"]:
            log(f"[{tag}]   {k['ms_per_call']:8.3f} ms "
                f"{k['launches_per_call']:5.0f}x  {k['name']}")
        log(f"[{tag}] the port's kernels: " + ", ".join(
            f"{n} {k['ms_per_call']:.3f} ms in {k['launches_per_call']:.0f}"
            for n, k in prof["port_kernels"].items()))
    return prof


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
    kernels = ("flash_attention", "flash_attention_bwd", "dequant_attention",
               "fused_optim", "fused_ce")
    t0 = time.perf_counter()
    paths = build_all(kernels)
    log(f"built {len(paths)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    # ptxas -v: each entry function's name, then its spills and registers
    for name in kernels:
        for line in build_log(name).splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                log(f"  {name}: {line.strip()[:160]}")

    # ---- 2. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = Timer()
    rows = [check_flash(timer, gen), *check_flash_bwd(timer, gen),
            check_dequant(timer, gen, args.seed), check_adam(timer, gen)]
    torch.cuda.empty_cache()
    rows += [*check_fused_ce(timer, gen), *check_sgd(timer, gen)]
    torch.cuda.empty_cache()
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        if r["name"] in TC_DESIGN:
            log(f"{r['name']}: {r['tflops']:.1f} TFLOP/s, "
                f"{100 * r['bound_share']:.1f}% of its bound "
                f"({r['design']})")
        elif "design" in r:
            log(f"{r['name']}: {100 * r['bound_share']:.1f}% of its bound "
                f"({r['design']})")

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
                    f"{prof['kernel_launches_per_call']:.0f} kernel launches"
                    f", {prof['aten_index_per_call']:.0f} aten::index"
                    f", the port's kernels " + ", ".join(
                        f"{n} {k['ms_per_call']:.3f} ms"
                        for n, k in prof["port_kernels"].items()))
        runs.append(run)
        del engine
        torch.cuda.empty_cache()

    flash_runs = [r["launches"]["flash_attention_fwd"] for r in runs]
    deq_runs = [r["launches"]["dequant_decode_attention"] for r in runs]
    if min(flash_runs) <= 0:
        fail(f"flash kernel not launched on the serving path: {flash_runs}")
    if deq_runs[1] <= 0 or deq_runs[0] != 0:
        fail(f"dequant kernel launches per run (auto, int8): {deq_runs}")
    # the int8 decode step reads the pages through the table in the
    # kernel: no per-layer gather, on the host (aten::index; one a step is
    # left, the page ids of the cache writes) or among the top kernels
    step = runs[1]["profile"]["decode_step"]
    gathers = [k for k in step.get("top_kernels", [])
               if "gather" in k["name"] and k["launches_per_call"] >= LAYERS]
    if step.get("aten_index_per_call", 0) >= LAYERS or gathers:
        fail(f"int8 decode step gathers: {step.get('aten_index_per_call')} "
             f"aten::index a step, top kernels {gathers}")
    del params
    torch.cuda.empty_cache()

    # ---- 5. train GPT-2 medium
    flash = {"flash_attention_fwd": LAYERS, "flash_attention_dq": LAYERS,
             "flash_attention_dkv": LAYERS}
    train = {"grad_check": train_grad_check(args.seed)}
    train["full_depth"], cm, inputs, label = train_full(
        args.seed, None, 0, dict(flash, fused_adam=1), "train full depth")
    train["fit"] = train_fit(cm, gc.vocab, args.seed)
    train["profile"] = profile_train(cm, inputs, label, "train")
    del cm, inputs, label
    torch.cuda.empty_cache()

    # ---- 5e-5h. GPT-2 medium with the vocab padded to 128, under SGD
    from flexflow_tpu_torch import SGDOptimizer

    def momentum_sgd():
        return SGDOptimizer(lr=SGD_LR, momentum=0.9)
    tag = "train sgd padded"
    sgd = {"grad_check": train_grad_check(args.seed, momentum_sgd, PAD_TO,
                                          GRAD_TOL_SGD, tag)}
    sgd["full_depth"], cm, inputs, label = train_full(
        args.seed, momentum_sgd(), PAD_TO,
        dict(flash, fused_ce_fwd=1, fused_ce_bwd=1, fused_sgd=1),
        f"{tag} full depth")
    sgd["profile"] = profile_train(cm, inputs, label, tag)
    del cm, inputs, label
    torch.cuda.empty_cache()
    sgd["accum_fit"] = train_accum_fit(args.seed)

    # launches on the main paths: both serving runs, the 12 Adam training
    # steps and the Adam fit epoch, the 12 padded-vocab SGD steps and the
    # accum_steps=2 fit epoch, each counted from 0 just before it ran
    paths = {f"serve_{r['kv_cache_dtype']}": r["launches"] for r in runs}
    paths["train_steps"] = train["full_depth"]["launches"]
    paths["train_fit"] = train["fit"]["launches"]
    paths["train_sgd_padded_steps"] = sgd["full_depth"]["launches"]
    paths["train_accum_fit"] = sgd["accum_fit"]["launches"]
    for r in rows:
        r["launches"] = sum(c[r["name"]] for c in paths.values())
        r["launches_by_path"] = {p: c[r["name"]] for p, c in paths.items()}
        r["card"] = card
    log(json.dumps({"serve": runs}))
    log(json.dumps({"train": train}))
    log(json.dumps({"train_sgd_padded": sgd}))
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
