"""Fused sparse cross-entropy: hand-written CUDA kernels, their plain
versions, the gate and the autograd Function that joins them
(counterpart: flexflow_tpu/kernels/fused_ce.py).

Replaces the two Pallas TPU kernels `_forward` -> `_fwd_kernel` (online
logsumexp over the vocab: per-row loss = lse - x[y] and lse, f32) and
`_backward` -> `_bwd_kernel` (dX = g/N (softmax - onehot), in the logits'
dtype), so the step never holds an f32 copy of the [B, S, vocab] logits:
the Function saves the logits in their own dtype and the per-row lse, and
the mean over rows is one PyTorch reduction, as `jnp.mean` is XLA's in
JAX. The CUDA source is `csrc/fused_ce.cu`; its header says how it is laid
out.

What bounds them on an H100: bytes. At GPT-2 medium's padded shape
(8192, 50304) bf16 the forward reads 824 MB (0.246 ms at 3.35 TB/s) and
the backward reads and writes 1.65 GB (0.492 ms).

The gate is the JAX one, copied: rows % 8 == 0, vocab % 128 == 0, f32 or
bf16, so both packages pick the same loss path for every shape. At
GPT-2's vocab of 50257 it refuses (as in JAX) and the loss goes through
`losses.compute_loss`; `GPT2Config(vocab_pad_to=128)` gives 50304 columns,
which it admits. The padded columns take part in the softmax, as in JAX.
The wrappers run the plain versions only for tensors on the CPU; for CUDA
tensors they launch the kernels or raise. `launches_fwd` and
`launches_bwd` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from flexflow_tpu_torch.kernels._build import load_library
from flexflow_tpu_torch.losses import LossType

_ROW_BLOCKS = (256, 128, 64, 32, 16, 8)
_VOCAB_BLOCKS = (2048, 1024, 512, 256, 128)
_VMEM_TILE_BYTES = 512 * 1024
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches_fwd = 0   # forward kernel (#5 `_fwd_kernel`)
launches_bwd = 0   # backward kernel (#6 `_bwd_kernel`)


def _pick_blocks(n: int, v: int, itemsize: int):
    """Largest (row, vocab) blocks dividing (n, v) under the tile budget,
    or None when no pairing qualifies."""
    bn = next((b for b in _ROW_BLOCKS if n % b == 0), None)
    if bn is None:
        return None
    bv = next((b for b in _VOCAB_BLOCKS
               if v % b == 0 and bn * b * itemsize <= _VMEM_TILE_BYTES), None)
    if bv is None:
        return None
    return bn, bv


def fused_ce_supported(shape, dtype) -> bool:
    """Whether the fused kernels cover logits of this shape/dtype."""
    if dtype not in _ITEMSIZE or len(shape) < 2:
        return False
    v = int(shape[-1])
    n = 1
    for s in shape[:-1]:
        n *= int(s)
    return n > 0 and v > 0 and _pick_blocks(n, v, _ITEMSIZE[dtype]) is not None


def use_fused_ce(loss_type, logits, mode: str,
                 enable_fusion: bool = True) -> bool:
    """The compile-time gate: cfg.fused_loss x loss type x shape precheck."""
    if mode == "off":
        return False
    if LossType.from_any(loss_type) is not \
            LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
        if mode == "on":
            raise ValueError(
                f"--fused-loss=on requires sparse_categorical_crossentropy "
                f"(got {loss_type})")
        return False
    ok = fused_ce_supported(tuple(logits.shape), logits.dtype)
    if mode == "on":
        if not ok:
            raise ValueError(
                f"--fused-loss=on but logits {tuple(logits.shape)} "
                f"{logits.dtype} don't qualify (need rows % 8 == 0, "
                f"vocab % 128 == 0, f32/bf16)")
        return True
    return ok and enable_fusion


# --------------------------------------------------------------- forward
def _picked(xf, y2):
    """x[row, y] in f32, 0 where the label is outside [0, v) (no column
    matches it, as in JAX's `where(col == y, x, 0)`)."""
    v = xf.shape[-1]
    y = y2.long()
    ok = (y >= 0) & (y < v)
    got = xf.gather(-1, y.clamp(0, v - 1)[:, None]).squeeze(-1)
    return torch.where(ok, got, torch.zeros_like(got))


def _fwd_plain(x2, y2):
    """x2: (n, v) logits, y2: (n,) int labels -> (per-row loss (n,) f32,
    lse (n,) f32), in plain PyTorch: m = max, l = sum exp(x - m),
    lse = m + log(l), loss = lse - x[y]."""
    xf = x2.float()
    m = xf.amax(dim=-1)
    lse = m + torch.log(torch.exp(xf - m[:, None]).sum(dim=-1))
    return lse - _picked(xf, y2), lse


def _fwd_fn():
    fn = load_library("fused_ce").ff_ce_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
    return fn


def _aligned(*ts) -> bool:
    """Whether every tensor's start and row starts are 16-byte aligned
    (the kernels' vector loads)."""
    return all(t.data_ptr() % 16 == 0 and (t.stride(0) * t.element_size()) % 16 == 0
               for t in ts)


def _check_cuda(x2, y2):
    n, v = x2.shape
    if not fused_ce_supported((n, v), x2.dtype):
        raise ValueError(f"fused cross-entropy kernels do not cover logits "
                         f"{tuple(x2.shape)} {x2.dtype} (need rows % 8 == 0, "
                         f"vocab % 128 == 0, f32/bf16); fused_loss='off' runs "
                         "the unfused loss")
    if x2.stride(-1) != 1:
        raise ValueError("fused cross-entropy kernels need the vocab dim "
                         "contiguous")
    if not (y2.shape == (n,) and y2.dtype == torch.int32 and y2.is_contiguous()
            and y2.device == x2.device):
        raise ValueError(f"fused cross-entropy kernels need ({n},) contiguous "
                         f"int32 labels on {x2.device}; got {tuple(y2.shape)} "
                         f"{y2.dtype} on {y2.device}")


def _fwd_cuda(x2, y2):
    global launches_fwd
    _check_cuda(x2, y2)
    n, v = x2.shape
    loss = torch.empty((n,), dtype=torch.float32, device=x2.device)
    lse = torch.empty((n,), dtype=torch.float32, device=x2.device)
    err = _fwd_fn()(x2.data_ptr(), y2.data_ptr(), loss.data_ptr(),
                    lse.data_ptr(), n, v, x2.stride(0), _DTYPE_CODE[x2.dtype],
                    int(_aligned(x2)),
                    torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused cross-entropy forward kernel launch "
                           f"failed: CUDA error {err}")
    launches_fwd += 1
    return loss, lse


# -------------------------------------------------------------- backward
def _bwd_plain(x2, y2, lse, gscale):
    """dx = gscale (exp(x - lse) - [col == y]) in f32, rounded once to
    x2's dtype (`gscale` is g / n, a 0-dim f32 tensor)."""
    p = torch.exp(x2.float() - lse[:, None])
    col = torch.arange(x2.shape[-1], device=x2.device)
    hit = col[None, :] == y2.long()[:, None]
    return (gscale * torch.where(hit, p - 1.0, p)).to(x2.dtype)


def _bwd_fn():
    fn = load_library("fused_ce").ff_ce_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
    return fn


def _bwd_cuda(x2, y2, lse, g):
    """dx from the cotangent `g` of the mean loss: the kernel reads g on
    the device and divides it by n there (no host sync)."""
    global launches_bwd
    _check_cuda(x2, y2)
    n, v = x2.shape
    if not (lse.shape == (n,) and lse.dtype == torch.float32
            and lse.is_contiguous() and g.numel() == 1
            and g.dtype == torch.float32 and g.device == x2.device):
        raise ValueError(f"fused cross-entropy backward needs ({n},) f32 lse "
                         f"and one f32 cotangent on {x2.device}")
    dx = torch.empty((n, v), dtype=x2.dtype, device=x2.device)
    err = _bwd_fn()(x2.data_ptr(), y2.data_ptr(), lse.data_ptr(),
                    g.data_ptr(), dx.data_ptr(), n, v, x2.stride(0),
                    dx.stride(0), _DTYPE_CODE[x2.dtype], int(_aligned(x2, dx)),
                    torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused cross-entropy backward kernel launch "
                           f"failed: CUDA error {err}")
    launches_bwd += 1
    return dx


class FusedCrossEntropy(torch.autograd.Function):
    """Mean sparse cross-entropy of (n, v) logits: forward saves the
    logits in their own dtype, the labels and the per-row lse (never an
    f32 copy or the softmax); backward is `_bwd_kernel`'s dX."""

    @staticmethod
    def forward(ctx, x2, y2):
        if x2.device.type == "cpu":
            loss, lse = _fwd_plain(x2, y2)
        else:
            loss, lse = _fwd_cuda(x2, y2)
        ctx.save_for_backward(x2, y2, lse)
        return loss.mean()

    @staticmethod
    def backward(ctx, g):
        x2, y2, lse = ctx.saved_tensors
        g = g.float()
        if x2.device.type == "cpu":
            dx = _bwd_plain(x2, y2, lse, g / x2.shape[0])
        else:
            dx = _bwd_cuda(x2, y2, lse, g)
        return dx, None


# ------------------------------------------------------------ public API
def fused_cross_entropy(logits, labels) -> torch.Tensor:
    """Mean sparse cross-entropy over all leading dims of `logits`
    ([..., vocab], f32 or bf16, kept in their dtype) against integer
    `labels`; differentiable through the backward kernel."""
    if not fused_ce_supported(tuple(logits.shape), logits.dtype):
        raise ValueError(f"fused_cross_entropy: unsupported logits "
                         f"{tuple(logits.shape)} {logits.dtype}")
    dev = logits.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"fused cross-entropy runs on cuda or cpu, not {dev}")
    v = logits.shape[-1]
    x2 = logits.reshape(-1, v)
    # labels arrive int32 from the loader; any other integer type is
    # converted where it lies (on the device for CUDA tensors)
    y2 = labels.reshape(-1).to(device=logits.device, dtype=torch.int32)
    return FusedCrossEntropy.apply(x2, y2.contiguous())
