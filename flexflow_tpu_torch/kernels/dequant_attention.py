"""Fused int8 dequantize + decode attention: a hand-written CUDA kernel and
its plain version.

Replaces the Pallas TPU kernel `flexflow_tpu/kernels/dequant_attention.py`
`dequant_decode_attention` -> `_kernel`. The quantized paged KV cache
stores int8 values with per-(page entry, head) f32 scales; the kernel
widens the gathered int8 context and its scales in registers and runs the
masked softmax attention in f32, so the f32 copy of the context never
reaches device memory. The CUDA source is `csrc/dequant_attention.cu`.

What bounds it on an H100: reading, once, the int8 keys and values each
slot's queries may see (positions up to pos + s - 1; the kernel reads no
further). At GPT-2 medium's decode shapes (8 slots x 16 heads, up to 1056
cached positions, head_dim 64) that is at most ~18 MB of values and
scales per layer step against ~0.1 GFLOP, so the bound is the 3.35 TB/s
of device memory. One block per (slot, head) reads its context alone, so
the slot with the longest context sets the time; a split-K layout and
reading the page table directly come later.

The gate is Hopper's: 1..8 query rows, head_dim 64 or 128, f32 or bf16
queries, and the score rows within the 227 KB of shared memory a block may
use. The wrapper runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. `launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from flexflow_tpu_torch.kernels._build import load_library

THREADS = 256
MAX_QUERY_ROWS = 8
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def smem_bytes(s: int, L: int, d: int) -> int:
    """Dynamic shared memory of one block (mirrors smem_floats)."""
    return 4 * (s * d + s * L + (THREADS // d) * s * d + MAX_QUERY_ROWS)


def dequant_supported(s: int, L: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the CUDA kernel covers this shape."""
    return (1 <= s <= MAX_QUERY_ROWS and d in (64, 128) and L > 0
            and dtype in _DTYPE_CODE and smem_bytes(s, L, d) <= SMEM_LIMIT)


def _plain(qh, kq, ks, vq, vs, pos, scale: float):
    """The same function in plain PyTorch, all math in f32."""
    s = qh.shape[1]
    L = kq.shape[1]
    k = kq.float() * ks[..., None]
    v = vq.float() * vs[..., None]
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), k) * scale
    row = torch.arange(s, device=qh.device)[:, None]
    col = torch.arange(L, device=qh.device)[None, :]
    keep = col[None] <= (pos.long()[:, None, None] + row[None])  # (b, s, L)
    logits = logits.masked_fill(~keep[:, None], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v) / p.sum(dim=-1, keepdim=True)
    return o.transpose(1, 2).to(qh.dtype)


def _kernel_fn():
    fn = load_library("dequant_attention").ff_dequant_decode
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _cuda(qh, kq, ks, vq, vs, pos, scale: float):
    global launches
    b, s, h, d = qh.shape
    L = kq.shape[1]
    qh = qh.contiguous()
    pos = pos.to(torch.int32).contiguous()
    for t in (kq, ks, vq, vs):
        if not t.is_contiguous():
            raise ValueError("dequant kernel needs a contiguous context")
    if kq.data_ptr() % 16 or vq.data_ptr() % 16:
        raise ValueError("dequant kernel needs a 16-byte aligned int8 context")
    out = torch.empty_like(qh)
    err = _kernel_fn()(qh.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
             vs.data_ptr(), pos.data_ptr(), out.data_ptr(),
             _DTYPE_CODE[qh.dtype], b, s, h, L, d, float(scale),
             torch.cuda.current_stream(qh.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dequant_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def dequant_decode_attention(qh, kq, ks, vq, vs, pos, scale: float | None = None):
    """qh (b, s, h, d) queries; kq/vq (b, L, h, d) int8 gathered context;
    ks/vs (b, L, h) f32 scales; pos (b,) int32 cached extent per slot.
    Returns (b, s, h, d) in qh's dtype."""
    if qh.ndim != 4 or kq.ndim != 4 or ks.ndim != 3:
        raise ValueError(f"bad ranks q={qh.shape} kq={kq.shape} ks={ks.shape}")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8:
        raise ValueError(f"context must be int8, got {kq.dtype}/{vq.dtype}")
    b, s, h, d = qh.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dev = qh.device.type
    if dev == "cpu":
        return _plain(qh, kq, ks, vq, vs, pos, float(scale))
    if dev != "cuda":
        raise ValueError(f"dequant attention runs on cuda or cpu, not {dev}")
    if not dequant_supported(s, kq.shape[1], d, qh.dtype):
        raise ValueError(f"dequant kernel does not cover q {tuple(qh.shape)} "
                         f"{qh.dtype} against context {tuple(kq.shape)}; "
                         "enable_fusion=False runs the plain attention")
    L = kq.shape[1]
    if not (kq.shape == vq.shape == (b, L, h, d)
            and ks.shape == vs.shape == (b, L, h) and pos.shape == (b,)):
        raise ValueError(f"dequant kernel: inconsistent shapes q {tuple(qh.shape)}"
                         f" kq {tuple(kq.shape)} vq {tuple(vq.shape)} ks "
                         f"{tuple(ks.shape)} vs {tuple(vs.shape)} pos {tuple(pos.shape)}")
    if ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise ValueError("dequant kernel needs f32 scales")
    if not all(t.device == qh.device for t in (kq, ks, vq, vs, pos)):
        raise ValueError("dequant kernel needs every operand on one device")
    return _cuda(qh, kq, ks, vq, vs, pos, float(scale))
