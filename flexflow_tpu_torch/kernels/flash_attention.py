"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel `flexflow_tpu/kernels/flash_attention.py`
`_fwd` -> `_fwd_kernel`: blocked online-softmax attention, causal or not,
returning O and the per-row logsumexp. The CUDA source is
`csrc/flash_attention.cu`; its header says how it is laid out.

What bounds it on an H100: at the prefill shapes of GPT-2 medium
(8 x 16 heads x 1024 x 64, bf16, causal) the function moves ~68 MB of
q/k/v/o/lse and does ~17 GFLOP, so the card's bound is about even between
its memory (20 us at 3.35 TB/s) and its bf16 tensor cores (17 us at 989
TFLOP/s). This first kernel does its products as scalar f32 FMAs fed from
shared memory and is bound by those instead; `wgmma` and TMA are later
work.

The gate is Hopper's: head_dim 64 or 128, f32 or bf16, the block's
shared-memory tiles within the 227 KB a block may use, and sq == sk when
causal (as the TPU kernel requires). The wrapper runs the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from flexflow_tpu_torch.kernels._build import load_library

# tile rows of q and of k/v per block (csrc/flash_attention.cu BQ/BK)
BLOCK_Q = 64
BLOCK_K = 64
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block (mirrors smem_floats<D>)."""
    return 4 * (BLOCK_Q * (d + 1) + BLOCK_K * (d + 1) + BLOCK_K * d
                + BLOCK_Q * (BLOCK_K + 1))


def flash_supported(sq: int, sk: int, d: int, dtype: torch.dtype,
                    causal: bool = False, batch_heads: int = 1) -> bool:
    """Whether the CUDA kernel covers this shape (the Hopper counterpart of
    the TPU package's VMEM gate)."""
    return (d in (64, 128) and dtype in _DTYPE_CODE
            and (not causal or sq == sk) and sq > 0 and sk > 0
            and 0 < batch_heads <= 65535
            and smem_bytes(d) <= SMEM_LIMIT)


def _fwd_plain(q, k, v, causal: bool, scale: float):
    """The same function in plain PyTorch: f32 scores and softmax, P
    rounded to v's dtype before PV, O in q's dtype, lse (b, h, sq, 1)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), m + torch.log(l)


def _kernel_fn():
    fn = load_library("flash_attention").ff_flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _fwd_cuda(q, k, v, causal: bool, scale: float):
    global launches
    b, h, sq, d = q.shape
    sk = k.shape[2]
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("flash kernel needs the head dim contiguous")
    # O in the layout of q, so the (b, s, h, d) entry gets (b, s, h, d) back
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    fn = _kernel_fn()
    strides = []
    for t in (q, k, v, o):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), _DTYPE_CODE[q.dtype], b, h, sq, sk, d, *strides,
             float(scale), int(bool(causal)),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return o, lse


def _fwd(q, k, v, causal: bool, scale: float):
    """q: (b, h, sq, d); k/v: (b, h, sk, d) -> (o, lse (b, h, sq, 1) f32).
    CPU tensors take the plain version; CUDA tensors the kernel."""
    dev = q.device.type
    if dev == "cpu":
        return _fwd_plain(q, k, v, causal, scale)
    if dev != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {dev}")
    b, h, sq, d = q.shape
    if not (k.dtype == v.dtype == q.dtype and k.device == v.device == q.device
            and k.shape == v.shape and k.shape[:2] == (b, h)
            and k.shape[3] == d
            and flash_supported(sq, k.shape[2], d, q.dtype, causal, b * h)):
        raise ValueError(f"flash kernel does not cover q {tuple(q.shape)} "
                         f"{q.dtype}, k {tuple(k.shape)} (causal={causal}); "
                         "enable_fusion=False runs the plain attention")
    return _fwd_cuda(q, k, v, causal, scale)


def flash_attention(q, k, v, causal: bool = False, scale: float | None = None):
    """q: (b, h, sq, d), k/v: (b, h, sk, d) -> (b, h, sq, d)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected rank-4 q/k/v, got {q.shape}/{k.shape}/{v.shape}")
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("causal flash attention requires sq == sk "
                         f"(got {q.shape[2]} vs {k.shape[2]})")
    if k.shape[2] != v.shape[2]:
        raise ValueError(f"k/v length mismatch {k.shape} vs {v.shape}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _fwd(q, k, v, causal, float(scale))[0]


def flash_attention_qkv(q, k, v, causal: bool = False, scale: float | None = None):
    """Head-minor layout entry used by ops/attention_ops: q/k/v (b, s, h, d),
    returns (b, sq, h, d)."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, scale=scale)
    return out.transpose(1, 2)
