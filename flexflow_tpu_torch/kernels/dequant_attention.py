"""Fused int8 dequantize + decode attention: a hand-written CUDA kernel that
reads the paged KV cache through its page table, and its plain versions.

Replaces the Pallas TPU kernel `flexflow_tpu/kernels/dequant_attention.py`
`dequant_decode_attention` -> `_kernel`. The quantized paged KV cache
stores int8 values with per-(page entry, head) f32 scales; the kernel
widens the int8 context and its scales in registers and runs the masked
softmax attention in f32, so no f32 copy of the context reaches device
memory. The CUDA source is `csrc/dequant_attention.cu`.

Two entry points run the one kernel:

- `paged_dequant_decode_attention` takes the pools as the cache holds them
  (`[pages, page, h, d]` int8, `[pages, page, h]` f32 scales) and the page
  table `[slots, pages_per_slot]`; key j of slot b is at page
  `table[b, j // page]`, offset `j % page`. This is what the serving
  lowering calls: nothing is gathered first.
- `dequant_decode_attention` takes each slot's context gathered into one
  contiguous copy, with the JAX package's layout and semantics. It is the
  paged call with each slot's context as one page (page = L, table
  `arange(slots)[:, None]`).

What bounds it on an H100: reading, once, the int8 keys and values each
slot's queries may see (positions up to pos + s - 1; the kernel reads no
page id or key past that) and their scales. At GPT-2 medium's decode shape
(8 slots x 16 heads, up to 1056 cached positions, head_dim 64) that is at
most ~18 MB per layer step against ~0.1 GFLOP, so the bound is the 3.35
TB/s of device memory. The context is split over blocks of CHUNK keys
(split-K); the last block of each (slot, head) to finish merges the
chunks' partial softmax sums, so one launch does the whole call.

The gate is Hopper's: 1..8 query rows, head_dim 64 or 128, f32 or bf16
queries, a context of at most 65535 chunks (8.4 M keys); shared memory
does not grow with the context. The wrappers run the plain versions only
for tensors on the CPU; for CUDA tensors they launch the kernel or raise.
`launches` counts kernel launches, and `launches_by_rows` the same by
query rows (1 in a decode step, K+1 in a speculative verify pass).
"""

from __future__ import annotations

import ctypes
import math

import torch

from flexflow_tpu_torch.kernels._build import load_library

MAX_QUERY_ROWS = 8
CHUNK = 128  # keys a block takes: 4 warps x 32 keys (csrc CHUNK)
MAX_CHUNKS = 65535  # the chunks run along the grid's y
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
launches_by_rows: dict = {}   # query rows -> launches
# per (device, stream, slots x heads, chunks, rows, head_dim): the f32
# workspace of the chunks' partials and the merge counters, which every
# launch leaves at 0; launches on one stream run in order, so they share
_buffers: dict = {}


def dequant_supported(s: int, L: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the CUDA kernel covers s query rows of head_dim d in `dtype`
    against a context of L keys."""
    return (1 <= s <= MAX_QUERY_ROWS and d in (64, 128)
            and 0 < L <= MAX_CHUNKS * CHUNK and dtype in _DTYPE_CODE)


def _plain(qh, kq, ks, vq, vs, pos, scale: float):
    """The gathered function in plain PyTorch, all math in f32."""
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


def _paged_plain(qh, k_pool, k_scale, v_pool, v_scale, page_table, pos,
                 scale: float):
    """The paged function in plain PyTorch: gather each slot's pages, as the
    JAX lowering does (`pool[table]`), then the gathered function."""
    b, _, h, d = qh.shape
    pt = page_table.long()
    return _plain(qh, k_pool[pt].reshape(b, -1, h, d),
                  k_scale[pt].reshape(b, -1, h),
                  v_pool[pt].reshape(b, -1, h, d),
                  v_scale[pt].reshape(b, -1, h), pos, scale)


def _kernel_fn():
    fn = load_library("dequant_attention").ff_paged_dequant_decode
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _workspace(dev, stream: int, bh: int, nchunks: int, s: int, d: int):
    key = (dev, stream, bh, nchunks, s, d)
    bufs = _buffers.get(key)
    if bufs is None:
        bufs = _buffers[key] = (
            torch.empty(bh * nchunks * s * (d + 2), dtype=torch.float32,
                        device=dev),
            torch.zeros(bh, dtype=torch.int32, device=dev))
    return bufs


def _cuda(qh, k_pool, k_scale, v_pool, v_scale, page_table, pos,
          scale: float):
    global launches
    b, s, h, d = qh.shape
    page = k_pool.shape[1]
    pages_per_slot = page_table.shape[1]
    qh = qh.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    for t in (k_pool, k_scale, v_pool, v_scale):
        if not t.is_contiguous():
            raise ValueError("dequant kernel needs contiguous pools")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("dequant kernel needs 16-byte aligned int8 pools")
    stream = torch.cuda.current_stream(qh.device).cuda_stream
    nchunks = -(-(pages_per_slot * page) // CHUNK)
    ws, tickets = _workspace(qh.device, stream, b * h, nchunks, s, d)
    out = torch.empty_like(qh)
    err = _kernel_fn()(
        qh.data_ptr(), k_pool.data_ptr(), k_scale.data_ptr(),
        v_pool.data_ptr(), v_scale.data_ptr(), pt.data_ptr(), pos.data_ptr(),
        out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
        _DTYPE_CODE[qh.dtype], b, s, h, d, page, pages_per_slot, CHUNK,
        float(scale), stream)
    if err != 0:
        raise RuntimeError(f"dequant_attention kernel launch failed: CUDA error {err}")
    launches += 1
    launches_by_rows[s] = launches_by_rows.get(s, 0) + 1
    return out


def _check(qh, k_pool, k_scale, v_pool, v_scale, page_table, pos):
    """Ranks, dtypes and shapes every caller must agree on; returns L."""
    if qh.ndim != 4 or k_pool.ndim != 4 or k_scale.ndim != 3:
        raise ValueError(f"bad ranks q={tuple(qh.shape)} k={tuple(k_pool.shape)} "
                         f"k_scale={tuple(k_scale.shape)}")
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise ValueError(f"context must be int8, got {k_pool.dtype}/{v_pool.dtype}")
    b, _, h, d = qh.shape
    pages, page = k_pool.shape[:2]
    if not (k_pool.shape == v_pool.shape == (pages, page, h, d)
            and k_scale.shape == v_scale.shape == (pages, page, h)
            and pos.shape == (b,)):
        raise ValueError(f"dequant attention: inconsistent shapes q {tuple(qh.shape)}"
                         f" k {tuple(k_pool.shape)} v {tuple(v_pool.shape)} k_scale "
                         f"{tuple(k_scale.shape)} v_scale {tuple(v_scale.shape)} "
                         f"pos {tuple(pos.shape)}")
    if (page_table.ndim != 2 or page_table.shape[0] != b
            or page_table.shape[1] < 1 or page_table.is_floating_point()):
        raise ValueError(f"page table {tuple(page_table.shape)} "
                         f"{page_table.dtype} does not match {b} slots")
    return page_table.shape[1] * page


def paged_dequant_decode_attention(qh, k_pool, k_scale, v_pool, v_scale,
                                   page_table, pos, scale: float | None = None):
    """qh (b, s, h, d) queries; k_pool/v_pool (pages, page, h, d) int8;
    k_scale/v_scale (pages, page, h) f32; page_table (b, pages_per_slot)
    integer page ids (int32 on the card; every id below `pages`); pos (b,)
    int32 cached extent per slot (>= 0). Query row i attends keys
    0..pos + i. Returns (b, s, h, d) in qh's dtype."""
    L = _check(qh, k_pool, k_scale, v_pool, v_scale, page_table, pos)
    b, s, h, d = qh.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dev = qh.device.type
    if dev == "cpu":
        return _paged_plain(qh, k_pool, k_scale, v_pool, v_scale, page_table,
                            pos, float(scale))
    if dev != "cuda":
        raise ValueError(f"dequant attention runs on cuda or cpu, not {dev}")
    if not dequant_supported(s, L, d, qh.dtype):
        raise ValueError(f"dequant kernel does not cover q {tuple(qh.shape)} "
                         f"{qh.dtype} against a context of {L}; "
                         "enable_fusion=False runs the plain attention")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError("dequant kernel needs f32 scales")
    if not all(t.device == qh.device
               for t in (k_pool, k_scale, v_pool, v_scale, page_table, pos)):
        raise ValueError("dequant kernel needs every operand on one device")
    return _cuda(qh, k_pool, k_scale, v_pool, v_scale, page_table, pos,
                 float(scale))


def dequant_decode_attention(qh, kq, ks, vq, vs, pos, scale: float | None = None):
    """qh (b, s, h, d) queries; kq/vq (b, L, h, d) int8 gathered context;
    ks/vs (b, L, h) f32 scales; pos (b,) int32 cached extent per slot.
    Returns (b, s, h, d) in qh's dtype."""
    if qh.ndim != 4 or kq.ndim != 4 or kq.shape[0] != qh.shape[0]:
        raise ValueError(f"context {tuple(kq.shape)} does not match q "
                         f"{tuple(qh.shape)}")
    # each slot's context is one page of the pool kq: slot b is page b
    table = torch.arange(qh.shape[0], dtype=torch.int32,
                         device=qh.device)[:, None]
    if qh.device.type == "cpu":
        _check(qh, kq, ks, vq, vs, table, pos)
        return _plain(qh, kq, ks, vq, vs, pos,
                      1.0 / math.sqrt(qh.shape[-1]) if scale is None
                      else float(scale))
    return paged_dequant_decode_attention(qh, kq, ks, vq, vs, table, pos,
                                          scale)
