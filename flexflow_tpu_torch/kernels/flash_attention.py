"""Flash attention: hand-written CUDA kernels for the forward and the
backward, their plain versions, and the autograd Function that joins them.

Replaces the Pallas TPU kernels of `flexflow_tpu/kernels/flash_attention.py`:
`_fwd` -> `_fwd_kernel` (blocked online-softmax attention, causal or not,
returning O and the per-row logsumexp), and `_bwd` -> `_dq_kernel` and
`_dkv_kernel` (dQ, and dK/dV, from the saved lse). The CUDA sources are
`csrc/flash_attention.cu` (forward) and `csrc/flash_attention_bwd.cu`
(backward); their headers say how they are laid out.

What bounds them on an H100: at GPT-2 medium's shapes (8 x 16 heads x
1024 x 64, bf16, causal) the forward moves ~68 MB and does ~17 GFLOP, so
the card's bound is about even between its memory (20 us at 3.35 TB/s) and
its bf16 tensor cores (17 us at 989 TFLOP/s); the backward's dQ does 3
such causal products and dK/dV 4.

Routes by dtype: in bfloat16 all three kernels run on the tensor cores
(mma.sync m16n8k16 from bf16 tiles that cp.async double-buffers: K and V
for the forward and dQ, Q and dO for dK/dV); they want 16-byte aligned
rows, which `_check_rows_aligned` holds the tensors to, and raise
otherwise. dQ and dK/dV recompute P by `expf`, the forward by `__expf`.
In float32 the kernels do scalar f32 FMAs from shared memory: tensor cores
give no float32 products at the 1e-4 the f32 checks hold them to.

The gate is Hopper's: head_dim 64 or 128, f32 or bf16, every kernel's
shared-memory tiles within the 227 KB a block may use, and sq == sk when
causal (as the TPU kernel requires). The wrappers run the plain versions
only for tensors on the CPU; for CUDA tensors they launch the kernels or
raise. `launches`, `launches_dq` and `launches_dkv` count kernel launches.
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
TC_PAD = 8  # bf16 elements padding each tensor-core tile row (tc::PAD)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0       # forward kernel
launches_dq = 0    # backward dQ kernel
launches_dkv = 0   # backward dK/dV kernel


def tc_fwd_q_rows(d: int) -> int:
    """q rows a bf16 forward block owns: 4 warps of two 16-row m-tiles at
    head_dim 64, of one at 128 (tc_q_rows<D>)."""
    return 128 if d == 64 else 64


def fwd_smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a forward block: bf16, the q tile and two
    buffers each of k and v as bf16 rows padded by 8 elements
    (tc_smem_bytes<D>); f32, q, k, v and the P tile as f32
    (smem_floats<D>)."""
    if dtype == torch.bfloat16:
        return (tc_fwd_q_rows(d) + 4 * BLOCK_K) * (d + TC_PAD) * 2
    return 4 * (BLOCK_Q * (d + 1) + BLOCK_K * (d + 1) + BLOCK_K * d
                + BLOCK_Q * (BLOCK_K + 1))


def dq_smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a dQ block: bf16, q and dO and two buffers
    each of k and v as padded bf16 rows (dq_tc_smem_bytes<D>); f32, the
    scalar kernel's f32 tiles (dq_smem_floats<D>)."""
    if dtype == torch.bfloat16:
        return (2 * BLOCK_Q + 4 * BLOCK_K) * (d + TC_PAD) * 2
    return 4 * (4 * 64 * (d + 1) + BLOCK_Q * (BLOCK_K + 1))


def dkv_smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a dK/dV block: bf16, k and v and two
    buffers each of q and dO as padded bf16 rows, plus two of lse and
    delta (dkv_tc_smem_bytes<D>); f32, the scalar kernel's f32 tiles
    (dkv_smem_floats<D>)."""
    if dtype == torch.bfloat16:
        return (2 * BLOCK_K + 4 * BLOCK_Q) * (d + TC_PAD) * 2 + 4 * BLOCK_Q * 4
    return 4 * (4 * 64 * (d + 1) + 2 * BLOCK_K * (BLOCK_Q + 1) + 2 * BLOCK_Q)


def smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the largest of the three kernels' blocks
    for this dtype."""
    return max(fwd_smem_bytes(d, dtype), dq_smem_bytes(d, dtype),
               dkv_smem_bytes(d, dtype))


def flash_supported(sq: int, sk: int, d: int, dtype: torch.dtype,
                    causal: bool = False, batch_heads: int = 1) -> bool:
    """Whether the CUDA kernels cover this shape, forward and backward (the
    Hopper counterpart of the TPU package's VMEM gate)."""
    return (d in (64, 128) and dtype in _DTYPE_CODE
            and (not causal or sq == sk) and sq > 0 and sk > 0
            and 0 < batch_heads <= 65535
            and smem_bytes(d, dtype) <= SMEM_LIMIT)


def _check_rows_aligned(*ts) -> None:
    """The tensor-core kernels copy and store rows in 16-byte pieces: each
    bf16 tensor must start on 16 bytes and step its batch, head and seq
    dims in multiples of 8 elements. Raises ValueError otherwise (there is
    no other route for such a tensor)."""
    for t in ts:
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(
                "flash kernel (bf16, tensor cores) needs 16-byte aligned "
                f"rows: got data_ptr % 16 = {t.data_ptr() % 16}, strides "
                f"{tuple(t.stride())} for shape {tuple(t.shape)}")


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
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q, k, v)
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


# -------------------------------------------------------------- backward
def _bwd_terms(q, k, v, do, lse, delta, causal: bool, scale: float):
    """P recomputed from the saved lse (causal mask applied to P, f32) and
    dS = P (dP - delta) scale rounded to k's dtype, as `_bwd` makes them."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse)
    if causal:
        sq, sk = p.shape[-2], p.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=p.device).tril()
        p = p.masked_fill(~keep, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta) * scale).to(k.dtype)
    return p, ds


def _dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dQ = dS.K in plain PyTorch (the `_dq_kernel` function)."""
    _, ds = _bwd_terms(q, k, v, do, lse, delta, causal, scale)
    return torch.einsum("bhqk,bhkd->bhqd", ds.float(), k.float()).to(q.dtype)


def _dq_bf16_bound(q, k, v, do, lse, delta, causal: bool, scale: float):
    """The largest |dQ - plain dQ| allowed, element by element, on the
    bf16 route: what the card's checks hold the tensor-core kernel to.
    Both make dS_ij = P_ij (dP_ij - delta_i) scale in f32 from the same
    lse and delta and round it to bf16 before dQ_ic = sum_j dS_ij K_jc, but
    sum S, dP and dQ in other orders and take exp by another routine.
    Allowed, the sum of:
    - dS's f32 difference e_ij, carried as sum_j e_ij |K_jc|: S and dP are
      sums of d exact products, d 2**-22 sum |products| apart (one
      truncating ulp an add on each side); P is 2**-21 (2 + |S_ij scale| +
      |lse_i|) apart besides (exp and the scaled exponent); dS's own
      products 2**-21 |dS_ij|;
    - dS's bf16 rounding: where the two f32 values straddle a rounding
      boundary the bf16 values differ by one ulp, at most 2**-7 |dS_ij|;
      modelled as two independent roundings (their difference's standard
      deviation at most 2**-7 / sqrt(6) |dS_ij|): ten standard deviations
      of the sum, 10 * 2**-7 / sqrt(6) * sqrt(sum_j (dS_ij K_jc)**2),
      capped at its worst case 2**-7 sum_j |dS_ij K_jc|;
    - the f32 sums over n keys, n 2**-22 sum_j |dS_ij K_jc|;
    - 2 bf16 ulps of |dQ| for dQ's own rounding.
    A key tile that a fault drops or adds moves dQ by about 8 such terms
    where the bound allows about 1.5."""
    d, n = q.shape[-1], k.shape[-2]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse)
    if causal:
        keep = torch.ones(s.shape[-2], n, dtype=torch.bool,
                          device=s.device).tril()
        p = p.masked_fill(~keep, 0.0)
    dpd = torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta
    ds = (p * dpd * scale).to(q.dtype).float()
    gamma = d * 2.0 ** -22
    eps_p = (scale * gamma * torch.einsum("bhqd,bhkd->bhqk", qf.abs(),
                                          kf.abs())
             + 2.0 ** -21 * (2 + s.abs() + lse.abs()))
    e = (scale * p * (gamma * torch.einsum("bhqd,bhkd->bhqk", dof.abs(),
                                           vf.abs()) + dpd.abs() * eps_p)
         + 2.0 ** -21 * ds.abs())
    del s, p, dpd, eps_p
    ka = kf.abs()
    l1 = ds.abs() @ ka
    noise = torch.minimum(10 * 2 ** -7 / 6 ** 0.5 * torch.sqrt(
        (ds * ds) @ (kf * kf)), 2 ** -7 * l1)
    dq = ds @ kf
    _, x = torch.frexp(dq.abs().clamp_min(torch.finfo(torch.float32).tiny))
    return (noise + e @ ka + n * 2.0 ** -22 * l1
            + 2 * torch.ldexp(torch.full_like(dq, 2 ** -7), x - 1))


def _dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dK = dS^T.q and dV = round(P)^T.dO in plain PyTorch (the
    `_dkv_kernel` function); P is rounded to dO's dtype, dS to q's."""
    p, ds = _bwd_terms(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(o, do):
    """rowsum(f32(dO) * f32(O)): (b, h, sq, 1) f32."""
    return (do.float() * o.float()).sum(dim=-1, keepdim=True)


def _bwd_plain(q, k, v, o, lse, do, causal: bool, scale: float):
    """The backward in plain PyTorch, rounding for rounding as `_bwd`:
    returns (dq, dk, dv) in the inputs' dtypes."""
    delta = _delta(o, do)
    dq = _dq_plain(q, k, v, do, lse, delta, causal, scale)
    dk, dv = _dkv_plain(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def _bwd_fn(name: str, n_ptr: int, n_strides: int):
    fn = getattr(load_library("flash_attention_bwd"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * (3 * n_strides)
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _strides(*ts):
    out = []
    for t in ts:
        out += [t.stride(0), t.stride(1), t.stride(2)]
    return out


def _dq_cuda(q, k, v, do, lse, delta, causal: bool, scale: float):
    global launches_dq
    b, h, sq, d = q.shape
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q, k, v, do)
    dq = torch.empty_like(q)           # in q's layout
    err = _bwd_fn("ff_flash_bwd_dq", 7, 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _DTYPE_CODE[q.dtype],
        b, h, sq, k.shape[2], d, *_strides(q, k, v, do, dq), float(scale),
        int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash dQ kernel launch failed: CUDA error {err}")
    launches_dq += 1
    return dq


def _dkv_cuda(q, k, v, do, lse, delta, causal: bool, scale: float):
    global launches_dkv
    b, h, sq, d = q.shape
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _bwd_fn("ff_flash_bwd_dkv", 8, 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPE_CODE[q.dtype], b, h, sq, k.shape[2], d,
        *_strides(q, k, v, do, dk, dv), float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash dK/dV kernel launch failed: CUDA error {err}")
    launches_dkv += 1
    return dk, dv


def _bwd(q, k, v, o, lse, do, causal: bool, scale: float):
    """(dq, dk, dv) for the saved forward inputs and the output gradient.
    CPU tensors take the plain version; CUDA tensors the two kernels (delta
    is one PyTorch reduction between them, as it is XLA's in JAX)."""
    dev = q.device.type
    if dev == "cpu":
        return _bwd_plain(q, k, v, o, lse, do, causal, scale)
    if dev != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {dev}")
    if do.dtype != q.dtype or do.shape != q.shape:
        raise ValueError(f"flash backward: dO {tuple(do.shape)} {do.dtype} "
                         f"vs q {tuple(q.shape)} {q.dtype}")
    if do.stride(-1) != 1:
        do = do.contiguous()  # the kernels read rows of dO as contiguous
    delta = _delta(o, do).contiguous()   # indexed as (b*h, sq) rows
    dq = _dq_cuda(q, k, v, do, lse, delta, causal, scale)
    dk, dv = _dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with the hand-written backward: forward saves
    (q, k, v, o, lse) as `_flash_fwd` does; backward is `_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = _fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


# ------------------------------------------------------------ public API
def flash_attention(q, k, v, causal: bool = False, scale: float | None = None):
    """q: (b, h, sq, d), k/v: (b, h, sk, d) -> (b, h, sq, d), differentiable
    through the backward kernels."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected rank-4 q/k/v, got {q.shape}/{k.shape}/{v.shape}")
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("causal flash attention requires sq == sk "
                         f"(got {q.shape[2]} vs {k.shape[2]})")
    if k.shape[2] != v.shape[2]:
        raise ValueError(f"k/v length mismatch {k.shape} vs {v.shape}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, bool(causal), float(scale))


def flash_attention_qkv(q, k, v, causal: bool = False, scale: float | None = None):
    """Head-minor layout entry used by ops/attention_ops: q/k/v (b, s, h, d),
    returns (b, sq, h, d)."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, scale=scale)
    return out.transpose(1, 2)
