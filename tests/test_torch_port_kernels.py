"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as the JAX package's own tests run
them. Inputs come from numpy with a fixed seed and go to both packages.
The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_port_cuda.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flexflow_tpu import AdamOptimizer as JAdamOptimizer
from flexflow_tpu import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.losses import LossType as JLossType
from flexflow_tpu.serving.kv_cache import kv_quantize as jkv_quantize
from flexflow_tpu_torch import AdamOptimizer, SGDOptimizer
from flexflow_tpu_torch.convert import (opt_state_from_jax, params_from_jax,
                                        params_to_numpy)
from flexflow_tpu_torch.kernels import (dequant_attention, flash_attention,
                                        fused_ce, fused_optim)
from flexflow_tpu_torch.losses import LossType
from flexflow_tpu_torch.serving.kv_cache import kv_dequantize, kv_quantize

# `flexflow_tpu.kernels` re-exports functions under the module names
jflash = importlib.import_module("flexflow_tpu.kernels.flash_attention")
jdequant = importlib.import_module("flexflow_tpu.kernels.dequant_attention")
jfused_ce = importlib.import_module("flexflow_tpu.kernels.fused_ce")
jfused_optim = importlib.import_module("flexflow_tpu.kernels.fused_optim")

# f32 on both sides; the two sum the same products in another order
ATOL_F32 = 2e-5


def _normal(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("shape", [(2, 2, 256, 64), (1, 2, 256, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax_fwd(shape, causal):
    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, shape) for _ in range(3))
    scale = 1.0 / np.sqrt(shape[-1])
    jo, jlse = jflash._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal, scale)
    po, plse = flash_attention._fwd(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal, scale)
    assert po.shape == shape and plse.shape == shape[:3] + (1,)
    assert plse.dtype == torch.float32
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=ATOL_F32)
    np.testing.assert_allclose(plse.numpy(), np.asarray(jlse), atol=ATOL_F32)


def test_flash_qkv_layout_matches_jax():
    """The (b, s, h, d) entry the attention lowering calls."""
    rng = np.random.default_rng(1)
    q, k, v = (_normal(rng, (2, 128, 2, 64)) for _ in range(3))
    jo = jflash.flash_attention_qkv(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True)
    po = flash_attention.flash_attention_qkv(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=ATOL_F32)


def test_flash_plain_rounds_p_to_v_dtype():
    """bf16 inputs: P is rounded to bf16 before PV and O comes back in
    bf16, as in the TPU kernel; the f32 reference without that rounding
    stays within bf16 resolution."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(_normal(rng, (1, 2, 64, 64))).bfloat16()
               for _ in range(3))
    o, lse = flash_attention._fwd(q, k, v, True, 0.125)
    ref, _ = flash_attention._fwd(q.float(), k.float(), v.float(), True, 0.125)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert float((o.float() - ref).abs().max()) <= 2e-2


def _dequant_inputs(rng, s, b=3, h=2, L=64, d=64):
    qh = _normal(rng, (b, s, h, d))
    kq, ks = kv_quantize(torch.from_numpy(_normal(rng, (b, L, h, d))))
    vq, vs = kv_quantize(torch.from_numpy(_normal(rng, (b, L, h, d))))
    pos = rng.integers(0, L - s + 1, size=b).astype(np.int32)
    return qh, kq.numpy(), ks.numpy(), vq.numpy(), vs.numpy(), pos


@pytest.mark.parametrize("s", [1, 3])
def test_dequant_plain_matches_jax(s):
    rng = np.random.default_rng(3)
    args = _dequant_inputs(rng, s)
    jo = jdequant.dequant_decode_attention(*(jnp.asarray(a) for a in args))
    po = dequant_attention.dequant_decode_attention(
        *(torch.from_numpy(a) for a in args))
    assert po.shape == args[0].shape and po.dtype == torch.float32
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=ATOL_F32)


PAGE, PAGES_PER_SLOT = 16, 5


def _paged_inputs(rng, s, h=2, d=64):
    """q, the int8 pools and scales as the KV cache holds them (4 slots'
    worth of pages plus the scratch page 0, all of it random), a shuffled
    page table that maps each slot's positions 0..pos+s-1 and holds the
    scratch page 0 past them, and pos: 0, a window that crosses a page
    boundary, a slot whose last position is the table's last, and one
    drawn from the seed."""
    b, L = 4, PAGES_PER_SLOT * PAGE
    pages = b * PAGES_PER_SLOT + 1
    q = _normal(rng, (b, s, h, d))
    kq, ks = kv_quantize(torch.from_numpy(_normal(rng, (pages, PAGE, h, d))))
    vq, vs = kv_quantize(torch.from_numpy(_normal(rng, (pages, PAGE, h, d))))
    pos = np.array([0, PAGE - 2, L - s, rng.integers(0, L - s + 1)], np.int32)
    ids = rng.permutation(np.arange(1, pages)).reshape(b, PAGES_PER_SLOT)
    extent = -(-(pos + s) // PAGE)
    table = np.where(np.arange(PAGES_PER_SLOT)[None] < extent[:, None], ids,
                     0).astype(np.int32)
    return (q, (kq, ks, vq, vs), torch.from_numpy(table),
            torch.from_numpy(pos))


@pytest.mark.parametrize("s", [1, 3, 8])
def test_paged_plain_matches_jax(s):
    """The paged call under a shuffled page table (scratch entries past
    each slot's extent) against the JAX kernel fed the JAX lowering's
    gather `pool[table]` of the same pools."""
    q, (kq, ks, vq, vs), table, pos = _paged_inputs(np.random.default_rng(7), s)
    b, _, h, d = q.shape
    jt = jnp.asarray(table.numpy())
    jo = jdequant.dequant_decode_attention(
        jnp.asarray(q), jnp.asarray(kq.numpy())[jt].reshape(b, -1, h, d),
        jnp.asarray(ks.numpy())[jt].reshape(b, -1, h),
        jnp.asarray(vq.numpy())[jt].reshape(b, -1, h, d),
        jnp.asarray(vs.numpy())[jt].reshape(b, -1, h), jnp.asarray(pos.numpy()))
    po = dequant_attention.paged_dequant_decode_attention(
        torch.from_numpy(q), kq, ks, vq, vs, table, pos)
    assert po.shape == q.shape and po.dtype == torch.float32
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=ATOL_F32)


@pytest.mark.parametrize("s", [1, 8])
def test_gathered_is_paged_with_identity_table(s):
    """The gathered call is the paged one with each slot's context as one
    page (page = L, table arange(slots)[:, None]): the same numbers."""
    qh, kq, ks, vq, vs, pos = (torch.from_numpy(a) for a in
                               _dequant_inputs(np.random.default_rng(8), s))
    table = torch.arange(qh.shape[0], dtype=torch.int32)[:, None]
    got = dequant_attention.dequant_decode_attention(qh, kq, ks, vq, vs, pos)
    want = dequant_attention.paged_dequant_decode_attention(
        qh, kq, ks, vq, vs, table, pos)
    assert torch.equal(got, want)


def test_kv_quantize_bitwise_equal_to_jax():
    rng = np.random.default_rng(4)
    x = _normal(rng, (4, 33, 2, 64)) * 3.0
    x[0, 0] = 0.0                      # all-zero rows: the scale floor
    x[1, 1, 0, :4] = [0.5, -0.5, 1.5, -2.5]   # ties at amax 127
    x[1, 1, 0, 4] = 127.0
    jq, js = jkv_quantize(jnp.asarray(x))
    pq, ps = kv_quantize(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    # round half to even, as jnp.round does
    assert pq[1, 1, 0, :4].tolist() == [0, 0, 2, -2]
    back = kv_dequantize(pq, ps)
    assert float((back - torch.from_numpy(x)).abs().max()) <= \
        float(ps.max()) / 2 + 1e-6


# Shared memory per block of each route, from the kernels' tile layouts:
# bf16 runs all three kernels on the tensor cores, whose tiles are bf16
# rows padded by 8 elements (forward: a q tile of 128 rows at head_dim 64
# and 64 at 128, plus two 64-row buffers each of k and v; dQ: q and dO plus
# two 64-row buffers each of k and v; dK/dV: k, v and two buffers each of q
# and dO, plus two of lse and delta in f32); f32 runs the scalar kernels'
# f32 tiles.
def _route_smem(d, dtype):
    if dtype == torch.bfloat16:
        fwd = ({64: 128, 128: 64}[d] + 4 * 64) * (d + 8) * 2
        dq = (2 * 64 + 4 * 64) * (d + 8) * 2
        dkv = (2 * 64 + 4 * 64) * (d + 8) * 2 + 4 * 64 * 4
    else:
        fwd = 4 * (64 * (d + 1) * 2 + 64 * d + 64 * 65)
        dq = 4 * (4 * 64 * (d + 1) + 64 * 65)
        dkv = 4 * (4 * 64 * (d + 1) + 2 * 64 * 65 + 2 * 64)
    return fwd, dq, dkv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_gates(dtype, d, causal):
    fwd, dq, dkv = _route_smem(d, dtype)
    assert flash_attention.fwd_smem_bytes(d, dtype) == fwd
    assert flash_attention.dq_smem_bytes(d, dtype) == dq
    assert dq <= flash_attention.SMEM_LIMIT
    assert flash_attention.dkv_smem_bytes(d, dtype) == dkv
    assert flash_attention.smem_bytes(d, dtype) == max(fwd, dq, dkv)
    assert max(fwd, dq, dkv) <= flash_attention.SMEM_LIMIT
    # every shape admitted before the tensor-core route still is
    for sq in (1, 64, 65, 200, 1024):
        assert flash_attention.flash_supported(sq, sq, d, dtype, causal=causal,
                                               batch_heads=128)
    assert flash_attention.flash_supported(200, 333, d, dtype)
    assert not flash_attention.flash_supported(128, 256, d, dtype, causal=True)
    assert not flash_attention.flash_supported(128, 128, 96, dtype,
                                               causal=causal)
    assert not flash_attention.flash_supported(128, 128, d, torch.float16,
                                               causal=causal)
    assert not flash_attention.flash_supported(128, 128, d, dtype,
                                               causal=causal,
                                               batch_heads=65536)
    assert flash_attention.flash_supported(1024, 1024, 64, torch.bfloat16,
                                           causal=True, batch_heads=128)
    assert flash_attention.flash_supported(256, 256, 128, torch.float32)
    assert not flash_attention.flash_supported(128, 256, 64, torch.float32,
                                               causal=True)
    assert not flash_attention.flash_supported(128, 128, 96, torch.float32)
    assert not flash_attention.flash_supported(128, 128, 64, torch.float16)
    assert dequant_attention.dequant_supported(1, 1056, 64, torch.bfloat16)
    assert dequant_attention.dequant_supported(8, 1056, 128, torch.float32)
    assert not dequant_attention.dequant_supported(9, 1056, 64, torch.float32)
    assert not dequant_attention.dequant_supported(1, 1056, 96, torch.float32)
    assert not dequant_attention.dequant_supported(1, 1056, 64, torch.float16)
    # the split-K kernel's shared memory does not grow with the context
    assert dequant_attention.dequant_supported(1, 10 ** 6, 64, torch.float32)
    q, pools, table, pos = _paged_inputs(np.random.default_rng(9), 1)
    with pytest.raises(ValueError, match="page table"):
        dequant_attention.paged_dequant_decode_attention(
            torch.from_numpy(q), *pools, table[:, None], pos)
    with pytest.raises(ValueError, match="page table"):
        dequant_attention.paged_dequant_decode_attention(
            torch.from_numpy(q), *pools, table[1:], pos)


def test_rows_aligned_check():
    """The bf16 tensor-core route's layout rule: 16-byte aligned base and
    batch/head/seq strides in multiples of 8 elements. The (b, s, h, d)
    views the attention lowering passes pass; a view one element off, or
    with a seq stride of 9 elements, raises."""
    x = torch.zeros((2, 200, 3, 64), dtype=torch.bfloat16)
    flash_attention._check_rows_aligned(x.transpose(1, 2), x[:, :64])
    flat = torch.zeros(2 * 200 * 3 * 64 + 8, dtype=torch.bfloat16)
    off = flat[1:1 + x.numel()].view(2, 200, 3, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention._check_rows_aligned(x.transpose(1, 2), off)
    odd = torch.zeros((2, 3, 200, 9), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention._check_rows_aligned(odd)


def test_wrappers_raise_off_cpu_and_cuda():
    """Only CPU tensors take the plain versions; any other device is
    refused instead of computed somewhere else."""
    q = torch.zeros((1, 64, 1, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention.flash_attention_qkv(q, q, q, causal=True)
    kq = torch.zeros((1, 64, 1, 64), dtype=torch.int8, device="meta")
    ks = torch.zeros((1, 64, 1), device="meta")
    pos = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        dequant_attention.dequant_decode_attention(q[:, :1], kq, ks, kq, ks,
                                                   pos)


# ------------------------------------------------------- flash backward
def _rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|): the gradients sum hundreds
    of products, so their scale grows with the sequence."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# f32: the same products summed in another order (Pallas blocks of 128 or
# 256 against one einsum). bf16: dS and P are rounded to bf16 at the same
# points on both sides, so what differs is an f32 sum that lands on the
# other side of a bf16 rounding boundary, a few bf16 ulps at most.
BWD_TOL = {np.float32: 2e-5, jnp.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,seq", [(64, 256), (128, 128)])
def test_bwd_plain_matches_jax_grad(dtype, causal, d, seq):
    """`_bwd_plain` against jax.vjp of the Pallas flash attention (its
    `_bwd`: the `_dq_kernel` and `_dkv_kernel` in interpret mode)."""
    rng = np.random.default_rng(10)
    q, k, v, g = (_normal(rng, (1, 2, seq, d)) for _ in range(4))
    jq, jk, jv, jg = (jnp.asarray(a).astype(dtype) for a in (q, k, v, g))
    jo, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(
        a, b, c, causal=causal), jq, jk, jv)
    jgrads = vjp(jg)
    tq, tk, tv, tg = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                      .to(torch.float32 if dtype is np.float32
                          else torch.bfloat16) for a in (jq, jk, jv, jg))
    o, lse = flash_attention._fwd(tq, tk, tv, causal, d ** -0.5)
    grads = flash_attention._bwd_plain(tq, tk, tv, o, lse, tg, causal,
                                       d ** -0.5)
    for got, want in zip(grads, jgrads):
        assert got.dtype == tq.dtype
        assert _rel_err(got.float().numpy(),
                        np.asarray(want.astype(jnp.float32))) <= BWD_TOL[dtype]


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_torch_autograd(causal):
    """In f32 the hand-derived backward equals autograd of the plain
    forward (the same function, differentiated by PyTorch)."""
    rng = np.random.default_rng(11)
    q, k, v, g = (torch.from_numpy(_normal(rng, (2, 3, 96, 64)))
                  for _ in range(4))
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    o, lse = flash_attention._fwd_plain(qa, ka, va, causal, 0.125)
    want = torch.autograd.grad(o, (qa, ka, va), g)
    got = flash_attention._bwd_plain(q, k, v, o.detach(), lse.detach(), g,
                                     causal, 0.125)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


def test_flash_function_grads_are_bwd_plain():
    """On CPU tensors the autograd Function's backward is `_bwd_plain`,
    bit for bit, through the (b, s, h, d) entry's transposes."""
    rng = np.random.default_rng(12)
    q, k, v, g = (torch.from_numpy(_normal(rng, (2, 128, 2, 64)))
                  for _ in range(4))
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out = flash_attention.flash_attention_qkv(qa, ka, va, causal=True)
    got = torch.autograd.grad(out, (qa, ka, va), g)
    t = lambda x: x.transpose(1, 2)
    o, lse = flash_attention._fwd(t(q), t(k), t(v), True, 0.125)
    want = flash_attention._bwd_plain(t(q), t(k), t(v), o, lse, t(g), True,
                                      0.125)
    for a, b in zip(got, want):
        assert torch.equal(a, t(b))


def _dq_f64(q, k, v, do, lse, delta, causal: bool, scale: float,
            keep=None):
    """dQ as the bf16 route defines it (dS rounded to bf16 before dS.K,
    dQ rounded once), with S, dP, P and both sums in float64: every f32
    operation in another order, as the kernel has them. `keep` (sq, sk)
    replaces the causal mask."""
    s = q.double() @ k.double().transpose(-1, -2) * scale
    p = torch.exp(s - lse.double())
    if keep is None and causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    dp = do.double() @ v.double().transpose(-1, -2)
    ds = (p * (dp - delta.double()) * scale).to(torch.bfloat16)
    return (ds.double() @ k.double()).to(torch.bfloat16)


def _bwd_inputs(seq: int, causal: bool):
    rng = np.random.default_rng(13)
    q, k, v, do = (torch.from_numpy(_normal(rng, (1, 2, seq, 64)))
                   .bfloat16() for _ in range(4))
    o, lse = flash_attention._fwd(q, k, v, causal, 0.125)
    return q, k, v, do, lse, flash_attention._delta(o, do), causal, 0.125


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [1, 64, 200, 1024])
def test_dq_bf16_bound_admits_another_order(causal, seq):
    """`_dq_bf16_bound`, the element-wise bound the card holds the bf16 dQ
    kernel to, admits dQ made with every f32 operation in another order
    (float64 here), also at one row, where dQ is all cancellation."""
    args = _bwd_inputs(seq, causal)
    want = flash_attention._dq_plain(*args).float()
    bound = flash_attention._dq_bf16_bound(*args)
    err = (_dq_f64(*args).float() - want).abs()
    assert bool(torch.isfinite(bound).all())
    assert float((err / bound).max()) <= 1.0


@pytest.mark.parametrize("fault", ["diagonal key dropped",
                                   "key past the diagonal",
                                   "last key tile dropped",
                                   "first key tile dropped"])
def test_dq_bf16_bound_sees_late_tile_faults(fault):
    """A causal-mask or tile fault confined to the last 64-row q tile of
    1024, whose terms are ~1/1024 each, exceeds the bound there; the rows
    it spares stay within it."""
    args = _bwd_inputs(1024, True)
    r, c = torch.arange(1024)[:, None], torch.arange(1024)[None, :]
    late = r >= 1024 - 64
    keep = torch.where(late, {
        "diagonal key dropped": c < r,
        "key past the diagonal": c <= r + 1,
        "last key tile dropped": c < 1024 - 64,
        "first key tile dropped": (c >= 64) & (c <= r)}[fault], c <= r)
    want = flash_attention._dq_plain(*args).float()
    bound = flash_attention._dq_bf16_bound(*args)
    excess = (_dq_f64(*args, keep=keep).float() - want).abs() / bound
    assert float(excess[..., -64:, :].max()) > 1.0
    assert float(excess[..., :-64, :].max()) <= 1.0


@pytest.mark.parametrize("wrapper", ["_dq_cuda", "_dkv_cuda"])
def test_bf16_bwd_wrappers_check_rows_first(wrapper):
    """Both backward wrappers check a bf16 tensor's rows before they load
    a kernel or allocate: a view one element off 16 bytes raises
    ValueError and counts no launch."""
    good = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16)
    flat = torch.zeros(good.numel() + 8, dtype=torch.bfloat16)
    bad = flat[1:1 + good.numel()].view(good.shape)
    lse = torch.zeros((1, 2, 64, 1))
    before = (flash_attention.launches_dq, flash_attention.launches_dkv)
    with pytest.raises(ValueError, match="16-byte aligned"):
        getattr(flash_attention, wrapper)(good, good, good, bad, lse, lse,
                                          True, 0.125)
    assert (flash_attention.launches_dq, flash_attention.launches_dkv) == \
        before


# ------------------------------------------------------------ optimizers
def _param_tree(rng):
    return {"a": {"kernel": _normal(rng, (33, 17)), "bias": _normal(rng, (17,))},
            "b": {"gamma": _normal(rng, (300,))}}


def _grads(rng, tree):
    return {l: {w: _normal(rng, a.shape) for w, a in ws.items()}
            for l, ws in tree.items()}


def _assert_tree_close(port, jtree, rtol, atol=1e-7):
    jt = jax.device_get(jtree)
    for l, ws in port.items():
        for w, t in ws.items():
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(jt[l][w], np.float32),
                                       rtol=rtol, atol=atol, err_msg=f"{l}.{w}")


# f32 moments: the same f32 operations, which XLA may contract into FMAs
# (one rounding less); bf16 moments: that difference can move a stored
# moment by one bf16 ulp (2**-8 relative).
MOMENT_RTOL = {"float32": 1e-6, "bfloat16": 2 ** -7}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fused_adam_plain_matches_jax(state_dtype, wd):
    """The fused update's plain version against the JAX `fused_update`
    (the Pallas `_adam_kernel` in interpret mode) plus `apply_updates`,
    over three counts, from the JAX state carried across."""
    rng = np.random.default_rng(13)
    tree = _param_tree(rng)
    jopt = JAdamOptimizer(alpha=1e-2, weight_decay=wd, state_dtype=state_dtype)
    opt = AdamOptimizer(alpha=1e-2, weight_decay=wd, state_dtype=state_dtype)
    jplan, plan = jfused_optim.plan_for(jopt), fused_optim.plan_for(opt)
    assert plan["kind"] == jplan["kind"] == "adam"
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.to_optax().init(jparams)
    params = params_from_jax(tree)
    state = opt_state_from_jax(jax.device_get(jstate))
    for _ in range(3):
        g = _grads(rng, tree)
        upd, jstate = jfused_optim.fused_update(
            jplan, jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        state = fused_optim.fused_update(plan, params_from_jax(g), state,
                                         params)
        _assert_tree_close(params, jparams, 1e-6)
        js = jstate[0]
        assert state["count"] == int(js.count)
        assert state["mu"]["a"]["kernel"].dtype == opt.moment_dtype()
        _assert_tree_close(state["mu"], js.mu, MOMENT_RTOL[state_dtype])
        _assert_tree_close(state["nu"], js.nu, MOMENT_RTOL[state_dtype])
    assert fused_optim.launches == 0


OPTIMIZERS = [
    ("sgd", dict(lr=0.1)),
    ("sgd", dict(lr=0.1, momentum=0.9, weight_decay=0.01)),
    ("sgd", dict(lr=0.1, momentum=0.9, nesterov=True)),
    ("adam", dict(alpha=1e-2)),
    ("adam", dict(alpha=1e-2, weight_decay=0.01)),
    ("adam", dict(alpha=1e-2, state_dtype="bfloat16", weight_decay=0.01)),
]


@pytest.mark.parametrize("kind,kw", OPTIMIZERS)
def test_optimizer_update_matches_optax(kind, kw):
    """The port's own (unfused) update against the JAX optimizer's optax
    chain, over three steps."""
    rng = np.random.default_rng(14)
    tree = _param_tree(rng)
    jopt = (JAdamOptimizer if kind == "adam" else JSGDOptimizer)(**kw)
    opt = (AdamOptimizer if kind == "adam" else SGDOptimizer)(**kw)
    tx = jopt.to_optax()
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = tx.init(jparams)
    params = params_from_jax(tree)
    state = opt.init_state(params)
    for _ in range(3):
        g = _grads(rng, tree)
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        state = opt.update(params_from_jax(g), state, params)
    _assert_tree_close(params, jparams, 1e-6)
    carried = opt_state_from_jax(jax.device_get(jstate))
    assert set(carried) == set(state)
    for key in carried:
        if key == "count":
            assert carried[key] == state[key] == 3
        else:
            _assert_tree_close(state[key], params_to_numpy(carried[key]),
                               MOMENT_RTOL[kw.get("state_dtype", "float32")])


def test_params_round_trip_through_numpy():
    rng = np.random.default_rng(15)
    tree = _param_tree(rng)
    back = params_to_numpy(params_from_jax(tree, dtype=torch.bfloat16))
    for l, ws in tree.items():
        for w, a in ws.items():
            assert back[l][w].dtype == np.float32
            np.testing.assert_allclose(back[l][w], a, rtol=2 ** -8)


# ------------------------------------------------------------- fused CE
# GPT-2 medium at 50257 and padded to 50304 (`vocab_pad_to=128`); GPT-2
# tiny at 5120 and at 5000, whose padded lm_head has 5120 columns
CE_SHAPES = [(8, 1024, 50257), (8, 1024, 50304), (8, 128, 5120),
             (4, 128, 5120), (4, 128, 5000), (3, 5, 256), (16, 256), (8, 100),
             (2, 64, 250), (2, 64, 256), (7, 128)]


@pytest.mark.parametrize("shape", CE_SHAPES)
def test_fused_ce_gate_matches_jax(shape):
    """`fused_ce_supported` and `use_fused_ce` answer as the JAX gate does,
    for both dtypes, every mode and fusion on or off."""
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        logits = torch.empty(shape, dtype=tdt, device="meta")
        jlogits = jax.ShapeDtypeStruct(shape, jdt)
        want = jfused_ce.fused_ce_supported(shape, jdt)
        assert fused_ce.fused_ce_supported(shape, tdt) == want
        for mode in ("auto", "off"):
            for fusion in (True, False):
                assert fused_ce.use_fused_ce(
                    LossType.SPARSE_CATEGORICAL_CROSSENTROPY, logits, mode,
                    fusion) == jfused_ce.use_fused_ce(
                    JLossType.SPARSE_CATEGORICAL_CROSSENTROPY, jlogits, mode,
                    fusion)
        if want:
            assert fused_ce.use_fused_ce("sparse_categorical_crossentropy",
                                         logits, "on")
        else:
            with pytest.raises(ValueError, match="don't qualify"):
                fused_ce.use_fused_ce("sparse_categorical_crossentropy",
                                      logits, "on")
        assert not fused_ce.use_fused_ce("mean_squared_error", logits, "auto")
    assert not fused_ce.fused_ce_supported((8, 1024, 50257), torch.float32)


def test_fused_ce_plain_matches_jax():
    """Loss and logits gradient of the plain version against the JAX
    fused cross-entropy (its Pallas kernels in interpret mode)."""
    rng = np.random.default_rng(16)
    x = _normal(rng, (32, 512)) * 3.0
    y = rng.integers(0, 512, size=(32,)).astype(np.int32)
    jl, jg = jax.value_and_grad(jfused_ce.fused_cross_entropy)(
        jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_()
    loss = fused_ce.fused_cross_entropy(xt, torch.from_numpy(y))
    (g,) = torch.autograd.grad(loss, (xt,))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-7)


CE_DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _ce_inputs(rng, n, v, jdt, tdt):
    """The same (n, v) logits in both packages (rounded to bf16 once, by
    JAX) and int32 labels."""
    jx = jnp.asarray(_normal(rng, (n, v)) * 3.0).astype(jdt)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(tdt)
    y = rng.integers(0, v, size=(n,)).astype(np.int32)
    return jx, tx, y


@pytest.mark.parametrize("jdt,tdt", CE_DTYPES)
@pytest.mark.parametrize("n,v", [(64, 512), (256, 1280), (512, 5120)])
def test_fused_ce_fwd_plain_matches_jax(n, v, jdt, tdt):
    """`_fwd_plain` against the JAX `_forward` (`_fwd_kernel` in
    interpret mode): per-row loss and lse in f32, equal to 1e-6 relative
    (the two sum the row's exponentials in another order)."""
    rng = np.random.default_rng(17)
    jx, tx, y = _ce_inputs(rng, n, v, jdt, tdt)
    jloss, jlse = jfused_ce._forward(jx, jnp.asarray(y)[:, None])
    loss, lse = fused_ce._fwd_plain(tx, torch.from_numpy(y))
    assert loss.dtype == lse.dtype == torch.float32
    assert loss.shape == lse.shape == (n,)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0], rtol=1e-6)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss)[:, 0],
                               rtol=1e-6)


def _bf16_ulp(a):
    """One bf16 ulp at each value of `a` (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("jdt,tdt", CE_DTYPES)
@pytest.mark.parametrize("n,v", [(64, 512), (256, 1280), (512, 5120)])
def test_fused_ce_bwd_plain_matches_jax(n, v, jdt, tdt):
    """`_bwd_plain` against the JAX `_backward` (`_bwd_kernel` in
    interpret mode) from the same lse and g/n: dx in the logits' dtype,
    within 1e-7 absolute in f32 and one bf16 ulp in bf16 (the two
    packages' exp may differ in the last bit before the rounding)."""
    rng = np.random.default_rng(18)
    jx, tx, y = _ce_inputs(rng, n, v, jdt, tdt)
    _, jlse = jfused_ce._forward(jx, jnp.asarray(y)[:, None])
    gs = np.float32(0.7 / n)
    jdx = jfused_ce._backward(jx, jnp.asarray(y)[:, None], jlse,
                              jnp.float32(gs))
    dx = fused_ce._bwd_plain(tx, torch.from_numpy(y),
                             torch.from_numpy(np.asarray(jlse)[:, 0]),
                             torch.tensor(gs))
    assert dx.dtype == tdt and dx.shape == (n, v)
    want = np.asarray(jdx.astype(jnp.float32))
    err = np.abs(dx.float().numpy() - want)
    if tdt == torch.float32:
        assert err.max() <= 1e-7
    else:
        assert np.all(err <= _bf16_ulp(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_function_grad_is_bwd_plain(dtype):
    """On CPU tensors the autograd Function returns the mean of
    `_fwd_plain`'s rows and its gradient is `_bwd_plain` from the saved
    lse and g / n, bit for bit, through the [B, S, vocab] reshape; int64
    labels give the same result as int32."""
    rng = np.random.default_rng(19)
    x = torch.from_numpy(_normal(rng, (2, 16, 256)) * 3.0).to(dtype)
    y = torch.from_numpy(rng.integers(0, 256, size=(2, 16)).astype(np.int32))
    g = torch.tensor(0.7)
    xa = x.clone().requires_grad_()
    loss = fused_ce.fused_cross_entropy(xa, y)
    (got,) = torch.autograd.grad(loss, (xa,), g)
    rows, lse = fused_ce._fwd_plain(x.reshape(32, 256), y.reshape(32))
    want = fused_ce._bwd_plain(x.reshape(32, 256), y.reshape(32), lse, g / 32)
    assert torch.equal(loss.detach(), rows.mean())
    assert got.dtype == dtype and torch.equal(got, want.reshape(2, 16, 256))
    xb = x.clone().requires_grad_()
    loss64 = fused_ce.fused_cross_entropy(xb, y.long())
    assert torch.equal(loss64.detach(), loss.detach())
    assert torch.equal(torch.autograd.grad(loss64, (xb,), g)[0], got)
    assert (fused_ce.launches_fwd, fused_ce.launches_bwd) == (0, 0)


def test_fused_ce_labels_outside_vocab_pick_nothing():
    """A label outside [0, v) matches no column, as in JAX: its row's loss
    is its lse and its gradient row the softmax alone."""
    rng = np.random.default_rng(20)
    x = _normal(rng, (16, 256))
    y = rng.integers(0, 256, size=(16,)).astype(np.int32)
    y[3], y[7] = -1, 256
    jloss, jlse = jfused_ce._forward(jnp.asarray(x), jnp.asarray(y)[:, None])
    loss, lse = fused_ce._fwd_plain(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss)[:, 0],
                               rtol=1e-6)
    assert float(loss[3]) == float(lse[3])
    dx = fused_ce._bwd_plain(torch.from_numpy(x), torch.from_numpy(y), lse,
                             torch.tensor(1.0))
    assert bool((dx[7] >= 0).all())
    jdx = jfused_ce._backward(jnp.asarray(x), jnp.asarray(y)[:, None],
                              jlse, jnp.float32(1.0))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-7)


def test_fused_wrappers_raise_off_cpu_and_cuda():
    """The fused CE and fused optimizer entries refuse any device other
    than the CPU (plain versions) and CUDA (kernels)."""
    x = torch.zeros((8, 128), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_ce.fused_cross_entropy(x, torch.zeros((8,), dtype=torch.int32,
                                                    device="meta"))
    p = {"a": {"w": torch.zeros((4,), device="meta")}}
    for opt in (SGDOptimizer(lr=0.1), AdamOptimizer()):
        with pytest.raises(ValueError, match="cuda or cpu"):
            fused_optim.fused_update(fused_optim.plan_for(opt), p,
                                     opt.init_state(p), p)


SGD_CONFIGS = [dict(lr=0.1), dict(lr=0.1, weight_decay=0.01),
               dict(lr=0.1, momentum=0.9, weight_decay=0.01),
               dict(lr=0.1, momentum=0.9, nesterov=True)]


@pytest.mark.parametrize("kw", SGD_CONFIGS)
def test_fused_sgd_plain_matches_jax(kw):
    """The fused SGD update's plain version against the JAX
    `fused_update` (the Pallas `_sgd_kernel` or `_sgd_plain_kernel` in
    interpret mode) plus `apply_updates`, over three steps, from the JAX
    state carried across: params and the trace within 1e-6 relative (XLA
    may contract a product and a sum into one FMA), and 1e-6 absolute
    where `p - lr u` cancels near 0 (the error of its O(1) operands)."""
    rng = np.random.default_rng(21)
    tree = _param_tree(rng)
    jopt, opt = JSGDOptimizer(**kw), SGDOptimizer(**kw)
    jplan, plan = jfused_optim.plan_for(jopt), fused_optim.plan_for(opt)
    assert plan["kind"] == jplan["kind"] == "sgd"
    assert {k: plan[k] for k in jplan} == jplan
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.to_optax().init(jparams)
    params = params_from_jax(tree)
    state = opt_state_from_jax(jax.device_get(jstate))
    assert set(state) == ({"trace"} if kw.get("momentum") else set())
    for _ in range(3):
        g = _grads(rng, tree)
        upd, jstate = jfused_optim.fused_update(
            jplan, jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        state = fused_optim.fused_update(plan, params_from_jax(g), state,
                                         params)
        _assert_tree_close(params, jparams, 1e-6, atol=1e-6)
        if kw.get("momentum"):
            jtrace = jfused_optim._find_node(jstate, optax.TraceState)
            _assert_tree_close(state["trace"], jtrace.trace, 1e-6, atol=1e-6)
    assert (fused_optim.launches_sgd, fused_optim.launches_sgd_plain) == (0, 0)
