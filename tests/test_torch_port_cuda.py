"""The port's hand-written CUDA kernels against their plain versions, on
the card.

Every test here is marked `cuda` and skips where torch sees no GPU. The
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(`--noconftest` skips tests/conftest.py, which sets JAX up for the rest of
the suite.)
"""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.kernels import dequant_attention, flash_attention
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.serving import compile_serving, gpt2_prompt_inputs
from flexflow_tpu_torch.serving.kv_cache import kv_quantize


def _dequant_inputs(rng, s, b=3, h=2, L=64, d=64):
    qh = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kq, ks = kv_quantize(torch.from_numpy(
        rng.standard_normal((b, L, h, d)).astype(np.float32)))
    vq, vs = kv_quantize(torch.from_numpy(
        rng.standard_normal((b, L, h, d)).astype(np.float32)))
    pos = rng.integers(0, L - s + 1, size=b).astype(np.int32)
    return qh, kq.numpy(), ks.numpy(), vq.numpy(), vs.numpy(), pos


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (runs on the card)")
    return torch.device("cuda")


def _ulp_err(got, want):
    """max over elements of |got - want| in ulps of got's dtype, the ulp
    taken at the larger of the two magnitudes."""
    eps = torch.finfo(got.dtype).eps
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(
        torch.finfo(torch.float32).tiny)
    _, e = torch.frexp(mag)                # mag in [2**(e-1), 2**e)
    return float(((g - w).abs() / torch.ldexp(torch.full_like(mag, eps),
                                              e - 1)).max())


def _flash_bf16_o_bound(q, k, v, causal, scale):
    """The largest |O - plain O| allowed, element by element, for the bf16
    forward on (b, h, s, d) views. Both round each p_j to bf16 before P.V,
    from exp(s - m) against other maxima (the kernel's running max, the
    plain version's final one): each term p_j v_j / l carries a rounding
    error of at most 2**-8 relative in each, with a standard deviation
    below 2**-7 / sqrt(6) in their difference. Allowed: ten standard
    deviations of that sum, capped at its worst case, plus 2 bf16 ulps of
    |O| for O's own rounding."""
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


# (sq, sk, causal): a ragged length (200), one row, an exact tile (64), a
# tile and one row (65), the training length (1024), and sq != sk without
# the mask: the bf16 kernel's ragged-tail, exact-tile and unmasked paths
FLASH_SHAPES = [(n, n, causal) for n in (200, 1, 64, 65, 1024)
                for causal in (False, True)] + [(200, 333, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("sq,sk,causal", FLASH_SHAPES)
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_matches_plain_on_card(dtype, tol, sq, sk, causal, d):
    """O and lse of the forward kernel (bf16: the tensor-core route, f32:
    the scalar one) against the plain version, one launch per call: O
    within `tol`, and in bf16 within its element-wise rounding bound; lse
    (f32 sums of at most 1024 exponentials) within 1e-4."""
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((2, n, 3, d), generator=g, device=dev).to(dtype)
               for n in (sq, sk, sk))
    scale = d ** -0.5
    before = flash_attention.launches
    out = flash_attention.flash_attention_qkv(q, k, v, causal=causal,
                                              scale=scale)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ref, ref_lse = flash_attention._fwd_plain(qt, kt, vt, causal, scale)
    err = (out.transpose(1, 2).float() - ref.float()).abs()
    assert float(err.max()) <= tol
    if dtype == torch.bfloat16:
        bound = _flash_bf16_o_bound(qt, kt, vt, causal, scale)
        assert float((err / bound).max()) <= 1.0
    _, lse = flash_attention._fwd(qt, kt, vt, causal, scale)
    torch.cuda.synchronize()
    assert float((lse - ref_lse).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_flash_unaligned_bf16_raises_on_card():
    """The bf16 route copies rows in 16-byte pieces: a view one element
    off a 16-byte boundary raises ValueError before any launch, in the
    forward, in dQ and in dK/dV."""
    dev = _cuda_or_skip()
    shape = (2, 64, 3, 64)
    n = 2 * 64 * 3 * 64
    flat = torch.randn(n + 8, device=dev).to(torch.bfloat16)
    bad = flat[1:1 + n].view(shape)
    good = torch.randn(shape, device=dev).to(torch.bfloat16)
    before = (flash_attention.launches, flash_attention.launches_dq,
              flash_attention.launches_dkv)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention.flash_attention_qkv(bad, good, good, causal=True)
    gt, bt = good.transpose(1, 2), bad.transpose(1, 2)
    lse = torch.zeros((2, 3, 64, 1), device=dev)
    for bwd in (flash_attention._dq_cuda, flash_attention._dkv_cuda):
        with pytest.raises(ValueError, match="16-byte aligned"):
            bwd(gt, gt, gt, bt, lse, lse, True, 0.125)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.launches_dq,
            flash_attention.launches_dkv) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("s", [1, 3, 8])
def test_dequant_kernel_matches_plain_on_card(dtype, tol, s):
    """The gathered call (the paged kernel with each slot's context as one
    page of 160 keys, not a multiple of the 64-key chunks)."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(5)
    qh, kq, ks, vq, vs, pos = (torch.from_numpy(a).to(dev)
                               for a in _dequant_inputs(rng, s, L=160))
    qh = qh.to(dtype)
    before = dequant_attention.launches
    out = dequant_attention.dequant_decode_attention(qh, kq, ks, vq, vs, pos)
    torch.cuda.synchronize()
    assert dequant_attention.launches == before + 1
    ref = dequant_attention._plain(qh, kq, ks, vq, vs, pos, 0.125)
    assert float((out.float() - ref.float()).abs().max()) <= tol


def _paged_inputs(rng, s, dev, b, pages_per_slot, d, h=2, page=16):
    """q, pools with the scratch page 0 (all random), a shuffled page table
    with the scratch page past each slot's extent, and pos: the last b of
    0, a window that crosses a page boundary, one that crosses the
    kernel's chunk boundary and a slot whose last position is the table's
    last, then values drawn from the seed."""
    L = pages_per_slot * page
    pages = b * pages_per_slot + 1
    q = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
    kq, ks = kv_quantize(torch.from_numpy(
        rng.standard_normal((pages, page, h, d)).astype(np.float32)))
    vq, vs = kv_quantize(torch.from_numpy(
        rng.standard_normal((pages, page, h, d)).astype(np.float32)))
    fixed = [0, page - 2, dequant_attention.CHUNK - 2, L - s]
    drawn = rng.integers(0, L - s + 1, size=max(0, b - len(fixed)))
    pos = np.array(fixed + list(drawn), np.int32)[-b:]
    ids = rng.permutation(np.arange(1, pages)).reshape(b, pages_per_slot)
    extent = -(-(pos + s) // page)
    table = np.where(np.arange(pages_per_slot)[None] < extent[:, None], ids, 0)
    return (q.to(dev), tuple(t.to(dev) for t in (kq, ks, vq, vs)),
            torch.from_numpy(table.astype(np.int32)).to(dev),
            torch.from_numpy(pos).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("s", [1, 3, 8])
@pytest.mark.parametrize("b,pages_per_slot,d", [(6, 10, 64), (2, 256, 128)])
def test_paged_dequant_kernel_matches_plain_on_card(dtype, tol, s, b,
                                                    pages_per_slot, d):
    """The paged kernel against its plain version (gather, then the plain
    attention) under a shuffled page table, at 160 keys a slot and at 4096
    keys of head_dim 128 (a context the single-block kernel refused). Two
    launches back to back give the same bits, and leave every merge
    counter at 0 for the next."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(10)
    q, (kq, ks, vq, vs), table, pos = _paged_inputs(rng, s, dev, b,
                                                    pages_per_slot, d)
    q = q.to(dtype)
    before = dequant_attention.launches
    outs = [dequant_attention.paged_dequant_decode_attention(
        q, kq, ks, vq, vs, table, pos) for _ in range(2)]
    torch.cuda.synchronize()
    assert dequant_attention.launches == before + 2
    assert torch.equal(outs[0], outs[1])
    assert all(int(t.abs().sum()) == 0
               for _, t in dequant_attention._buffers.values())
    ref = dequant_attention._paged_plain(q, kq, ks, vq, vs, table, pos,
                                         d ** -0.5)
    assert float((outs[0].float() - ref.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_uncovered_shape_raises_on_card():
    """head_dim 16 is outside the flash kernel's gate: with fusion on, a
    prefill on the card raises instead of running einsum attention; with
    fusion off it runs the plain attention and launches nothing."""
    dev = _cuda_or_skip()
    for fusion in (True, False):
        model = FFModel(FFConfig(max_batch_slots=2, max_decode_len=4,
                                 enable_fusion=fusion))
        build_gpt2(model, GPT2Config(vocab=64, seq=16, d_model=32, heads=2,
                                     layers=1), batch=2)
        eng = compile_serving(model, device=dev)
        params = eng.init(seed=0)
        inputs = gpt2_prompt_inputs(np.ones((2, 16), np.int32),
                                    np.array([5, 3], np.int32))
        before = flash_attention.launches
        if fusion:
            with pytest.raises(ValueError, match="does not cover"):
                eng.prefill(params, inputs)
        else:
            logits, _ = eng.prefill(params, inputs)
            assert bool(torch.isfinite(logits).all())
        assert flash_attention.launches == before


def _rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|): the backward's outputs sum
    hundreds of products, so their scale grows with the sequence."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / max(1.0, float(want.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 200, 64, 1024])
def test_flash_backward_kernels_match_plain_on_card(dtype, tol, causal, d, s):
    """dQ and dK/dV against their plain versions at one row, a ragged
    length (200 is not a multiple of the 64-row tiles), one exact tile and
    the training length, and the autograd Function's gradients against
    `_bwd_plain`, one launch of each kernel per call. bf16 dQ is also held
    element by element to its rounding bound (`_dq_bf16_bound`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v, do = (torch.randn((2, s, 3, d), generator=g, device=dev)
                   .to(dtype).transpose(1, 2) for _ in range(4))
    scale = d ** -0.5
    o, lse = flash_attention._fwd(q, k, v, causal, scale)
    delta = flash_attention._delta(o, do).contiguous()
    n_dq, n_dkv = flash_attention.launches_dq, flash_attention.launches_dkv
    dq = flash_attention._dq_cuda(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention._dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert (flash_attention.launches_dq, flash_attention.launches_dkv) == \
        (n_dq + 1, n_dkv + 1)
    assert dq.stride() == q.stride() and dk.stride() == k.stride()
    rdq = flash_attention._dq_plain(q, k, v, do, lse, delta, causal, scale)
    rdk, rdv = flash_attention._dkv_plain(q, k, v, do, lse, delta, causal,
                                          scale)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert _rel_err(got, want) <= tol
    if dtype == torch.bfloat16:
        dq_bound = flash_attention._dq_bf16_bound(q, k, v, do, lse, delta,
                                                  causal, scale)
        err = (dq.float() - rdq.float()).abs()
        assert float((err / dq_bound).max()) <= 1.0

    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = flash_attention.flash_attention_qkv(qs, ks, vs, causal=causal)
    grads = torch.autograd.grad(out, (qs, ks, vs), do.transpose(1, 2))
    torch.cuda.synchronize()
    assert (flash_attention.launches_dq, flash_attention.launches_dkv) == \
        (n_dq + 2, n_dkv + 2)
    ref = flash_attention._bwd_plain(q, k, v, o, lse, do, causal, scale)
    for got, want in zip(grads, ref):
        assert _rel_err(got.transpose(1, 2), want) <= tol
    if dtype == torch.bfloat16:
        err = (grads[0].transpose(1, 2).float() - ref[0].float()).abs()
        assert float((err / dq_bound).max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fused_adam_kernel_matches_plain_on_card(state_dtype, wd):
    """Three steps of the one-launch Adam kernel against its plain version
    over leaves of ragged sizes, one of them misaligned (the kernel's
    scalar path), and a replaced param that must rebuild the table."""
    from flexflow_tpu_torch import AdamOptimizer
    from flexflow_tpu_torch.kernels import fused_optim

    dev = _cuda_or_skip()
    rng = np.random.default_rng(6)
    sizes = [(1,), (1001,), (64, 65), (3, 40000)]
    base = {f"l{i}": {"w": torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev)}
        for i, s in enumerate(sizes)}
    buf = torch.zeros(5001, device=dev)
    base["odd"] = {"w": buf[1:]}   # 4 bytes past an aligned address
    base["odd"]["w"].copy_(torch.from_numpy(
        rng.standard_normal(5000).astype(np.float32)))
    opt = AdamOptimizer(alpha=1e-2, weight_decay=wd, state_dtype=state_dtype)
    plan = fused_optim.plan_for(opt)
    trees = []
    for _ in range(2):
        params = {l: {w: t.clone() for w, t in ws.items()}
                  for l, ws in base.items()}
        params["odd"]["w"] = torch.zeros(5001, device=dev)[1:]
        params["odd"]["w"].copy_(base["odd"]["w"])
        trees.append((params, opt.init_state(params)))
    (pk, sk), (pp, sp) = trees
    for step in range(3):
        grads = {l: {"w": torch.from_numpy(rng.standard_normal(
            tuple(t.shape)).astype(np.float32)).to(dev)}
            for l, ws in base.items() for t in ws.values()}
        if step == 2:   # a replaced param: new pointer, rebuilt table
            pk["l1"]["w"] = pk["l1"]["w"].clone()
        before = fused_optim.launches
        builds = fused_optim.table_builds
        sk = fused_optim.fused_update(plan, grads, sk, pk)
        torch.cuda.synchronize()
        assert fused_optim.launches == before + 1
        # built for the fresh plan and the replaced param, not for new grads
        assert fused_optim.table_builds == builds + (step != 1)
        gs = [grads[l]["w"] for l in pp]
        fused_optim._adam_plain(plan, gs, [sp["mu"][l]["w"] for l in pp],
                                [sp["nu"][l]["w"] for l in pp],
                                [pp[l]["w"] for l in pp], step + 1)
        for l in pp:
            assert float((pk[l]["w"] - pp[l]["w"]).abs().max()) <= 1e-6
            for m in ("mu", "nu"):
                assert float((sk[m][l]["w"].float() - sp[m][l]["w"].float())
                             .abs().max()) <= 1e-6
    assert sk["count"] == 3


def _tiny_train_model(vocab=250, vocab_pad_to=0, **cfg):
    """head_dim 64 and seq 64, inside the flash gate."""
    model = FFModel(FFConfig(batch_size=2, **cfg))
    build_gpt2(model, GPT2Config(vocab=vocab, seq=64, d_model=128, heads=2,
                                 layers=1, dropout=0.0,
                                 vocab_pad_to=vocab_pad_to), batch=2)
    return model


def _batch(vocab):
    rng = np.random.default_rng(7)
    ids = rng.integers(0, vocab, size=(2, 64)).astype(np.int32)
    pos = np.tile(np.arange(64, dtype=np.int32), (2, 1))
    return [ids, pos], rng.integers(0, vocab, size=(2, 64)).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v", [(64, 5120), (8, 384)])
def test_fused_ce_kernels_match_plain_on_card(dtype, n, v):
    """The forward (per-row loss and lse) and the backward (dx in the
    logits' dtype) kernels against their plain versions, a label outside
    the vocab included; the autograd Function launches each kernel once,
    converts int64 labels on the card, and a non-contiguous vocab dim or a
    shape outside the gate raises."""
    from flexflow_tpu_torch.kernels import fused_ce

    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(2)
    x = (torch.randn((n, v), generator=g, device=dev) * 3.0).to(dtype)
    y = torch.randint(0, v, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    y[1] = v                     # matches no column, as in JAX
    f0, b0 = fused_ce.launches_fwd, fused_ce.launches_bwd
    loss, lse = fused_ce._fwd_cuda(x, y)
    gs = torch.tensor(0.7, device=dev)
    dx = fused_ce._bwd_cuda(x, y, lse, gs)
    torch.cuda.synchronize()
    assert (fused_ce.launches_fwd, fused_ce.launches_bwd) == (f0 + 1, b0 + 1)
    rloss, rlse = fused_ce._fwd_plain(x, y)
    torch.testing.assert_close(lse, rlse, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(loss, rloss, rtol=1e-6, atol=1e-6)
    ref = fused_ce._bwd_plain(x, y, lse, gs / n)
    assert dx.dtype == dtype
    # element by element: expf may differ from PyTorch's exp in its last
    # bit, which can move an f32 dx 2 ulps (the product with g/n rounds
    # again) and round a bf16 dx one ulp the other way
    ulps = 2 if dtype == torch.float32 else 1
    assert _ulp_err(dx, ref) <= ulps

    xa = x.clone().requires_grad_()
    out = fused_ce.fused_cross_entropy(xa, y.long())
    (gx,) = torch.autograd.grad(out, (xa,), gs)
    torch.cuda.synchronize()
    assert (fused_ce.launches_fwd, fused_ce.launches_bwd) == (f0 + 2, b0 + 2)
    torch.testing.assert_close(out, loss.mean())
    assert torch.equal(gx, dx)

    # one element past an aligned address: the kernels' scalar path
    xm = torch.empty(n * v + 1, dtype=dtype, device=dev)[1:].view(n, v)
    xm.copy_(x)
    mloss, mlse = fused_ce._fwd_cuda(xm, y)
    mdx = fused_ce._bwd_cuda(xm, y, mlse, gs)
    torch.cuda.synchronize()
    torch.testing.assert_close(mlse, rlse, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(mloss, rloss, rtol=1e-6, atol=1e-6)
    ref = fused_ce._bwd_plain(xm, y, mlse, gs / n)
    assert _ulp_err(mdx, ref) <= ulps
    with pytest.raises(ValueError, match="contiguous"):
        fused_ce._fwd_cuda(torch.empty((v, n), dtype=dtype, device=dev).t(), y)
    with pytest.raises(ValueError, match="do not cover"):
        fused_ce._fwd_cuda(x[:, :v - 1], y)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(lr=0.1), dict(lr=0.1, weight_decay=0.01),
                                dict(lr=0.1, momentum=0.9, weight_decay=0.01),
                                dict(lr=0.1, momentum=0.9, nesterov=True)])
def test_fused_sgd_kernels_match_plain_on_card(kw):
    """Three steps of the one-launch SGD kernel (with a trace or without)
    against its plain version over leaves of ragged sizes, two of them
    misaligned (the scalar path), and a replaced param that must rebuild
    the table: equal to 1e-6 (the same roundings, expected bit for bit).
    A leaf of 83539 elements fills two 32768-element chunks and leaves a
    third of 18003, whose last 3 elements are the scalar tail after its
    16-byte vectors; the leaf 8 bytes past an aligned address spans three
    chunks on the scalar path."""
    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch.kernels import fused_optim

    dev = _cuda_or_skip()
    rng = np.random.default_rng(8)
    sizes = [(1,), (1001,), (64, 65), (3, 40000), (83539,)]
    base = {f"l{i}": {"w": torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev)}
        for i, s in enumerate(sizes)}
    opt = SGDOptimizer(**kw)
    plan = fused_optim.plan_for(opt)
    trees = []
    for _ in range(2):
        params = {l: {w: t.clone() for w, t in ws.items()}
                  for l, ws in base.items()}
        params["odd"] = {"w": torch.zeros(5001, device=dev)[1:]}
        params["odd"]["w"].copy_(torch.arange(5000, device=dev) * 1e-3)
        # 8 bytes past an aligned address, over three chunks
        params["odd8"] = {"w": torch.zeros(70003, device=dev)[2:]}
        params["odd8"]["w"].copy_(torch.arange(70001, device=dev) * 1e-5)
        trees.append((params, opt.init_state(params)))
    (pk, sk), (pp, sp) = trees
    counter = "launches_sgd" if kw.get("momentum") else "launches_sgd_plain"
    for step in range(3):
        grads = {l: {"w": torch.from_numpy(rng.standard_normal(
            tuple(t.shape)).astype(np.float32)).to(dev)}
            for l, ws in pk.items() for t in ws.values()}
        if step == 2:   # a replaced param: new pointer, rebuilt table
            pk["l1"]["w"] = pk["l1"]["w"].clone()
        before = getattr(fused_optim, counter)
        builds = fused_optim.table_builds
        sk = fused_optim.fused_update(plan, grads, sk, pk)
        torch.cuda.synchronize()
        assert getattr(fused_optim, counter) == before + 1
        # built for the fresh plan and the replaced param, not for new grads
        assert fused_optim.table_builds == builds + (step != 1)
        order = list(pp)
        fused_optim._sgd_plain(
            plan, [grads[l]["w"] for l in order],
            [sp["trace"][l]["w"] for l in order] if kw.get("momentum")
            else None, [pp[l]["w"] for l in order])
        for l in order:
            assert float((pk[l]["w"] - pp[l]["w"]).abs().max()) <= 1e-6
            if kw.get("momentum"):
                assert float((sk["trace"][l]["w"] - sp["trace"][l]["w"])
                             .abs().max()) <= 1e-6


@pytest.mark.cuda
def test_padded_vocab_sgd_step_runs_fused_on_card():
    """A vocab padded to a multiple of 128 takes the fused cross-entropy
    kernels under `fused_loss="auto"`, and SGD with momentum (the default
    optimizer's family) the fused SGD kernel: one launch of each per step,
    a finite loss that matches the unfused path's, and `fused_loss="off"`
    with `fused_optimizer="off"` launches neither."""
    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch.kernels import fused_ce, fused_optim

    dev = _cuda_or_skip()
    inputs, label = _batch(250)
    losses = []
    for cfg in (dict(fused_loss="auto"),
                dict(fused_loss="off", fused_optimizer="off")):
        cm = _tiny_train_model(250, 128, **cfg).compile(
            SGDOptimizer(lr=0.1, momentum=0.9), device=dev)
        cm.init(seed=0)
        before = (fused_ce.launches_fwd, fused_ce.launches_bwd,
                  fused_optim.launches_sgd)
        *_, loss, _ = cm.train_step(cm.params, cm.opt_state, cm.state,
                                    inputs, label)
        torch.cuda.synchronize()
        after = (fused_ce.launches_fwd, fused_ce.launches_bwd,
                 fused_optim.launches_sgd)
        fused = cfg["fused_loss"] == "auto"
        assert [a - b for a, b in zip(after, before)] == [int(fused)] * 3
        assert bool(torch.isfinite(loss))
        losses.append(float(loss))
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
