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
                                [pp[l]["w"] for l in pp],
                                fused_optim.adam_scalars(plan, step + 1, dev))
        for l in pp:
            assert float((pk[l]["w"] - pp[l]["w"]).abs().max()) <= 1e-6
            for m in ("mu", "nu"):
                assert float((sk[m][l]["w"].float() - sp[m][l]["w"].float())
                             .abs().max()) <= 1e-6
    assert sk["count"] == 3


def _tiny_train_model(vocab=250, vocab_pad_to=0, dropout=0.0, layers=1,
                      **cfg):
    """head_dim 64 and seq 64, inside the flash gate."""
    model = FFModel(FFConfig(batch_size=2, **cfg))
    build_gpt2(model, GPT2Config(vocab=vocab, seq=64, d_model=128, heads=2,
                                 layers=layers, dropout=dropout,
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


@pytest.mark.cuda
def test_dropout_step_on_card():
    """GPT-2 with dropout 0.1 (vocab padded to 128, bf16) on the card:
    every mask of a step keeps within 5 sigma of 90%, the attention takes
    the einsum path (no flash launch), and remat "full" and "dots" give
    the loss of remat off and its gradients bitwise (the same kernels
    recompute the same values from the same masks)."""
    from flexflow_tpu_torch import AdamOptimizer
    from flexflow_tpu_torch import random as ff_random
    from flexflow_tpu_torch.kernels import fused_ce
    from flexflow_tpu_torch.ops.registry import LoweringCtx

    dev = _cuda_or_skip()
    model = _tiny_train_model(250, 128, dropout=0.1, layers=2,
                              compute_dtype="bfloat16")
    cm = model.compile(AdamOptimizer(), device=dev)
    cm.init(seed=0)
    inputs, label = _batch(250)
    key = ff_random.key(3)
    draws = []
    real = LoweringCtx.dropout_mask

    def logged(ctx, layer, shape, keep, device):
        m = real(ctx, layer, shape, keep, device)
        assert m.dtype == torch.bool and m.device.type == "cuda"
        draws.append((m.numel(), float(m.sum())))
        return m

    fwd0, ce0 = flash_attention.launches, fused_ce.launches_fwd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(LoweringCtx, "dropout_mask", logged)
        ref = cm.value_and_grads(cm.params, cm.state, inputs, label, key)
    torch.cuda.synchronize()
    assert len(draws) == 3      # embed_drop and the probs of 2 layers
    for n, kept in draws:
        assert abs(kept - 0.9 * n) <= 5 * (0.09 * n) ** 0.5
    assert flash_attention.launches == fwd0
    assert fused_ce.launches_fwd == ce0 + 1
    for pol in ("full", "dots"):
        cm.forward_fn.remat = {l.name: pol for l in model.layers}
        got = cm.value_and_grads(cm.params, cm.state, inputs, label, key)
        assert float(got[0]) == float(ref[0])
        for l, ws in ref[3].items():
            for w, g in ws.items():
                assert torch.equal(got[3][l][w], g), (pol, l, w)


@pytest.mark.cuda
def test_remat_relaunches_flash_on_card():
    """Remat "full" at dropout 0: the flash forward launches twice per
    layer (the forward and its recompute), dQ and dK/dV once, and the
    gradients equal those of remat off."""
    from flexflow_tpu_torch import AdamOptimizer

    dev = _cuda_or_skip()
    model = _tiny_train_model(250, 128, layers=2, compute_dtype="bfloat16")
    cm = model.compile(AdamOptimizer(), device=dev)
    cm.init(seed=0)
    inputs, label = _batch(250)
    ref = cm.value_and_grads(cm.params, cm.state, inputs, label)
    cm.forward_fn.remat = {l.name: "full" for l in model.layers}
    before = (flash_attention.launches, flash_attention.launches_dq,
              flash_attention.launches_dkv)
    got = cm.value_and_grads(cm.params, cm.state, inputs, label)
    torch.cuda.synchronize()
    after = (flash_attention.launches, flash_attention.launches_dq,
             flash_attention.launches_dkv)
    assert [a - b for a, b in zip(after, before)] == [4, 2, 2]
    assert float(got[0]) == float(ref[0])
    for l, ws in ref[3].items():
        for w, g in ws.items():
            assert torch.equal(got[3][l][w], g), (l, w)


@pytest.mark.cuda
def test_prefetch_to_device_on_a_side_stream():
    """prefetch_to_device on the card yields the plain loader's batches in
    order, as CUDA tensors that a step on the current stream reads
    correctly, and its thread ends after an early break."""
    import threading
    import time

    from flexflow_tpu_torch.runtime.dataloader import (SingleDataLoader,
                                                       prefetch_to_device)

    dev = _cuda_or_skip()
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1000, size=(64, 4096)).astype(np.int32)
    y = rng.standard_normal((64, 16)).astype(np.float32)
    want = list(SingleDataLoader([x], y, 8, seed=2).epoch())
    gen = prefetch_to_device(SingleDataLoader([x], y, 8, seed=2).epoch(),
                             dev, depth=2)
    n = 0
    for (dx, dy), (wx, wy) in zip(gen, want):
        assert dx[0].device.type == "cuda" and dy.device.type == "cuda"
        # read on the consumer's stream, at once
        assert torch.equal((dx[0].long() * 2).cpu(),
                           torch.from_numpy(wx[0]).long() * 2)
        assert torch.equal(dy.cpu(), torch.from_numpy(wy))
        n += 1
    assert n == len(want) == 8
    gen = prefetch_to_device(SingleDataLoader([x], y, 8, seed=2).epoch(), dev)
    next(gen)
    gen.close()
    deadline = time.monotonic() + 20
    while any(t.name == "ff-prefetch" and t.is_alive()
              for t in threading.enumerate()) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not any(t.name == "ff-prefetch" and t.is_alive()
                   for t in threading.enumerate())


@pytest.mark.cuda
def test_detect_and_measured_dense_op_on_card(tmp_path):
    """detect() names an H100 "h100" with the card's own memory, as one
    device; MeasuredCost times a dense op on the card (bf16, CUDA events)
    with positive forward and backward, and its store reloads."""
    from flexflow_tpu_torch.parallel.machine import MachineSpec
    from flexflow_tpu_torch.search.candidates import layer_candidates
    from flexflow_tpu_torch.search.measure import MeasuredCost

    _cuda_or_skip()
    m = MachineSpec.detect()
    assert m.chip == "h100", torch.cuda.get_device_name(0)
    assert m.hbm_bytes == torch.cuda.get_device_properties(0).total_memory
    assert m.mesh_axes == {"data": 1}
    model = FFModel(FFConfig(batch_size=8))
    x = model.create_tensor([8, 1024, 1024], name="x")
    model.dense(x, 4096, activation="gelu", name="up")
    layer = model.layers[0]
    mach = MachineSpec(mesh_axes={"data": 1})
    (cand,) = layer_candidates(layer, mach, {8})
    mc = MeasuredCost(mach, cache_dir=str(tmp_path), device="cuda")
    fwd, bwd = mc.op_times(layer, cand)
    assert fwd > 0 and bwd > 0
    again = MeasuredCost(mach, cache_dir=str(tmp_path), device="cuda")
    assert again.op_times(layer, cand) == (fwd, bwd)


@pytest.mark.cuda
def test_speculative_round_int8_on_card():
    """A two-layer GPT-2 medium-width target with a two-layer GPT-2
    small-width draft, int8 KV, K=4: every round launches the dequant
    decode K x 2 times at 1 row and 2 times at 5 rows, each admission wave
    the flash forward 2 + 2 times; the streams equal the plain engine's
    under chip_smoke's divergence rule (a stream may differ only where a
    fresh prefill puts the two candidates closer than twice the
    teacher-forced decode-verify gap). In f32 (TF32 off) the two programs
    differ by f32 rounding alone, so the rule is sharp: a stale cache read
    would diverge far outside it. (In bf16 at this depth the decode
    program can tie two candidates exactly where the prefill, which
    attends the unquantized K/V, puts them 2 ulps apart: the rule's limit
    for int8, which chip_smoke meets at full depth with its margin.)"""
    from chip_smoke import divergences, verify_gap
    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            Request, gpt2_step_inputs)

    _cuda_or_skip()
    k, new = 4, 16
    target = GPT2Config(d_model=1024, heads=16, layers=2, dropout=0.0)
    draft = GPT2Config(d_model=768, heads=12, layers=2, dropout=0.0)

    def model(g):
        m = FFModel(FFConfig(max_batch_slots=8, max_decode_len=new,
                             kv_cache_dtype="int8"))
        build_gpt2(m, g, batch=8)
        return m
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        plain = compile_serving(model(target))
        params = plain.init(seed=0)
        spec = compile_serving(model(target), draft=model(draft),
                               spec_tokens=k)
        spec.load_params(params)
        spec.draft.init(seed=1)
        rng = np.random.default_rng(0)
        prompts = [[int(t) for t in rng.integers(0, target.vocab, size=n)]
                   for n in rng.integers(32, 300, size=8)]

        def run(eng):
            sched = ContinuousBatchingScheduler(eng, eng.params,
                                                gpt2_prompt_inputs,
                                                gpt2_step_inputs)
            done = sched.run([Request(rid=i, prompt=p, max_new_tokens=new)
                              for i, p in enumerate(prompts)])
            return {r.rid: list(r.tokens) for r in done}, sched

        base, _ = run(plain)
        flash_attention.launches = 0
        dequant_attention.launches_by_rows.clear()
        got, sched = run(spec)
        torch.cuda.synchronize()
        rounds = sched.stats["spec_rounds"]
        assert dequant_attention.launches_by_rows == {1: rounds * k * 2,
                                                      k + 1: rounds * 2}
        assert flash_attention.launches == sched.prefills * 4
        assert sched.materializations == rounds
        assert len(got) == len(prompts)
        gap = verify_gap(spec, params, prompts, [base, got], k)
        bad = [d for d in divergences(spec, params, prompts, base, got, gap)
               if not d["admitted"]]
        assert bad == [], (gap, bad)
        for kv in (spec.kv, spec.draft.kv):
            assert len(kv.free_pages) == kv.capacity_pages()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
def test_flash_non_causal_at_bert_heads_on_card(dtype, tol):
    """BERT-base's attention without the mask, at (2, 512, 12, 64): the
    forward's O (bf16: within its element-wise rounding bound) and lse,
    and dQ and dK/dV (bf16 dQ within `_dq_bf16_bound`), against their
    plain versions, one launch of each kernel per call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v, do = (torch.randn((2, 512, 12, 64), generator=g, device=dev)
                   .to(dtype).transpose(1, 2) for _ in range(4))
    scale = 64 ** -0.5
    n = (flash_attention.launches, flash_attention.launches_dq,
         flash_attention.launches_dkv)
    o, lse = flash_attention._fwd(q, k, v, False, scale)
    delta = flash_attention._delta(o, do).contiguous()
    args = (q, k, v, do, lse, delta, False, scale)
    dq = flash_attention._dq_cuda(*args)
    dk, dv = flash_attention._dkv_cuda(*args)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.launches_dq,
            flash_attention.launches_dkv) == (n[0] + 1, n[1] + 1, n[2] + 1)
    ref, ref_lse = flash_attention._fwd_plain(q, k, v, False, scale)
    err = (o.float() - ref.float()).abs()
    assert float(err.max()) <= tol
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    rdq = flash_attention._dq_plain(*args)
    rdk, rdv = flash_attention._dkv_plain(*args)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert _rel_err(got, want) <= tol
    if dtype == torch.bfloat16:
        bound = _flash_bf16_o_bound(q, k, v, False, scale)
        assert float((err / bound).max()) <= 1.0
        dq_bound = flash_attention._dq_bf16_bound(*args)
        assert float(((dq.float() - rdq.float()).abs() / dq_bound).max()) \
            <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("which,depth", [("resnet50", 2), ("bert", 2)])
def test_model_step_kernels_match_plain_on_card(which, depth):
    """chip_smoke's phase-9 gradient checks: ResNet-50's widths at 2 blocks
    under SGD with momentum and weight decay, BERT-base's at 2 layers with
    dropout 0; one step through the kernels and one through the plain
    versions from the same params, in f32 (TF32 off) and bf16: loss,
    gradients and updated params within 5e's tolerances (ResNet) or
    `GRAD_TOL_RELU` (BERT's relu FFN), and the kernels launched."""
    from chip_smoke import model_grad_check

    _cuda_or_skip()
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = model_grad_check(which, 0, depth)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert set(out) == {"float32", "bfloat16", "launches"}


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 32])
def test_f32_conv_without_tf32_on_card(groups):
    """The conv lowering in f32 on the card with cuDNN's TF32 off, against
    the same lowering in f64 on the CPU: within 1e-5 of the output's
    largest value (TF32's 10-bit mantissa would miss by ~1e-3); grouped at
    ResNeXt's cardinality too."""
    from flexflow_tpu_torch.ops.registry import LoweringCtx, get_op_def

    dev = _cuda_or_skip()
    m = FFModel(FFConfig())
    x = m.create_tensor([4, 128, 28, 28])
    m.conv2d(x, 128, 3, 3, 1, 1, 1, 1, groups=groups)
    layer = m.layers[-1]
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.standard_normal((4, 128, 28, 28)))
    ws = {w: torch.from_numpy(rng.standard_normal(s.shape))
          for w, s in layer.weight_specs.items()}
    lower = get_op_def(layer.op_type).lower
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = lower(layer, [xs.float().to(dev)],
                    {w: t.float().to(dev) for w, t in ws.items()},
                    LoweringCtx(device=dev))[0]
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    want = lower(layer, [xs], ws, LoweringCtx(device=torch.device("cpu")))[0]
    err = float((got.double().cpu() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


# ------------------------------------------- the K-step graph (make_multi_step)
def _graph_pair(opt, dropout, seed=0, n=2):
    """`n` compiles of one 1-layer GPT-2 with the same initial weights and
    the same layer guids (the dropout keys fold them in)."""
    from flexflow_tpu_torch import AdamOptimizer, SGDOptimizer
    from flexflow_tpu_torch.core.layer import Layer
    from flexflow_tpu_torch.core.tensor import Tensor

    dev = _cuda_or_skip()
    make = {"adam": lambda: AdamOptimizer(alpha=1e-3),
            "sgd": lambda: SGDOptimizer(lr=0.05, momentum=0.9)}[opt]
    guids = Layer._next_guid[0], Tensor._next_guid[0]
    cms = []
    for _ in range(n):
        Layer._next_guid[0], Tensor._next_guid[0] = guids
        cm = _tiny_train_model(256, 128, dropout=dropout,
                               compute_dtype="bfloat16").compile(
            make(), "sparse_categorical_crossentropy", [], device=dev)
        cm.init(seed=seed)
        cms.append(cm)
    return cms


def _groups(n, k, vocab=256):
    rng = np.random.default_rng(9)
    ids = rng.integers(0, vocab, size=(n, k, 2, 64)).astype(np.int32)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), ids.shape).copy()
    labels = rng.integers(0, vocab, size=(n, k, 2, 64)).astype(np.int32)
    return [torch.from_numpy(a).cuda() for a in (ids, pos, labels)]


@pytest.mark.cuda
@pytest.mark.parametrize("opt,dropout", [("adam", 0.0), ("sgd", 0.0),
                                         ("adam", 0.1)])
def test_multi_step_graph_equals_eager_steps_on_card(opt, dropout):
    """Two replays of the K-step CUDA graph against 2K eager train steps
    fed the same batches and keys (fold_in(base, i)): losses and params
    bitwise equal where two eager runs are, else within the eager
    run-to-run difference; the kernels' launches are counted once, at the
    capture; a fused-optimizer table is never rebuilt."""
    from flexflow_tpu_torch import random as ff_random
    from flexflow_tpu_torch.compiler import graph_steps
    from flexflow_tpu_torch.kernels import fused_optim

    _cuda_or_skip()
    K = 3
    ids, pos, labels = _groups(2, K)
    base = ff_random.key(5)
    eager, eager2, graph = _graph_pair(opt, dropout, n=3)

    def run_eager(cm):
        means = []
        for d in range(2):
            losses = []
            for i in range(K):
                (cm.params, cm.opt_state, cm.state, loss, _) = cm.train_step(
                    cm.params, cm.opt_state, cm.state,
                    [ids[d, i], pos[d, i]], labels[d, i],
                    ff_random.fold_in(base, d * K + i))
                losses.append(loss)
            s = losses[0]
            for x in losses[1:]:
                s = s + x
            means.append(s / K)
        return means

    means, means2 = run_eager(eager), run_eager(eager2)
    caps = graph_steps.captures
    multi = graph.make_multi_step(K)
    fwd0 = flash_attention.launches
    got = []
    for d in range(2):
        (graph.params, graph.opt_state, graph.state, loss, _) = multi(
            graph.params, graph.opt_state, graph.state,
            [ids[d], pos[d]], labels[d], base, d * K)
        got.append(loss)
        builds = fused_optim.table_builds
    torch.cuda.synchronize()
    assert graph_steps.captures == caps + 1
    # counted at the capture (K steps, the warm-up's one step), not at a
    # replay
    assert flash_attention.launches - fwd0 == (K + 1) * (dropout == 0)
    assert fused_optim.table_builds == builds

    def diff(a, b):
        return max(float((a[l][w] - b[l][w]).abs().max())
                   for l in a for w in a[l])
    run_to_run = diff(eager.params, eager2.params)
    if run_to_run == 0 and all(torch.equal(a, b)
                               for a, b in zip(means, means2)):
        assert diff(eager.params, graph.params) == 0
        assert all(torch.equal(a, b) for a, b in zip(means, got))
    else:
        assert diff(eager.params, graph.params) <= run_to_run
    if opt == "adam":
        assert int(graph.opt_state["count"]) == 2 * K


@pytest.mark.cuda
def test_masks_on_card_equal_the_cpu_masks():
    """The hash of `bernoulli_mask` in int32 on the card gives the CPU's
    bits, from a host key and from a device key."""
    from flexflow_tpu_torch import random as ff_random

    dev = _cuda_or_skip()
    k = ff_random.fold_in(ff_random.key(2), 9)
    want = ff_random.bernoulli_mask(k, (16, 4096), 0.9, "cpu")
    for kk in (k, ff_random.device_key(k, dev)):
        assert torch.equal(
            ff_random.bernoulli_mask(kk, (16, 4096), 0.9, dev).cpu(), want)
    dk = ff_random.fold_in(ff_random.device_key(ff_random.key(2), dev),
                           torch.tensor(9, device=dev))
    assert ff_random.host_key(dk) == k


@pytest.mark.cuda
def test_fit_steps_per_dispatch_on_card():
    """fit with steps_per_dispatch=2 over 5 updates: two graph replays and
    one single step, the step_stats JAX counts, the params of the K=1
    fit."""
    from flexflow_tpu_torch.compiler import graph_steps

    a, b = _graph_pair("adam", 0.1)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 256, size=(10, 64)).astype(np.int32)
    pos = np.tile(np.arange(64, dtype=np.int32), (10, 1))
    y = rng.integers(0, 256, size=(10, 64)).astype(np.int32)
    caps = graph_steps.captures
    ha = a.fit([ids, pos], y, verbose=False, steps_per_dispatch=2)
    hb = b.fit([ids, pos], y, verbose=False, steps_per_dispatch=1)
    assert graph_steps.captures == caps + 1
    assert a.step_stats == {"dispatches": 3, "host_syncs": 0, "barriers": 0,
                            "fused_steps": 4}
    assert np.isfinite(ha[0]["loss"])
    assert all(torch.equal(a.params[l][w], b.params[l][w])
               for l in a.params for w in a.params[l])
    np.testing.assert_allclose(ha[0]["loss"], hb[0]["loss"], rtol=1e-6)


# --------------------------------- run health and attribution on the card
@pytest.mark.cuda
def test_graph_sentinels_equal_eager_steps_on_card():
    """The K-step graph returns the sentinels' grad norm and non-finite
    flag as means over its K steps: those of K eager steps fed the same
    batches and keys (bitwise where the params are); a NaN-poisoned param
    read in place by the replay trips the flag."""
    from flexflow_tpu_torch import health
    from flexflow_tpu_torch import random as ff_random

    _cuda_or_skip()
    K = 3
    ids, pos, labels = _groups(1, K)
    base = ff_random.key(5)
    eager, graph = _graph_pair("adam", 0.0)
    assert eager.cfg.health_sentinels
    *_, emv = eager._run_steps(K, eager.params, eager.opt_state, eager.state,
                               [ids[0], pos[0]], labels[0], base, 0)
    multi = graph.make_multi_step(K)
    (graph.params, graph.opt_state, graph.state, _, gmv) = multi(
        graph.params, graph.opt_state, graph.state, [ids[0], pos[0]],
        labels[0], base, 0)
    torch.cuda.synchronize()
    assert set(gmv) == set(emv) == set(health.SENTINEL_KEYS)
    same = all(torch.equal(eager.params[l][w], graph.params[l][w])
               for l in eager.params for w in eager.params[l])
    for k in health.SENTINEL_KEYS:
        if same:
            assert torch.equal(gmv[k], emv[k]), k
        else:
            torch.testing.assert_close(gmv[k], emv[k], rtol=1e-5, atol=0)
    assert float(gmv[health.NONFINITE_KEY]) == 0.0
    assert float(gmv[health.GRAD_NORM_KEY]) > 0.0
    graph._poison_first_param()
    (graph.params, graph.opt_state, graph.state, _, gmv) = multi(
        graph.params, graph.opt_state, graph.state, [ids[0], pos[0]],
        labels[0], base, K)
    flag = float(gmv[health.NONFINITE_KEY])
    assert flag > 0.0 or flag != flag


@pytest.mark.cuda
def test_device_watermarks_read_memory_stats_on_card():
    from flexflow_tpu_torch import health

    dev = _cuda_or_skip()
    x = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    got = health.device_watermarks((), dev)
    stats = torch.cuda.memory_stats(dev)
    (key, wm), = got.items()
    assert key == str(torch.cuda.current_device())
    assert wm["live"] == stats["allocated_bytes.all.current"] >= x.numel()
    assert wm["peak"] == stats["allocated_bytes.all.peak"] >= wm["live"]
    wt = health.WatermarkTracker()
    wt.sample("t", (), dev)
    assert wt.report(1)["warn"]


@pytest.mark.cuda
def test_trace_credits_a_profiled_step_to_its_layers_on_card(tmp_path):
    """A profiled fit of a 2-layer GPT-2 in bf16: torch.profiler's trace
    credits the flash forward, dQ and dK/dV kernels to the attention
    layers (the backward through the autograd node's sequence number) and
    each MLP layer's backward GEMMs to it; the report's source is the
    trace and it states its coverage."""
    from flexflow_tpu_torch import AdamOptimizer, attribution

    dev = _cuda_or_skip()
    pdir = str(tmp_path / "prof")
    m = _tiny_train_model(256, 128, layers=2, compute_dtype="bfloat16",
                          profiling=True, profile_dir=pdir)
    cm = m.compile(AdamOptimizer(alpha=1e-3),
                   "sparse_categorical_crossentropy", [], device=dev)
    cm.init(seed=0)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 256, size=(8, 64)).astype(np.int32)
    pos = np.tile(np.arange(64, dtype=np.int32), (8, 1))
    y = rng.integers(0, 256, size=(8, 64)).astype(np.int32)
    cm.fit([ids, pos], y, epochs=2, verbose=False)
    rep = cm.op_attribution(source="trace", print_table=False)
    assert rep["source"] == "trace" and 0.5 < rep["coverage"] <= 1.0
    kernels = rep["trace"]["kernels"]
    for layer in ("h0_attn", "h1_attn"):
        names = " ".join(kernels[layer])
        for k in ("flash_fwd_tc_kernel", "flash_dq_tc_kernel",
                  "flash_dkv_tc_kernel"):
            assert k in names, (layer, k, sorted(kernels[layer]))
    assert len(kernels["h0_mlp_up"]) >= 2      # forward and backward GEMMs
    step = rep["step_time_s"]
    assert abs(rep["attributed_total_s"] - step) / step <= \
        attribution.SUM_TOLERANCE


def _tiered_int8_engine(host_pages, seed=0):
    """GPT-2 at medium's head width (64) and 2 layers, int8 KV, 4 slots of
    3 pages of 16 (seq 32, 16 new tokens)."""
    m = FFModel(FFConfig(max_batch_slots=4, max_decode_len=16, kv_page_size=16,
                         kv_cache_dtype="int8", kv_host_pages=host_pages,
                         compute_dtype="bfloat16"))
    build_gpt2(m, GPT2Config(vocab=512, seq=32, d_model=256, heads=4,
                             layers=2, dropout=0.0), batch=4)
    eng = compile_serving(m)
    eng.init(seed=seed)
    return eng


@pytest.mark.cuda
def test_pinned_spill_refill_through_dequant_on_card():
    """A slot spilled to the pinned host tier and refilled into other
    device pages holds its K/V bitwise, and the paged dequant kernel reads
    the refilled pages to the same output as the never-spilled ones; a
    tiered run's streams equal the untiered engine's bitwise."""
    from flexflow_tpu_torch.kernels.dequant_attention import (
        paged_dequant_decode_attention)
    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            Request, gpt2_step_inputs)

    dev = _cuda_or_skip()
    eng = _tiered_int8_engine(host_pages=6)
    kv = eng.kv
    assert kv.spec.pool_pages == 7 and kv._host["h0_attn"]["k"].is_pinned()
    gen = torch.Generator(device=dev).manual_seed(0)
    kv.admit(1, 20, 40)
    kv.push()
    pages = list(kv._slot_pages[1])
    for n in kv.attn_layers:
        for key, leaf in kv.state[n].items():
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen,
                                         device=dev, dtype=torch.int8))
            else:
                leaf.copy_(torch.rand(leaf.shape, generator=gen, device=dev))
    before = {n: {k: v[pages].clone() for k, v in kv.state[n].items()}
              for n in kv.attn_layers}
    q = torch.randn((4, 1, 4, 64), generator=gen, device=dev,
                    dtype=torch.bfloat16)

    def attend():
        st = kv.state["h0_attn"]
        return paged_dequant_decode_attention(
            q, st["k"], st["k_scale"], st["v"], st["v_scale"],
            kv.state["serve/page_table"], kv.state["serve/pos"],
            scale=0.125)[1]
    want = attend()
    kv.spill(1, 0)
    kv.push()
    # another slot takes the freed pages, so the refill lands elsewhere
    kv.admit(0, 30, 40)
    assert kv.prefetch(1, 0) and kv.join(1, 2, 2) is False
    kv.push()
    torch.cuda.synchronize()
    moved = list(kv._slot_pages[1])
    assert set(moved).isdisjoint(pages)
    for n in kv.attn_layers:
        for k, v in kv.state[n].items():
            assert torch.equal(v[moved], before[n][k]), (n, k)
    assert torch.equal(attend(), want)
    kv.evict(0)
    kv.evict(1)
    kv.push()

    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, 512, size=n)]
               for n in rng.integers(8, 32, size=8)]

    def run(e):
        s = ContinuousBatchingScheduler(e, e.params, gpt2_prompt_inputs,
                                        gpt2_step_inputs)
        done = s.run([Request(rid=i, prompt=p, max_new_tokens=16)
                      for i, p in enumerate(prompts)])
        return {r.rid: r.tokens for r in done}, s
    flat = _tiered_int8_engine(host_pages=0)
    before_launches = dequant_attention.launches
    tiered, s = run(eng)
    assert dequant_attention.launches > before_launches
    assert s.stats["kv_spills"] > 0
    assert tiered == run(flat)[0]


@pytest.mark.cuda
def test_refill_adds_no_host_sync_on_card():
    """prefetch, join and the table push make no host sync (torch's sync
    debug mode raises on one); the spill waits once for its copy."""
    dev = _cuda_or_skip()
    eng = _tiered_int8_engine(host_pages=6)
    kv = eng.kv
    kv.admit(2, 20, 40)
    kv.push()
    kv.state["h1_attn"]["v"].fill_(7)
    kv.spill(2, 0)
    assert kv.host_syncs == 1
    torch.cuda.set_sync_debug_mode("error")
    try:
        kv.push()
        assert kv.prefetch(2, 3)
        kv.push()
        assert kv.join(2, 4, 2) is True       # one step of lead: a stall
        kv.push()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    v = kv.state["h1_attn"]["v"][torch.as_tensor(kv._slot_pages[2],
                                                 device=dev)]
    assert bool((v == 7).all())
    assert kv.tier_counters["kv_prefetch_stalls"] == 1


def _fill_random(kv, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    for n in kv.attn_layers:
        for key, leaf in kv.state[n].items():
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen,
                                         device=dev, dtype=torch.int8))
            else:
                leaf.copy_(torch.rand(leaf.shape, generator=gen, device=dev)
                           + 0.5)


@pytest.mark.cuda
def test_export_parked_waits_for_the_spill_on_card():
    """`export_parked` reads host rows the spill's copies have filled: the
    spill waits for them once. A spin queued ahead of the spill holds its
    copies back ~0.5 s; the payload must still be the device rows, not the
    host tier's zeros."""
    dev = _cuda_or_skip()
    kv = _tiered_int8_engine(host_pages=6).kv
    kv.admit(1, 20, 40)
    kv.push()
    _fill_random(kv, dev)
    pages = torch.as_tensor(kv._slot_pages[1], device=dev)
    want = {n: {k: v.index_select(0, pages).cpu()
                for k, v in kv.state[n].items()} for n in kv.attn_layers}
    torch.cuda._sleep(1_000_000_000)
    kv.spill(1, 0)
    payload = kv.export_parked(1)
    assert kv.host_syncs == 1 and payload["pos"] == 20
    for n in kv.attn_layers:
        for k, rows in want[n].items():
            assert torch.equal(payload["layers"][n][k], rows), (n, k)


@pytest.mark.cuda
def test_import_waits_for_a_refill_reading_its_host_pages_on_card():
    """A refill still queued on the card reads host pages that an evict
    gave back; an import that takes those pages writes them only after
    that copy has run: the refilled device pages hold the exported rows,
    not the import's."""
    dev = _cuda_or_skip()
    kv = _tiered_int8_engine(host_pages=6).kv
    for warm in (True, False):
        # the warm pass fills the allocators' caches, so that no
        # allocation in the timed pass synchronizes the device
        kv.admit(1, 20, 40)
        kv.push()
        _fill_random(kv, dev, seed=1)
        kv.spill(1, 0)
        x = kv.export_parked(1)
        host_ids = list(kv._cold[1])
        if not warm:
            torch.cuda._sleep(1_000_000_000)  # the refill's stream waits
        assert kv.prefetch(1, 0)
        dst = list(kv._slot_pages[1])     # (a device tensor now would sync)
        if warm:
            kv.join(1, 4, 2)
            kv.evict(1)
            kv.push()
            torch.cuda.synchronize()
    kv.evict(1)
    y = {"pos": 7, "pages": x["pages"],
         "layers": {n: {k: torch.full_like(t, 3) for k, t in d.items()}
                    for n, d in x["layers"].items()}}
    # the premise: the refill is still queued behind the spin
    assert not kv._host_reads[host_ids[0]].query()
    kv.import_parked(2, y)
    assert sorted(kv._cold[2]) == sorted(host_ids) and kv._pos[2] == 7
    torch.cuda.synchronize()
    dst = torch.as_tensor(dst, device=dev)
    for n in kv.attn_layers:
        for k, rows in x["layers"][n].items():
            assert torch.equal(kv.state[n][k].index_select(0, dst).cpu(),
                               rows), (n, k)
    assert kv.tier_counters["kv_handoffs"] == 1


@pytest.mark.cuda
def test_fleet_colocated_and_disagg_on_card():
    """Two int8 replicas on the card, colocated and disaggregated: the
    streams equal the plain scheduler's on an untiered engine, the dequant
    decode launches once a layer on every decode step of every replica
    (the fleet's lock keeps the global counter exact), and disagg hands
    every request off once."""
    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            Request, ServingFleet,
                                            gpt2_step_inputs)

    _cuda_or_skip()
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, 512, size=n)]
               for n in rng.integers(8, 32, size=8)]

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=16,
                        arrival_s=0.01 * i) for i, p in enumerate(prompts)]
    flat = _tiered_int8_engine(host_pages=0)
    s = ContinuousBatchingScheduler(flat, flat.params, gpt2_prompt_inputs,
                                    gpt2_step_inputs)
    want = {r.rid: r.tokens for r in s.run(reqs())}
    engines = [_tiered_int8_engine(host_pages=6) for _ in range(2)]
    for topo in ("colocated", "disagg"):
        fleet = ServingFleet(engines, gpt2_prompt_inputs, gpt2_step_inputs,
                             topology=topo)
        before = (dequant_attention.launches, flash_attention.launches)
        done = fleet.serve(reqs())
        assert {r.rid: r.tokens for r in done} == want, topo
        steps = sum(h.sched.decode_steps for h in fleet.replicas)
        prefills = sum(h.sched.prefills for h in fleet.replicas)
        assert dequant_attention.launches - before[0] == 2 * steps, topo
        assert flash_attention.launches - before[1] == 2 * prefills, topo
        assert fleet.stats["handoffs"] == (8 if topo == "disagg" else 0)


# ------------------------------------------------ MoE and fork-join (item 6)
def _moe_cm(dev, seed=0):
    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch.core.layer import Layer
    from flexflow_tpu_torch.core.tensor import Tensor
    from flexflow_tpu_torch.models import build_moe_mlp

    Layer._next_guid[0], Tensor._next_guid[0] = 100, 1000
    m = FFModel(FFConfig(compute_dtype="bfloat16"))
    build_moe_mlp(m, batch=64, in_dim=784, num_exp=64, num_select=2,
                  hidden=64, alpha=1.0)
    cm = m.compile(SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy",
                   [], device=dev)
    cm.init(seed=seed)
    return cm


def _moe_data(n=1):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(n, 64, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, 64)).astype(np.int32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


@pytest.mark.cuda
def test_moe_backward_is_bitwise_repeatable_on_card():
    """MoE-MLP at its widths, alpha 1 (choices overflow): two backward
    passes from the same params give bitwise equal gradients (a dropped
    pair adds an exact zero to its buffer row; every row takes at most one
    nonzero term), and the overflowed choices' positions are -1."""
    from flexflow_tpu_torch.ops.registry import LoweringCtx, get_op_def

    dev = _cuda_or_skip()
    cm = _moe_cm(dev)
    x, y = _moe_data()
    grads = [cm.value_and_grads(cm.params, cm.state, [x[0]], y[0])[3]
             for _ in range(2)]
    for l, ws in grads[0].items():
        for w, g in ws.items():
            assert torch.isfinite(g).all(), f"{l}.{w}"
            assert torch.equal(g, grads[1][l][w]), f"{l}.{w}"
    gb = next(l for l in cm.model.layers if l.op_type.value == "group_by")
    assign = torch.randint(0, 4, (64, 2), device=dev, dtype=torch.int32)
    _, pos = get_op_def(gb.op_type).lower(
        gb, [x[0, :, :64].bfloat16(), assign], {}, LoweringCtx())
    assert pos.dtype == torch.int32 and (pos == -1).any()
    assert ((pos >= 0) & (pos < gb.params["capacity"]) | (pos == -1)).all()


@pytest.mark.cuda
def test_fork_join_batch_norm_branches_train_on_card():
    """A fork-join of three congruent branches, each with a batch norm
    named "bn", trains on the card: its running stats live under JAX's
    keys ("bn/mean", "bn/var": one key for all branches), f32, finite and
    moved; its gamma and beta stay f32 master weights in a bf16 compile."""
    from flexflow_tpu_torch import AdamOptimizer

    dev = _cuda_or_skip()
    m = FFModel(FFConfig(compute_dtype="bfloat16"))
    x = m.create_tensor([64, 32], name="x")

    def branch(act):
        def b(bm, t):
            h = bm.dense(t, 128, activation=act, name="mid")
            h = bm.batch_norm(h, relu=False, name="bn")
            return bm.dense(h, 32, name="out")
        return b
    t = m.fork_join(x, [branch(a) for a in ("relu", "tanh", "gelu")],
                    name="fj")
    m.dense(t, 10, name="head")
    cm = m.compile(AdamOptimizer(alpha=1e-3),
                   "sparse_categorical_crossentropy", [], device=dev)
    cm.init(seed=0)
    assert cm.params["fj"]["stk.bn.gamma"].dtype == torch.float32
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32)).cuda()
    ys = torch.from_numpy(rng.integers(0, 10, size=64).astype(np.int32)).cuda()
    losses = []
    for _ in range(5):
        cm.params, cm.opt_state, cm.state, loss, _ = cm.train_step(
            cm.params, cm.opt_state, cm.state, [xs], ys)
        losses.append(float(loss))
    assert sorted(cm.state) == ["bn/mean", "bn/var"]
    for v in cm.state.values():
        assert v.dtype == torch.float32 and torch.isfinite(v).all()
    assert float(cm.state["bn/mean"].abs().max()) > 0
    assert float((cm.state["bn/var"] - 1).abs().max()) > 0
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.cuda
def test_moe_mlp_k_step_graph_on_card():
    """make_multi_step(4) of MoE-MLP captures (no host read in the MoE
    ops) and its two replays equal 8 eager steps bitwise; the fused SGD
    kernel is counted at the capture (K steps and the warm-up's one)."""
    from flexflow_tpu_torch import random as ff_random
    from flexflow_tpu_torch.compiler import graph_steps
    from flexflow_tpu_torch.kernels import fused_optim

    dev = _cuda_or_skip()
    K = 4
    x, y = _moe_data(2 * K)
    x, y = x.reshape(2, K, 64, 784), y.reshape(2, K, 64)
    base = ff_random.key(5)
    eager = _moe_cm(dev)
    means = []
    for d in range(2):
        s = 0.0
        for i in range(K):
            (eager.params, eager.opt_state, eager.state, loss, _) = \
                eager.train_step(eager.params, eager.opt_state, eager.state,
                                 [x[d, i]], y[d, i],
                                 ff_random.fold_in(base, d * K + i))
            s = s + loss
        means.append(s / K)
    graph = _moe_cm(dev)
    caps, n0 = graph_steps.captures, fused_optim.launches_sgd_plain
    multi = graph.make_multi_step(K)
    got = []
    for d in range(2):
        (graph.params, graph.opt_state, graph.state, loss, _) = multi(
            graph.params, graph.opt_state, graph.state, [x[d]], y[d], base,
            d * K)
        got.append(loss)
    torch.cuda.synchronize()
    assert graph_steps.captures == caps + 1
    assert fused_optim.launches_sgd_plain - n0 == K + 1
    for l, ws in eager.params.items():
        for w, p in ws.items():
            assert torch.equal(p, graph.params[l][w]), f"{l}.{w}"
    assert all(torch.equal(a, b) for a, b in zip(means, got))
