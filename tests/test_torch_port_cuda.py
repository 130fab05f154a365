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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain_on_card(dtype, tol, causal):
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((2, 200, 3, 64), generator=g, device=dev)
               .to(dtype) for _ in range(3))
    before = flash_attention.launches
    out = flash_attention.flash_attention_qkv(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention._fwd_plain(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal, 0.125)[0]
    assert float((out.float() - ref.transpose(1, 2).float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("s", [1, 3])
def test_dequant_kernel_matches_plain_on_card(dtype, tol, s):
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
