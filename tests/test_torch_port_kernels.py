"""The port's attention kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as the JAX package's own tests run
them. Inputs come from numpy with a fixed seed and go to both packages.
The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_port_cuda.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.serving.kv_cache import kv_quantize as jkv_quantize
from flexflow_tpu_torch.kernels import dequant_attention, flash_attention
from flexflow_tpu_torch.serving.kv_cache import kv_dequantize, kv_quantize

# `flexflow_tpu.kernels` re-exports functions under the module names
jflash = importlib.import_module("flexflow_tpu.kernels.flash_attention")
jdequant = importlib.import_module("flexflow_tpu.kernels.dequant_attention")

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


def test_gates():
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
    assert not dequant_attention.dequant_supported(1, 10 ** 6, 64,
                                                   torch.float32)


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
