"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points (serving and training) refuse to fall back to the CPU
quietly, its attention takes the kernel wrappers whenever fusion is on (no
shape decides it behind the wrapper's back), and its kernel wrappers count
no launch when they run their plain versions."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import flexflow_tpu_torch
from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.compiler.compile import CompiledModel, compile_model
from flexflow_tpu_torch.kernels import (dequant_attention, flash_attention,
                                        fused_ce, fused_optim)
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.ops import attention_ops
from flexflow_tpu_torch.serving import (KVCacheSpec, PagedKVCache,
                                        compile_serving, gpt2_prompt_inputs,
                                        gpt2_step_inputs)

PKG = pathlib.Path(flexflow_tpu_torch.__file__).parent
REPO = PKG.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import flexflow_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "flexflow_tpu" or m.startswith("flexflow_tpu."))
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 25
    assert bad == "[]"


def test_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import jax|from jax)|\bflexflow_tpu\.|"
                     r"from flexflow_tpu import", re.M)
    hits = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
            for p in sorted(PKG.rglob("*.py"))
            for m in pat.finditer(p.read_text())]
    assert hits == []


def _tiny_model(**cfg):
    model = FFModel(FFConfig(max_batch_slots=2, max_decode_len=4, **cfg))
    build_gpt2(model, GPT2Config(vocab=64, seq=16, d_model=32, heads=2,
                                 layers=1), batch=2)
    return model


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_serving(_tiny_model())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_serving(_tiny_model(), device="cuda")
    eng = compile_serving(_tiny_model(), device="cpu")
    assert eng.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in eng.kv.state.values()
               if isinstance(t, torch.Tensor))


def test_training_entry_points_raise_without_cuda(monkeypatch):
    """FFModel.compile, compile_model and CompiledModel run on the GPU
    unless the caller passes device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _tiny_model().compile(AdamOptimizer(), device=dev)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compile_model(_tiny_model(), AdamOptimizer(),
                          "sparse_categorical_crossentropy", device=dev)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            m = _tiny_model()
            CompiledModel(m, AdamOptimizer(), "sparse_categorical_crossentropy",
                          [], m.layers[-1].outputs, device=dev)
    cm = _tiny_model().compile(AdamOptimizer(), device="cpu")
    params = cm.init(seed=0)
    assert cm.device.type == "cpu"
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for ws in params.values() for t in ws.values())


def test_cpu_wrappers_count_no_launch():
    q = torch.randn(1, 32, 2, 64)
    kq = torch.zeros((1, 32, 2, 64), dtype=torch.int8)
    ks = torch.ones((1, 32, 2))
    pos = torch.tensor([5], dtype=torch.int32)
    f0, d0 = flash_attention.launches, dequant_attention.launches
    flash_attention.flash_attention_qkv(q, q, q, causal=True)
    dequant_attention.dequant_decode_attention(q[:, :1], kq, ks, kq, ks, pos)
    assert (flash_attention.launches, dequant_attention.launches) == (f0, d0)
    assert (f0, d0) == (0, 0)


def test_cpu_training_wrappers_count_no_launch():
    """The fused cross-entropy (forward and backward) and the fused Adam
    and SGD updates on CPU tensors run their plain versions and count no
    launch."""
    x = torch.randn(8, 128, requires_grad=True)
    fused_ce.fused_cross_entropy(x, torch.zeros(8, dtype=torch.int32)).backward()
    assert x.grad is not None
    p = {"a": {"w": torch.randn(40)}}
    for opt in (SGDOptimizer(lr=0.1), SGDOptimizer(lr=0.1, momentum=0.9),
                AdamOptimizer()):
        fused_optim.fused_update(fused_optim.plan_for(opt), p,
                                 opt.init_state(p), p)
    assert (fused_ce.launches_fwd, fused_ce.launches_bwd, fused_optim.launches,
            fused_optim.launches_sgd, fused_optim.launches_sgd_plain) == \
        (0, 0, 0, 0, 0)


def test_kv_cache_needs_a_device():
    spec = KVCacheSpec(layers=1, heads=2, head_dim=16, slots=2,
                       pages_per_slot=2, page_size=16)
    with pytest.raises(TypeError):
        PagedKVCache(spec, ["attn"])
    assert PagedKVCache(spec, ["attn"], device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("fusion", [True, False])
def test_fusion_alone_picks_the_attention_route(monkeypatch, kv_dtype, fusion):
    """head_dim 16 is outside both kernels' gates, yet with fusion on the
    prefill goes to the flash wrapper and the int8 decode to the paged
    dequant wrapper (on a CUDA tensor they would raise, not turn to
    einsum); with fusion off neither wrapper is called."""
    calls = {"flash": 0, "dequant": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(attention_ops, "flash_attention_qkv",
                        counted("flash", attention_ops.flash_attention_qkv))
    monkeypatch.setattr(attention_ops, "paged_dequant_decode_attention",
                        counted("dequant",
                                attention_ops.paged_dequant_decode_attention))
    eng = compile_serving(_tiny_model(enable_fusion=fusion,
                                      kv_cache_dtype=kv_dtype), device="cpu")
    params = eng.init(seed=0)
    ids = np.ones((2, 16), np.int32)
    lengths = np.array([5, 3], np.int32)
    eng.kv.admit(0, 5, 9)
    eng.kv.admit(1, 3, 7)
    eng.kv.push()
    _, kv_state = eng.prefill(params, gpt2_prompt_inputs(ids, lengths))
    eng.kv.commit_prefill(kv_state, np.arange(2, dtype=np.int32), lengths)
    state = eng.kv.state
    logits, _ = eng.decode_step(params, state, gpt2_step_inputs(
        torch.ones((2, 1), dtype=torch.int32), state))
    assert bool(torch.isfinite(logits).all())
    assert calls == {"flash": int(fusion),
                     "dequant": int(fusion and kv_dtype == "int8")}


def test_decode_write_indices_computed_once_a_step(monkeypatch):
    """The cache write indices (positions, page ids, offsets) are the same
    in every layer of a decode step: the first attention layer computes
    them, the second reads them from the step's memo."""
    seen = []
    real = attention_ops._decode_index

    def watched(ctx, pt, pos, page, s):
        seen.append(("serve/decode_index", page, s) in ctx.memo)
        return real(ctx, pt, pos, page, s)

    monkeypatch.setattr(attention_ops, "_decode_index", watched)
    model = FFModel(FFConfig(max_batch_slots=2, max_decode_len=4,
                             kv_cache_dtype="int8"))
    build_gpt2(model, GPT2Config(vocab=64, seq=16, d_model=32, heads=2,
                                 layers=2), batch=2)
    eng = compile_serving(model, device="cpu")
    params = eng.init(seed=0)
    eng.kv.admit(0, 5, 9)
    eng.kv.push()
    state = eng.kv.state
    for _ in range(2):
        logits, state = eng.decode_step(params, state, gpt2_step_inputs(
            torch.ones((2, 1), dtype=torch.int32), state))
    assert bool(torch.isfinite(logits).all())
    assert seen == [False, True, False, True]

