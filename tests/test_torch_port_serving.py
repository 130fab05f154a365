"""The PyTorch port's serving slice against the JAX package, on the CPU.

One small GPT-2 is built in both packages; the JAX engine's weights move
into the port with `params_from_jax`. The serving clones must agree layer
for layer, prefill logits and every teacher-forced decode step must agree
within the stated tolerances, and the two continuous-batching schedulers
must produce identical greedy token streams, for the compute-dtype cache
and for the int8 cache. seq 128 keeps the JAX prefill on its Pallas flash
kernel (interpret mode here); the int8 decode takes the JAX dequant kernel.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.serving import ContinuousBatchingScheduler as JScheduler
from flexflow_tpu.serving import Request as JRequest
from flexflow_tpu.serving import compile_serving as jcompile_serving
from flexflow_tpu.serving import gpt2_prompt_inputs as jprompt_inputs
from flexflow_tpu.serving import gpt2_step_inputs as jstep_inputs
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler, Request,
                                        compile_serving, gpt2_prompt_inputs,
                                        gpt2_step_inputs)

GPT2_KW = dict(vocab=512, seq=128, d_model=128, heads=2, layers=2, dropout=0.1)
SERVE_KW = dict(max_batch_slots=4, kv_page_size=16, max_decode_len=8)
# f32 on both sides; int8 KV may put a K value one quantization step away
# when the two packages' f32 projections straddle a rounding boundary
ATOL = {"auto": 1e-4, "int8": 1e-3}
# 126 + 6 new tokens runs past seq 128: its position ids clamp into wpe
PROMPT_LENS = (5, 17, 40, 126, 3, 64)

# `flexflow_tpu.kernels` re-exports functions under the module names
jflash = importlib.import_module("flexflow_tpu.kernels.flash_attention")
jdequant = importlib.import_module("flexflow_tpu.kernels.dequant_attention")


def _jax_engine(kv_dtype):
    cfg = JFFConfig(mesh_shape={"data": 1}, log_level="warning",
                    kv_cache_dtype=kv_dtype, **SERVE_KW)
    model = JFFModel(cfg)
    jbuild_gpt2(model, JGPT2Config(**GPT2_KW), batch=8)
    eng = jcompile_serving(model)
    eng.init(seed=0)
    return eng


def _port_engine(kv_dtype, jax_params, enable_fusion=True):
    model = FFModel(FFConfig(kv_cache_dtype=kv_dtype,
                             enable_fusion=enable_fusion, **SERVE_KW))
    build_gpt2(model, GPT2Config(**GPT2_KW), batch=8)
    eng = compile_serving(model, device="cpu")
    eng.load_params(params_from_jax(jax.device_get(jax_params)))
    return eng


@pytest.fixture(scope="module")
def jax_kernel_traces():
    """Counts the JAX engine's traces that came back from the Pallas
    kernels (the JAX lowering falls back to einsum when a kernel raises)."""
    calls = {"flash": 0, "dequant": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            calls[key] += 1
            return out
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jflash, "flash_attention_qkv",
                   counted("flash", jflash.flash_attention_qkv))
        mp.setattr(jdequant, "dequant_decode_attention",
                   counted("dequant", jdequant.dequant_decode_attention))
        yield calls


@pytest.fixture(scope="module", params=["auto", "int8"])
def engines(request, jax_kernel_traces):
    jeng = _jax_engine(request.param)
    return request.param, jeng, _port_engine(request.param, jeng.params)


def _seq(eng):
    return int(eng.prefill_model.input_tensors[0].spec.shape[1])


def test_clones_match_layer_for_layer(engines):
    _, jeng, peng = engines
    for jm, pm in ((jeng.prefill_model, peng.prefill_model),
                   (jeng.decode_model, peng.decode_model)):
        assert [l.name for l in pm.layers] == [l.name for l in jm.layers]
        assert [l.op_type.value for l in pm.layers] == \
            [l.op_type.value for l in jm.layers]
        for jl, pl_ in zip(jm.layers, pm.layers):
            assert {w: (s.shape, s.dtype.value)
                    for w, s in pl_.weight_specs.items()} == \
                {w: (s.shape, s.dtype.value)
                 for w, s in jl.weight_specs.items()}, jl.name
            assert [tuple(t.shape) for t in pl_.outputs] == \
                [tuple(t.shape) for t in jl.outputs], jl.name
    assert peng.attn_layers == jeng.attn_layers
    assert peng.kv_spec.pages_per_slot == jeng.kv_spec.pages_per_slot
    assert peng.kv_spec.total_bytes() == jeng.kv_spec.total_bytes()
    assert peng.memory_stats()["actual_kv_cache_bytes"] == \
        peng.kv_spec.total_bytes()


def test_prefill_logits_match(engines):
    kvd, jeng, peng = engines
    rng = np.random.default_rng(1)
    seq, slots = _seq(jeng), jeng.slots
    ids = rng.integers(1, GPT2_KW["vocab"], size=(slots, seq)).astype(np.int32)
    lengths = np.array([seq, 7, 64, 1], np.int32)
    jl, jkv = jeng.prefill(jeng.params, jprompt_inputs(ids, lengths))
    pl_, pkv = peng.prefill(peng.params, gpt2_prompt_inputs(ids, lengths))
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), atol=ATOL["auto"])
    for name in peng.attn_layers:
        for key in ("k", "v"):
            np.testing.assert_allclose(pkv[name][key].numpy(),
                                       np.asarray(jkv[name][key]), atol=1e-5)


def _teacher_forced(eng, toks, prompt_len, prefill, decode_step, step_inputs,
                    as_array):
    """Per-step decode logits of slot 0 along a fixed token stream."""
    slots, seq = eng.slots, _seq(eng)
    ids = np.zeros((slots, seq), np.int32)
    ids[0, :prompt_len] = toks[:prompt_len]
    lengths = np.zeros((slots,), np.int32)
    lengths[0] = prompt_len
    assert eng.kv.admit(0, prompt_len, len(toks) + 2)
    eng.kv.push()
    pre, kv_state = prefill(eng.params, ids, lengths)
    eng.kv.commit_prefill(kv_state, np.arange(slots, dtype=np.int32), lengths)
    out = [np.asarray(pre)[0, prompt_len - 1]]
    state = eng.kv.state
    for t in range(prompt_len, len(toks)):
        step = np.zeros((slots, 1), np.int32)
        step[0, 0] = toks[t]
        logits, state = decode_step(eng.params, state,
                                    step_inputs(as_array(step), state))
        out.append(np.asarray(logits)[0, 0])
    eng.kv.adopt(state)
    eng.kv.sync_after(len(toks) - prompt_len)
    eng.kv.evict(0)
    eng.kv.push()
    return np.stack(out)


def test_teacher_forced_decode_matches(engines):
    kvd, jeng, peng = engines
    toks = np.random.default_rng(2).integers(
        1, GPT2_KW["vocab"], size=20).astype(np.int32)
    j = _teacher_forced(
        jeng, toks, 6,
        lambda p, ids, ln: jeng.prefill(p, jprompt_inputs(ids, ln)),
        jeng.decode_step, jstep_inputs, jnp.asarray)
    p = _teacher_forced(
        peng, toks, 6,
        lambda p, ids, ln: peng.prefill(p, gpt2_prompt_inputs(ids, ln)),
        peng.decode_step, gpt2_step_inputs, torch.from_numpy)
    assert j.shape == p.shape == (15, GPT2_KW["vocab"])
    np.testing.assert_allclose(p, j, atol=ATOL[kvd])


def test_fusion_off_takes_the_einsum_paths(engines):
    """--no-fusion keeps the kernel wrappers off the path (the einsum
    prefill and, for int8, the einsum dequant decode); both paths compute
    the same function."""
    kvd, jeng, peng = engines
    off = _port_engine(kvd, jeng.params, enable_fusion=False)
    toks = np.random.default_rng(4).integers(
        1, GPT2_KW["vocab"], size=12).astype(np.int32)
    walks = [_teacher_forced(
        e, toks, 5,
        lambda p, ids, ln, e=e: e.prefill(p, gpt2_prompt_inputs(ids, ln)),
        e.decode_step, gpt2_step_inputs, torch.from_numpy)
        for e in (peng, off)]
    np.testing.assert_allclose(walks[1], walks[0], atol=ATOL["auto"])


def _requests(cls, extra=()):
    rng = np.random.default_rng(3)
    lens = PROMPT_LENS + tuple(extra)
    return [cls(rid=i, prompt=[int(x) for x in
                               rng.integers(1, GPT2_KW["vocab"], size=n)],
                max_new_tokens=6 + (i % 3))
            for i, n in enumerate(lens)]


def _serve_both(jeng, peng, eos_id=None, extra=()):
    js = JScheduler(jeng, jeng.params, jprompt_inputs, jstep_inputs,
                    eos_id=eos_id, reqtrace=False)
    ps = ContinuousBatchingScheduler(peng, peng.params, gpt2_prompt_inputs,
                                     gpt2_step_inputs, eos_id=eos_id)
    jdone = {r.rid: r.tokens for r in js.run(_requests(JRequest, extra))}
    pdone = {r.rid: r.tokens for r in ps.run(_requests(Request, extra))}
    return js, ps, jdone, pdone


def test_greedy_streams_identical(engines):
    _, jeng, peng = engines
    js, ps, jdone, pdone = _serve_both(jeng, peng)
    assert len(pdone) == len(PROMPT_LENS)
    assert all(len(t) == 6 + (i % 3) for i, t in pdone.items())
    assert pdone == jdone
    assert ps.prefills == js.prefills
    assert ps.decode_steps == js.decode_steps
    # every page went back to the free list
    assert len(peng.kv.free_pages) == peng.kv.capacity_pages()


def test_eos_and_overlong_prompt_match(engines):
    """An EOS finish inside a dispatch window and a prompt longer than the
    prefill window (shed, never truncated) behave as in the JAX engine."""
    _, jeng, peng = engines
    _, _, _, plain = _serve_both(jeng, peng)
    eos = plain[1][2]     # request 1 emits it as its third token
    js, ps, jdone, pdone = _serve_both(jeng, peng, eos_id=eos,
                                       extra=(GPT2_KW["seq"] + 1,))
    assert pdone == jdone
    assert pdone[1][-1] == eos and len(pdone[1]) <= 3
    assert [r.rid for r in ps.shed] == [r.rid for r in js.shed] == \
        [len(PROMPT_LENS)]
    assert ps.shed[0].shed_reason == js.shed[0].shed_reason == \
        "prompt_too_long"
    for key in ("overdecode_tokens", "shed_prompt_too_long"):
        assert ps.stats[key] == js.stats[key], key
    assert ps.decode_steps == js.decode_steps


def test_jax_reference_took_its_kernels(engines, jax_kernel_traces):
    """The comparison is against the Pallas kernels, not the einsum
    fallback: seq 128 at head_dim 64 passes the JAX flash gate, and every
    JAX prefill trace (and int8 decode trace) came back from its kernel."""
    kvd, _, _ = engines
    assert jflash.flash_supported(GPT2_KW["seq"],
                                  GPT2_KW["d_model"] // GPT2_KW["heads"])
    assert jax_kernel_traces["flash"] > 0
    if kvd == "int8":
        assert jax_kernel_traces["dequant"] > 0
