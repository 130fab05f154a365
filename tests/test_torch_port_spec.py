"""The port's speculative serving against the JAX package, on the CPU.

One small GPT-2 is built in both packages, as tests/test_torch_port_serving.py
builds it; the JAX spec engine (compiled at mesh {"data": 1}) is
initialized from seed 0 and its target and draft params move into the
port with `params_from_jax`. For both KV dtypes, K=3 and K=7, and a
self-draft (the target's graph and params: acceptance near 1) and a
random one-layer draft (acceptance near 0), the port's speculative greedy
streams must equal its non-speculative engine's and the JAX spec
engine's bitwise, with the same spec stats, the same page reservations in
both caches and every page back on both free lists. All in f32.
"""

import json

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
from flexflow_tpu_torch.kernels.dequant_attention import MAX_QUERY_ROWS
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler, Request,
                                        compile_serving, gpt2_prompt_inputs,
                                        gpt2_step_inputs)

GPT2_KW = dict(vocab=512, seq=128, d_model=128, heads=2, layers=2, dropout=0.1)
DRAFT_KW = {"self": GPT2_KW,
            "random": dict(GPT2_KW, d_model=64, heads=1, layers=1)}
SERVE_KW = dict(max_batch_slots=4, kv_page_size=16, max_decode_len=8)
# the serving test's tolerances: f32 on both sides; int8 KV may put a K
# value one quantization step away where the two packages' f32
# projections straddle a rounding boundary
ATOL = {"auto": 1e-4, "int8": 1e-3}
# 126 + 8 new tokens + K runs past seq 128 (position ids clamp); 13 + 3
# and 9 + 7 put the first verify window across a page boundary
PROMPT_LENS = (5, 17, 40, 126, 13, 64, 9)
CASES = [(kv, k, d) for kv in ("auto", "int8") for k in (3, 7)
         for d in ("self", "random")]


def _jmodel(kw, kv):
    cfg = JFFConfig(mesh_shape={"data": 1}, log_level="warning",
                    kv_cache_dtype=kv, **SERVE_KW)
    m = JFFModel(cfg)
    jbuild_gpt2(m, JGPT2Config(**kw), batch=8)
    return m


def _pmodel(kw, kv, **cfg):
    m = FFModel(FFConfig(kv_cache_dtype=kv, **SERVE_KW, **cfg))
    build_gpt2(m, GPT2Config(**kw), batch=8)
    return m


def _to_port(tree):
    return params_from_jax(jax.device_get(tree))


def _requests(cls, lens=PROMPT_LENS, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=[int(x) for x in
                               rng.integers(1, GPT2_KW["vocab"], size=n)],
                max_new_tokens=6 + (i % 3))
            for i, n in enumerate(lens)]


def _spy_admits(kv):
    """Record every (slot, prompt_len, total_tokens, pages) admission."""
    calls = []
    admit = kv.admit

    def spy(slot, prompt_len, total_tokens):
        calls.append((slot, prompt_len, total_tokens,
                      kv.pages_needed(total_tokens)))
        return admit(slot, prompt_len, total_tokens)
    kv.admit = spy
    return calls


def _serve(eng, sched_cls, req_cls, prompt_fn, step_fn, eos_id=None,
           lens=PROMPT_LENS, **kw):
    admits = {"target": _spy_admits(eng.kv)}
    if eng.draft is not None:
        admits["draft"] = _spy_admits(eng.draft.kv)
    sched = sched_cls(eng, eng.params, prompt_fn, step_fn, eos_id=eos_id,
                      **kw)
    done = sched.run(_requests(req_cls, lens))
    for kv in (eng.kv,) + ((eng.draft.kv,) if eng.draft else ()):
        del kv.admit
    return {r.rid: list(r.tokens) for r in done}, sched, admits


def _jserve(eng, eos_id=None, lens=PROMPT_LENS):
    return _serve(eng, JScheduler, JRequest, jprompt_inputs, jstep_inputs,
                  eos_id, lens, reqtrace=False)


def _pserve(eng, eos_id=None, lens=PROMPT_LENS):
    return _serve(eng, ContinuousBatchingScheduler, Request,
                  gpt2_prompt_inputs, gpt2_step_inputs, eos_id, lens)


@pytest.fixture(scope="module")
def engines():
    """(kv, K, draft) -> (JAX spec engine, port spec engine, port plain
    engine), each compiled once for the module."""
    built = {}

    def get(kv, k, draft):
        key = (kv, k, draft)
        if key not in built:
            jeng = jcompile_serving(_jmodel(GPT2_KW, kv),
                                    draft=_jmodel(DRAFT_KW[draft], kv),
                                    spec_tokens=k)
            jeng.init(seed=0)
            if draft == "self":
                jeng.draft.load_params(jeng.params)
            else:
                jeng.draft.init(seed=7)
            peng = compile_serving(_pmodel(GPT2_KW, kv),
                                   draft=_pmodel(DRAFT_KW[draft], kv),
                                   spec_tokens=k, device="cpu")
            peng.load_params(_to_port(jeng.params))
            peng.draft.load_params(_to_port(jeng.draft.params))
            plain = compile_serving(_pmodel(GPT2_KW, kv), device="cpu")
            plain.load_params(_to_port(jeng.params))
            built[key] = (jeng, peng, plain)
        return built[key]
    return get


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: "-".join(map(str, c)))
def served(request, engines):
    """Each case served once by the three engines on one trace."""
    jeng, peng, plain = engines(*request.param)
    return (request.param, jeng, peng, plain, _jserve(jeng), _pserve(peng),
            _pserve(plain))


def test_spec_streams_bitwise(served):
    (kv, k, draft), _, _, _, (jdone, js, _), (pdone, ps, _), \
        (want, _, _) = served
    assert len(want) == len(PROMPT_LENS)
    assert pdone == want
    assert pdone == jdone
    rate = ps.stats["spec_accepted_tokens"] / ps.stats["spec_drafted_tokens"]
    assert rate > 0.9 if draft == "self" else rate < 0.5, (rate, ps.stats)


def test_spec_stats_match_jax(served):
    _, _, _, _, (_, js, _), (_, ps, _), _ = served
    for key in ("spec_rounds", "spec_drafted_tokens", "spec_accepted_tokens",
                "overdecode_tokens"):
        assert ps.stats[key] == js.stats[key], key
    assert ps.stats["spec_rounds"] > 0
    assert (ps.prefills, ps.decode_steps, ps.materializations) == \
        (js.prefills, js.decode_steps, js.materializations)
    assert ps._accept_ema == pytest.approx(js._accept_ema, abs=1e-12)


def test_page_reservation_matches_jax(served):
    """Both caches reserve prompt + max_new + dispatch_ahead + K tokens per
    admission, as the JAX scheduler does."""
    (_, k, _), _, _, _, (_, _, jadm), (_, ps, padm), _ = served
    assert padm == jadm
    reqs = {r.rid: r for r in ps.completed}
    want = sorted(len(r.prompt) + r.max_new_tokens + ps.dispatch_ahead + k
                  for r in reqs.values())
    assert sorted(c[2] for c in padm["target"]) == want
    assert padm["draft"] == padm["target"]


def test_pages_conserved_in_both_caches(served):
    _, _, peng, _, _, _, _ = served
    for kv in (peng.kv, peng.draft.kv):
        assert sorted(kv.free_pages) == list(range(1, kv.capacity_pages() + 1))
        assert not kv._slot_pages and not kv._active.any()


def test_verify_window_stays_in_owned_pages(engines):
    """At every verify pass, positions pos..pos+K of each active slot map to
    pages that slot owns (the +K reservation), including windows that
    cross a page boundary; the streams still equal plain decode."""
    for k in (3, 7):
        _, peng, plain = engines("int8", k, "random")
        kv, page = peng.kv, peng.kv_spec.page_size
        verify, checked = peng.verify_step, []

        def watched(params, state, inputs):
            for slot in np.nonzero(kv._active)[0]:
                first, end = kv._pos[slot], kv._pos[slot] + k
                owned = set(kv._slot_pages[int(slot)])
                pages = {int(kv._table[slot, t // page])
                         for t in range(first, end + 1)}
                assert pages <= owned, (slot, first, end)
                checked.append(first // page != end // page)
            return verify(params, state, inputs)
        peng.verify_step = watched
        try:
            got, _, _ = _pserve(peng)
        finally:
            del peng.verify_step
        want, _, _ = _pserve(plain)
        assert got == want
        assert any(checked), "no verify window crossed a page boundary"


def test_verify_logits_match_jax_teacher_forced(engines):
    """The verify program's logits along a fixed token stream, with
    positions rolled back between passes as acceptance does, against JAX's
    `verify_step`."""
    for kv_dtype in ("auto", "int8"):
        jeng, peng, _ = engines(kv_dtype, 3, "random")
        k, slots, seq = 3, jeng.slots, GPT2_KW["seq"]
        toks = np.random.default_rng(5).integers(
            1, GPT2_KW["vocab"], size=40).astype(np.int32)
        prompt = 13  # the first window, positions 13..16, crosses a page
        out = {}
        for name, eng, pin, sin, arr in (
                ("jax", jeng, jprompt_inputs, jstep_inputs, jnp.asarray),
                ("port", peng, gpt2_prompt_inputs, gpt2_step_inputs,
                 torch.from_numpy)):
            ids = np.zeros((slots, seq), np.int32)
            ids[1, :prompt] = toks[:prompt]
            lengths = np.zeros((slots,), np.int32)
            lengths[1] = prompt
            assert eng.kv.admit(1, prompt, len(toks) + 8)
            eng.kv.push()
            _, kv_state = eng.prefill(eng.params, pin(ids, lengths))
            eng.kv.commit_prefill(kv_state, np.arange(slots, dtype=np.int32),
                                  lengths)
            logits, at = [], prompt
            for accepted in (1, k, 2, 0, k):
                ver = np.zeros((slots, k + 1), np.int32)
                ver[1] = toks[at - 1:at + k]
                lg, st = eng.verify_step(eng.params, eng.kv.state,
                                         sin(arr(ver), eng.kv.state))
                logits.append(np.asarray(lg)[1])
                adv = np.zeros((slots,), np.int32)
                adv[1] = accepted + 1
                eng.kv.adopt(st)
                eng.kv.sync_after(0, advances=adv)
                eng.kv.push()
                at += accepted + 1
            eng.kv.evict(1)
            eng.kv.push()
            out[name] = np.stack(logits)
        assert out["port"].shape == (5, k + 1, GPT2_KW["vocab"])
        np.testing.assert_allclose(out["port"], out["jax"],
                                   atol=ATOL[kv_dtype])


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_eos_inside_accepted_window(engines, kv):
    """An EOS inside a fully accepted window (self-draft): the request ends
    at it, the tokens after it count as over-decode, both caches get every
    page back, and the streams and stats equal the plain engine's and
    JAX's."""
    jeng, peng, plain = engines(kv, 3, "self")
    base, _, _ = _pserve(plain)
    # a request's third token, new in its stream: inside its first window
    rid = next(r for r, t in sorted(base.items()) if t[2] not in t[:2])
    eos = base[rid][2]
    jdone, js, _ = _jserve(jeng, eos_id=eos)
    pdone, ps, _ = _pserve(peng, eos_id=eos)
    want, _, _ = _pserve(plain, eos_id=eos)
    assert pdone == want == jdone
    assert pdone[rid][-1] == eos and len(pdone[rid]) == 3
    assert ps.stats["overdecode_tokens"] == js.stats["overdecode_tokens"] > 0
    for cache in (peng.kv, peng.draft.kv):
        assert len(cache.free_pages) == cache.capacity_pages()


def test_draft_from_parse_args(tmp_path):
    """--serve-draft-model spec.json --serve-spec-tokens K through
    parse_args into compile_serving builds the draft the JSON describes,
    layer for layer the JAX package's `_draft_from_spec` graph."""
    from flexflow_tpu.serving.engine import \
        _draft_from_spec as jdraft_from_spec

    spec = tmp_path / "draft.json"
    spec.write_text(json.dumps(dict(vocab=512, seq=128, d_model=64, heads=1,
                                    layers=1, dropout=0.0)))
    argv = ["--serve-draft-model", str(spec), "--serve-spec-tokens", "3",
            "--max-batch-slots", "4", "--max-decode-len", "8",
            "--kv-cache-dtype", "int8"]
    cfg = FFConfig.parse_args(argv)
    assert (cfg.serve_draft_model, cfg.serve_spec_tokens) == (str(spec), 3)
    model = FFModel(cfg)
    build_gpt2(model, GPT2Config(**GPT2_KW), batch=8)
    eng = compile_serving(model, device="cpu")
    assert eng.spec_tokens == 3 and eng.draft is not None
    assert eng.draft.kv_quantized and eng.draft.slots == 4
    assert eng.draft.kv_spec.heads == 1 and eng.draft.kv_spec.layers == 1
    assert eng.draft.kv_spec.pages_per_slot == eng.kv_spec.pages_per_slot
    assert tuple(eng.verify_model.input_tensors[0].spec.shape) == (4, 4)
    jm = jdraft_from_spec(JFFConfig(mesh_shape={"data": 1}), str(spec), 8)
    assert [(l.name, {w: s.shape for w, s in l.weight_specs.items()})
            for l in eng.draft.model.layers] == \
        [(l.name, {w: s.shape for w, s in l.weight_specs.items()})
         for l in jm.layers]
    assert FFConfig.parse_args([]).serve_spec_tokens == 0


def test_verify_without_draft_raises():
    eng = compile_serving(_pmodel(GPT2_KW, "auto"), device="cpu")
    with pytest.raises(RuntimeError, match="draft"):
        eng.verify_step(eng.params, eng.kv.state, [])
    with pytest.raises(RuntimeError, match="draft"):
        eng.build_spec_program(gpt2_step_inputs)
    assert eng.spec_tokens == 0 and eng.draft is None


def test_draft_seq_mismatch_raises():
    bad = dict(DRAFT_KW["random"], seq=64)
    with pytest.raises(ValueError, match="seq"):
        compile_serving(_pmodel(GPT2_KW, "auto"), draft=_pmodel(bad, "auto"),
                        spec_tokens=2, device="cpu")


def test_int8_fused_verify_past_the_kernel_gate_raises():
    """K+1 = 9 query rows are past the dequant kernel's gate: with an int8
    cache and fusion on, compile_serving refuses at compile time; K=7
    compiles, and so does K=8 where the kernel is not on the path."""
    assert MAX_QUERY_ROWS == 8
    with pytest.raises(ValueError, match="MAX_QUERY_ROWS"):
        compile_serving(_pmodel(GPT2_KW, "int8"),
                        draft=_pmodel(DRAFT_KW["random"], "int8"),
                        spec_tokens=8, device="cpu")
    assert compile_serving(_pmodel(GPT2_KW, "int8"),
                           draft=_pmodel(DRAFT_KW["random"], "int8"),
                           spec_tokens=7, device="cpu").spec_tokens == 7
    for kv, fusion in (("auto", True), ("int8", False)):
        eng = compile_serving(
            _pmodel(GPT2_KW, kv, enable_fusion=fusion),
            draft=_pmodel(DRAFT_KW["random"], kv, enable_fusion=fusion),
            spec_tokens=8, device="cpu")
        assert eng.spec_tokens == 8
