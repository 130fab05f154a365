"""The port's serving searches against the JAX package's, on the CPU.

`serving_optimize` prices and searches the prefill and decode clones of
GPT-2 `tiny(seq=128)` (4 slots, pages of 16, 8 new tokens) on the same
machine description in both packages: {"data": 2, "model": 4} of the
"cpu-sim" chip, whose numbers both keep. For both objectives and for
the untiered KV cache and a host tier at `prefetch_ahead` 1 and 2, the
strategies must be identical, the predicted costs within a relative
1e-12 (the same float sums in the same order) and `attn_head_degree`
equal. The strategy cache restores both programs warm with zero DP
expansions under distinct keys (per program, objective and KV
geometry), as JAX's `tests/test_serving.py:215` holds. `_score`'s
objective and the DP's `inference` terms are held to JAX's directly, and
a training search stays as it was.

JAX's serving ring crossover (`tests/test_ring_attention.py:96`) rests on
its flash kernel's VMEM gate, which refuses seq 16384 and charges the
flash-path candidates the logits' trip through HBM; the port's CUDA gate
admits that length and charges nothing: pinned as a divergence (as
`test_flash_gates_diverge` pins it for training), not matched. A decode
attention runs its own paged lowering in both packages and is priced as
no flash in both.
"""

import pytest

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.parallel.machine import MachineSpec as JMachineSpec
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu.search import dp as jdp
from flexflow_tpu.serving import program as jprogram
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.search import dp
from flexflow_tpu_torch.serving import program
from flexflow_tpu_torch.serving.kv_cache import KVCacheSpec

MESH = {"data": 2, "model": 4}
SLOTS, PAGE, NEW = 4, 16, 8
REL = 1e-12


def _close(a, b, rel=REL):
    assert a == pytest.approx(b, rel=rel, abs=0.0), (a, b)


def _machines():
    p = MachineSpec(mesh_axes=dict(MESH), chip="cpu-sim")
    return p, JMachineSpec.from_json(p.to_json())


def _clones(kind, **cfg):
    """The `kind` clone of GPT-2 tiny(seq=128) in both packages:
    (jax model, jax attn layers, port model, port attn layers)."""
    kw = dict(batch_size=8, search_budget=16, **cfg)
    jm, pm = JFFModel(JFFConfig(**kw)), FFModel(FFConfig(**kw))
    jbuild_gpt2(jm, JGPT2Config.tiny(seq=128), batch=8)
    build_gpt2(pm, GPT2Config.tiny(seq=128), batch=8)
    js, ja = jprogram.clone_for_serving(jm, kind, SLOTS)
    ps, pa = program.clone_for_serving(pm, kind, SLOTS)
    return js, ja, ps, pa


def _kv_specs(attn, host_pages=0):
    gc = GPT2Config.tiny(seq=128)
    pps = -(-(gc.seq + NEW) // PAGE)
    kw = dict(layers=len(attn), heads=gc.heads,
              head_dim=gc.d_model // gc.heads, slots=SLOTS,
              pages_per_slot=pps, page_size=PAGE, itemsize=4,
              host_pages=host_pages,
              device_pages=(max(pps, SLOTS * pps - host_pages)
                            if host_pages else 0))
    return KVCacheSpec(**kw), jcm.KVCacheSpec(**kw)


def _same_strategy(ps, js):
    assert set(ps.op_shardings) == set(js.op_shardings)
    for name, sh in ps.op_shardings.items():
        jsh = js.op_shardings[name]
        assert [list(o) for o in sh.outputs] == \
            [list(o) for o in jsh.outputs], name
        assert {w: list(d) for w, d in sh.weights.items()} == \
            {w: list(d) for w, d in jsh.weights.items()}, name
        assert dict(sh.attrs) == dict(jsh.attrs), name
    assert {k: list(v) for k, v in ps.input_shardings.items()} == \
        {k: list(v) for k, v in js.input_shardings.items()}


@pytest.mark.parametrize("objective", ["latency", "throughput"])
@pytest.mark.parametrize("kind,host_pages,ahead", [
    ("prefill", 0, 0), ("decode", 0, 2), ("decode", 24, 1),
    ("decode", 24, 2)])
def test_serving_optimize_matches_jax(kind, host_pages, ahead, objective):
    """Both programs, both objectives, untiered and tiered KV: JAX's
    strategy, its predicted cost within 1e-12 and its head degree."""
    p, j = _machines()
    js, ja, ps, pa = _clones(kind, strategy_cache=False,
                             serve_objective=objective)
    assert pa == ja
    pkv, jkv = _kv_specs(pa, host_pages) if kind == "decode" else (None,
                                                                   None)
    pst = program.serving_optimize(ps, p, kind, pa, pkv,
                                   prefetch_ahead=ahead)
    jst = jprogram.serving_optimize(js, j, kind, ja, jkv,
                                    prefetch_ahead=ahead)
    _same_strategy(pst, jst)
    _close(pst._predicted_cost, jst._predicted_cost)
    assert program.attn_head_degree(pst, pa, p) == \
        jprogram.attn_head_degree(jst, ja, j)


def test_decode_shards_the_heads_and_the_programs_differ():
    """On this machine the decode search shards the heads (the KV pools
    then shard with them) and the two programs search to different
    strategies, in both packages."""
    p, j = _machines()
    out = {}
    for kind in ("prefill", "decode"):
        js, ja, ps, pa = _clones(kind, strategy_cache=False)
        pkv = _kv_specs(pa)[0] if kind == "decode" else None
        out[kind] = (program.serving_optimize(ps, p, kind, pa, pkv,
                                              prefetch_ahead=2), pa)
    dst, pa = out["decode"]
    assert program.attn_head_degree(dst, pa, p) > 1
    assert out["prefill"][0].op_shardings != dst.op_shardings


def test_score_objective_and_inference_terms_match_jax():
    """`_score` under both objectives, under and over the budget; and the
    DP with `inference=True` (no gradient sync, one live copy, no remat)
    gives JAX's cost and memory on a training graph too."""
    for cost, mem, budget in ((2.0, 10, 100.0), (2.0, 150, 100.0),
                              (0.0, 300, 100.0), (3.5, 99, 100.0)):
        for obj in ("latency", "throughput"):
            _close(dp._score(cost, mem, budget, obj),
                   jdp._score(cost, mem, budget, obj))
    p, j = _machines()
    kw = dict(batch_size=8)
    jm, pm = JFFModel(JFFConfig(**kw)), FFModel(FFConfig(**kw))
    jbuild_gpt2(jm, JGPT2Config.tiny(seq=128), batch=8)
    build_gpt2(pm, GPT2Config.tiny(seq=128), batch=8)
    for inference in (False, True):
        r = dp.search_graph(pm, p, beam_width=8, inference=inference,
                            objective="throughput",
                            remat_policies=("none", "full"))
        jr = jdp.search_graph(jm, j, beam_width=8, inference=inference,
                              objective="throughput",
                              remat_policies=("none", "full"))
        _close(r.cost, jr.cost)
        assert r.mem_bytes == jr.mem_bytes
        assert {n: c.name for n, c in r.choices.items()} == \
            {n: c.name for n, c in jr.choices.items()}


def test_training_search_unchanged_by_the_new_defaults():
    """A training search passes neither knob: the defaults (latency,
    training) give what naming them gives, expansion for expansion."""
    p, _ = _machines()
    pm = FFModel(FFConfig(batch_size=8))
    build_gpt2(pm, GPT2Config.tiny(seq=128), batch=8)
    dp.reset_search_stats()
    a = dp.search_graph(pm, p, beam_width=8)
    ea = dp.SEARCH_STATS["expansions"]
    dp.reset_search_stats()
    b = dp.search_graph(pm, p, beam_width=8, objective="latency",
                        inference=False)
    assert dp.SEARCH_STATS["expansions"] == ea
    assert (a.cost, a.mem_bytes) == (b.cost, b.mem_bytes)
    assert {n: c.name for n, c in a.choices.items()} == \
        {n: c.name for n, c in b.choices.items()}


def test_strategy_cache_warm_hit_both_programs(tmp_path):
    """A second search of each program restores it from the cache with
    zero DP expansions; the keys differ per program, per objective and
    per KV geometry, and an untiered key is JAX's opt fingerprint."""
    p, _ = _machines()
    keys = {}
    for objective in ("latency", "throughput"):
        for host_pages in (0, 24):
            for kind in ("prefill", "decode"):
                if kind == "prefill" and host_pages:
                    continue
                _, _, ps, pa = _clones(kind, strategy_cache_dir=str(tmp_path),
                                       serve_objective=objective)
                pkv = _kv_specs(pa, host_pages)[0] \
                    if kind == "decode" else None
                cold = program.serving_optimize(ps, p, kind, pa, pkv,
                                                prefetch_ahead=2)
                assert cold._cache_info["event"] == "store"
                assert cold._cache_info["meta"]["kind"] == kind
                dp.reset_search_stats()
                warm = program.serving_optimize(ps, p, kind, pa, pkv,
                                                prefetch_ahead=2)
                assert dp.SEARCH_STATS["expansions"] == 0
                info = warm._cache_info
                assert info["event"] == "hit"
                assert info["meta"]["kind"] == kind
                assert info["meta"]["objective"] == objective
                _same_strategy(warm, cold)
                keys[kind, objective, host_pages] = info["key"]
    assert len(set(keys.values())) == len(keys)


def test_opt_fingerprint_is_jax_scheme():
    """The opt fingerprint the key hashes: `serve-{kind}-{objective}-{KV
    fingerprint}`, plus `-pf{ahead}` only with a host tier, in both
    packages (read off the cache key each calls)."""
    seen = {}

    def spy(pkg):
        def cache_key(model, machine, cfg, mode, opt_fp=""):
            seen.setdefault(pkg, []).append(opt_fp)
            raise _Stop
        return cache_key

    from flexflow_tpu.search import strategy_cache as jsc
    from flexflow_tpu_torch.search import strategy_cache as sc

    p, j = _machines()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sc, "cache_key", spy("port"))
        mp.setattr(jsc, "cache_key", spy("jax"))
        for host_pages in (0, 24):
            js, ja, ps, pa = _clones("decode")
            pkv, jkv = _kv_specs(pa, host_pages)
            for call in (lambda: program.serving_optimize(
                    ps, p, "decode", pa, pkv, prefetch_ahead=3),
                    lambda: jprogram.serving_optimize(
                        js, j, "decode", ja, jkv, prefetch_ahead=3)):
                with pytest.raises(_Stop):
                    call()
    assert seen["port"] == seen["jax"]
    assert not seen["port"][0].endswith("-pf3")
    assert seen["port"][1].endswith("-pf3")
    assert seen["port"][0].startswith("serve-decode-latency-(")


class _Stop(Exception):
    pass


def _prefill_attention(pkg, cfg_cls, model_cls, seq, machine):
    """The searched prefill layout's attrs of one self-attention at `seq`,
    and the flash-path (data-parallel) candidate of its prefill clone."""
    m = model_cls(cfg_cls(search_budget=16, strategy_cache=False))
    x = m.create_tensor((2, seq, 128), name="x")
    m.multihead_attention(x, x, x, embed_dim=128, num_heads=2, name="attn")
    sm, attn = pkg.clone_for_serving(m, "prefill", 2)
    st = pkg.serving_optimize(sm, machine, "prefill", attn)
    sh = st.op_shardings.get("attn")
    cands = __import__(pkg.__name__.replace("serving.program",
                                            "search.candidates"),
                       fromlist=["x"]).layer_candidates(sm.layers[0],
                                                        machine, {2})
    return (dict(sh.attrs) if sh else {}), cands[0]


def test_ring_crossover_diverges_from_jax_at_the_vmem_gate():
    """JAX's flash VMEM gate refuses seq 16384, so JAX's flash-path prefill
    candidates pay the logits' trip through HBM there (the term JAX's
    ring crossover rests on); the port's CUDA gate admits that length and
    charges nothing. On the H100's numbers both searches still take the
    ring at 16384 (its compute split over the model axis wins alone), and
    at seq 512 neither takes it and the candidates agree."""
    p = MachineSpec(mesh_axes=dict(MESH), chip="h100")
    j = JMachineSpec.from_json(p.to_json())
    ja, jc = _prefill_attention(jprogram, JFFConfig, JFFModel, 16384, j)
    pa, pc = _prefill_attention(program, FFConfig, FFModel, 16384, p)
    assert ja.get("seq_parallel") == pa.get("seq_parallel") == "model"
    assert jc.name == pc.name and not pc.name.startswith("sp_ring")
    assert jc.extra_comm_fwd > 0.0
    assert pc.extra_comm_fwd is None and pc.extra_comm == 0.0
    ja, jc = _prefill_attention(jprogram, JFFConfig, JFFModel, 512, j)
    pa, pc = _prefill_attention(program, FFConfig, FFModel, 512, p)
    assert not ja.get("seq_parallel") and not pa.get("seq_parallel")
    assert jc.extra_comm_fwd is None and pc.extra_comm_fwd is None
