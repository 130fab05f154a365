"""The port's tiered KV cache (a host cold tier beside a smaller device
pool) against the JAX package's, on the CPU.

One small GPT-2 (the shapes of tests/test_kv_tiering.py: vocab 256, seq
16, d 64, 4 heads, 1 layer, 4 slots of 6 pages of 4) is served in both
packages with the JAX engine's weights carried into the port, untiered and
with 12 of the 24 data pages moved to the host, in both KV dtypes. The
streams must be bitwise equal across all four runs, and the tier's
counters, stats and parked/rejoined event sequence equal to JAX's. The
cache's own operations (churn, round trip, backpressure, admission
capacity) run side by side on both packages' caches. The scheduler's
`dispatch_ahead` (a constructor argument in both packages) gives JAX's
streams, host syncs and stats at 1, 2 and 4.
"""

import jax
import numpy as np
import pytest

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import telemetry as jtel
from flexflow_tpu.health import format_kv_tier as jformat_kv_tier
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.search.cost_model import KVCacheSpec as JKVCacheSpec
from flexflow_tpu.serving import ContinuousBatchingScheduler as JScheduler
from flexflow_tpu.serving import Request as JRequest
from flexflow_tpu.serving import compile_serving as jcompile_serving
from flexflow_tpu.serving import gpt2_prompt_inputs as jprompt_inputs
from flexflow_tpu.serving import gpt2_step_inputs as jstep_inputs
from flexflow_tpu.serving.kv_cache import PagedKVCache as JPagedKVCache
from flexflow_tpu.serving.kv_cache import \
    derive_prefetch_ahead as jderive_prefetch_ahead
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.health import format_kv_tier
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                        KVCacheSpec, PagedKVCache, Request,
                                        compile_serving, gpt2_prompt_inputs,
                                        gpt2_step_inputs)
from flexflow_tpu_torch.serving.kv_cache import (derive_prefetch_ahead,
                                                 learned_kv_transfer_seconds)

GPT2_KW = dict(vocab=256, seq=16, d_model=64, heads=4, layers=1, dropout=0.0)
SERVE_KW = dict(max_batch_slots=4, kv_page_size=4, max_decode_len=6,
                kv_prefetch_ahead=2)
HOST_PAGES = 12
KV_DTYPES = ("auto", "int8")


def _jax_engine(kvd, host_pages, params=None):
    m = JFFModel(JFFConfig(mesh_shape={"data": 1}, log_level="warning",
                           kv_cache_dtype=kvd, kv_host_pages=host_pages,
                           **SERVE_KW))
    jbuild_gpt2(m, JGPT2Config(**GPT2_KW), batch=8)
    eng = jcompile_serving(m)
    if params is None:
        eng.init(seed=0)
    else:
        eng.load_params(params)
    return eng


def _port_engine(kvd, host_pages, jparams):
    m = FFModel(FFConfig(kv_cache_dtype=kvd, kv_host_pages=host_pages,
                         **SERVE_KW))
    build_gpt2(m, GPT2Config(**GPT2_KW), batch=8)
    eng = compile_serving(m, device="cpu")
    eng.load_params(params_from_jax(jax.device_get(jparams)))
    return eng


@pytest.fixture(scope="module")
def engines():
    """{kv dtype: {"jax": (untiered, tiered), "port": (untiered, tiered)}},
    all on the JAX untiered engine's weights."""
    out = {}
    for kvd in KV_DTYPES:
        jb = _jax_engine(kvd, 0)
        out[kvd] = {"jax": (jb, _jax_engine(kvd, HOST_PAGES, jb.params)),
                    "port": (_port_engine(kvd, 0, jb.params),
                             _port_engine(kvd, HOST_PAGES, jb.params))}
    return out


def _requests(cls, n=6):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=[int(x) for x in rng.integers(1, 255, size=8)],
                max_new_tokens=6) for i in range(n)]


def _serve(eng, sched_cls, req_cls, prompt_fn, step_fn, **kw):
    sched = sched_cls(eng, eng.params, prompt_fn, step_fn, eos_id=None,
                      **kw)
    done = sched.run(_requests(req_cls))
    return {r.rid: list(r.tokens) for r in done}, sched


def _serve_jax(eng, **kw):
    return _serve(eng, JScheduler, JRequest, jprompt_inputs, jstep_inputs,
                  **kw)


def _serve_port(eng, **kw):
    return _serve(eng, ContinuousBatchingScheduler, Request,
                  gpt2_prompt_inputs, gpt2_step_inputs, **kw)


@pytest.fixture(scope="module")
def tier_runs(engines, tmp_path_factory):
    """Every engine serves the same 6 requests at dispatch_ahead 2; the
    tiered runs write telemetry (each package into its own sink)."""
    out = {}
    for kvd in KV_DTYPES:
        (jb, jt), (pb, pt) = engines[kvd]["jax"], engines[kvd]["port"]
        run = {"jax_base": _serve_jax(jb, dispatch_ahead=2),
               "port_base": _serve_port(pb, dispatch_ahead=2)}
        jdir = str(tmp_path_factory.mktemp(f"jtel_{kvd}"))
        pdir = str(tmp_path_factory.mktemp(f"ptel_{kvd}"))
        jtel.configure(jdir)
        try:
            run["jax_tier"] = _serve_jax(jt, dispatch_ahead=2)
        finally:
            jtel.shutdown()
        tel.configure(pdir)
        try:
            run["port_tier"] = _serve_port(pt, dispatch_ahead=2)
        finally:
            tel.shutdown()
        run["jax_events"] = jtel.read_events(jdir)
        run["port_events"] = tel.read_events(pdir)
        out[kvd] = run
    return out


@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_tiered_streams_bitwise_in_both_packages(tier_runs, kvd):
    """6 requests through 4 slots with 12 device data pages: the tiered
    streams equal the untiered ones, in the port and in JAX, and the runs
    really went through the host tier."""
    r = tier_runs[kvd]
    assert r["port_tier"][0] == r["port_base"][0] == r["jax_tier"][0] == \
        r["jax_base"][0]
    assert len(r["port_tier"][0]) == 6
    ts = r["port_tier"][1].kv.tier_stats()
    assert ts["kv_spills"] > 0 and ts["kv_refills"] == ts["kv_spills"]
    assert ts["kv_parked_slots"] == 0 and ts["kv_cold_pages"] == 0


@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_tier_counters_and_stats_match_jax(tier_runs, kvd):
    r = tier_runs[kvd]
    js, ps = r["jax_tier"][1], r["port_tier"][1]
    assert ps.kv.tier_counters == js.kv.tier_counters
    assert ps.kv.tier_stats() == js.kv.tier_stats()
    assert ps.stats == {k: js.stats[k] for k in ps.stats}
    assert (ps.materializations, ps.decode_steps, ps.prefills) == \
        (js.materializations, js.decode_steps, js.prefills)
    ts = ps.kv.tier_stats()
    assert ts["kv_prefetch_hits"] + ts["kv_prefetch_stalls"] == \
        ts["kv_refills"]
    assert ps.stats["kv_spills"] == ts["kv_spills"]


def _tier_events(evs):
    keep = {"serve/slot_parked": ("rid", "slot", "tokens"),
            "serve/slot_rejoined": ("rid", "slot", "stalled", "lead_steps")}
    return [(e["name"],) + tuple(e["args"][k] for k in keep[e["name"]])
            for e in evs if e.get("name") in keep]


@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_parked_rejoined_events_match_jax(tier_runs, kvd):
    r = tier_runs[kvd]
    got, want = _tier_events(r["port_events"]), _tier_events(r["jax_events"])
    assert got == want
    assert any(e[0] == "serve/slot_rejoined" for e in got)
    names = {e.get("name") for e in r["port_events"]}
    for name in ("serve/kv_spill", "serve/kv_prefetch",
                 "serve/kv_tier_hot_pages", "serve/kv_tier_cold_pages",
                 "serve/kv_prefetch_hits", "serve/kv_prefetch_stalls",
                 "serve/kv_spills", "serve/req/kv_prefetch"):
        assert name in names, name
    ts = r["port_tier"][1].kv.tier_stats()
    xfer = [e for e in r["port_events"] if e.get("name") == "op/attr"
            and e["args"].get("op") == "kv_transfer"]
    assert len(xfer) == ts["kv_spills"] + ts["kv_refills"]
    assert {e["args"]["candidate"] for e in xfer} == {"spill", "prefetch"}
    assert all(e["args"]["predicted_s"] > 0 for e in xfer)


@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_tiered_geometry_and_host_accounting(engines, kvd):
    pt = engines[kvd]["port"][1]
    jt = engines[kvd]["jax"][1]
    spec = pt.kv_spec
    assert spec.fingerprint() == jt.kv_spec.fingerprint()
    assert spec.pool_pages == 24 - HOST_PAGES + 1
    assert pt.kv.capacity_pages() == jt.kv.capacity_pages() == 24
    assert spec.slot_bytes() == jt.kv_spec.slot_bytes()
    ms, jms = pt.memory_stats(), jt.memory_stats()
    assert ms["predicted_kv_host_bytes"] == ms["actual_kv_host_bytes"] == \
        jms["actual_kv_host_bytes"] > 0
    assert ms["predicted_kv_cache_bytes"] == ms["actual_kv_cache_bytes"] == \
        jms["predicted_kv_cache_bytes"]
    assert ms["kv_pool_pages"] == spec.pool_pages
    panel = pt.health_report()["serving"]["kv_tier"]
    assert panel == jt.health_report()["serving"]["kv_tier"]
    assert panel["host_pages_total"] == HOST_PAGES


@pytest.mark.parametrize("dispatch_ahead", [1, 2, 4])
def test_dispatch_ahead_matches_jax(engines, dispatch_ahead):
    """The scheduler takes JAX's `dispatch_ahead` (clamped to >= 1): the
    streams, host syncs and stats equal JAX's at each value."""
    jb, pb = engines["auto"]["jax"][0], engines["auto"]["port"][0]
    jdone, js = _serve_jax(jb, dispatch_ahead=dispatch_ahead)
    pdone, ps = _serve_port(pb, dispatch_ahead=dispatch_ahead)
    assert ps.dispatch_ahead == js.dispatch_ahead == dispatch_ahead
    assert pdone == jdone
    assert (ps.materializations, ps.decode_steps, ps.prefills) == \
        (js.materializations, js.decode_steps, js.prefills)
    assert ps.stats == {k: js.stats[k] for k in ps.stats}
    assert ContinuousBatchingScheduler(
        pb, pb.params, gpt2_prompt_inputs, gpt2_step_inputs,
        dispatch_ahead=0).dispatch_ahead == 1


# ---------------------------------------------------- the cache, side by side
def _caches(host_pages=4, slots=3, pps=2, layers=2):
    kw = dict(layers=layers, heads=2, head_dim=4, slots=slots,
              pages_per_slot=pps, page_size=4, host_pages=host_pages,
              device_pages=(max(pps, slots * pps - host_pages)
                            if host_pages else 0))
    names = [f"attn{i}" for i in range(layers)]
    return (JPagedKVCache(JKVCacheSpec(**kw), names),
            PagedKVCache(KVCacheSpec(**kw), names, device="cpu"))


def _ledger(kv):
    return (sorted(kv.free_pages), sorted(kv.free_host_pages),
            {s: len(p) for s, p in kv._slot_pages.items()},
            {s: len(p) for s, p in kv._cold.items()}, dict(kv._inflight),
            kv.free_slots(), kv.parked_slots(), kv.tier_stats())


def test_page_conservation_through_churn_matches_jax():
    """admit / spill / prefetch / join / evict (a parked slot's pages go
    back to the HOST free list): both caches keep the same ledger after
    every step, and free + owned equals each tier's total."""
    jkv, pkv = _caches(host_pages=2)
    dev_total, host_total = pkv.spec.pool_pages - 1, pkv.host_pages
    steps = [("admit", 0, 4, 8), ("admit", 1, 4, 8), ("spill", 0, 10),
             ("prefetch", 0, 12), ("join", 0, 13, 2), ("spill", 1, 14),
             ("evict", 1), ("evict", 0)]
    for op, *args in steps:
        got = [getattr(kv, op)(*args) for kv in (jkv, pkv)]
        assert got[0] == got[1], op
        assert _ledger(pkv) == _ledger(jkv), op
        owned_dev = sum(len(p) for p in pkv._slot_pages.values())
        owned_host = sum(len(p) for p in pkv._cold.values())
        assert len(pkv.free_pages) + owned_dev == dev_total
        assert len(pkv.free_host_pages) + owned_host == host_total
        if op == "spill" and args[0] == 0:
            assert 0 not in pkv.free_slots()
            with pytest.raises(ValueError):
                pkv.admit(0, 4, 8)
    assert len(pkv.free_pages) == dev_total
    assert len(pkv.free_host_pages) == host_total


def test_spill_refill_round_trip_is_bitwise():
    """What goes to the host comes back bitwise, into other device pages,
    for every leaf of an int8 cache (values and scales) and a float one."""
    import torch

    for quantized in (False, True):
        spec = KVCacheSpec(layers=2, heads=2, head_dim=4, slots=3,
                           pages_per_slot=2, page_size=4, host_pages=4,
                           device_pages=2, itemsize=1 if quantized else 4,
                           scale_itemsize=4 if quantized else 0)
        kv = PagedKVCache(spec, ["a0", "a1"], device="cpu",
                          quantized=quantized)
        kv.admit(0, 4, 8)
        pages = list(kv._slot_pages[0])
        gen = torch.Generator().manual_seed(0)
        want = {}
        for n in kv.attn_layers:
            for key, leaf in kv.state[n].items():
                if leaf.dtype == torch.int8:
                    rows = torch.randint(-127, 128, (2,) + leaf.shape[1:],
                                         generator=gen, dtype=torch.int8)
                else:
                    rows = torch.randn((2,) + leaf.shape[1:], generator=gen)
                leaf[pages] = rows
                want[n, key] = rows
        kv.spill(0, 0)
        kv.admit(1, 4, 8)       # takes the freed pages
        kv.evict(1)
        kv.free_pages.reverse()  # the refill lands on other pages
        assert kv.prefetch(0, 4)
        kv.join(0, 8, 2)
        new = kv._slot_pages[0]
        assert new != pages
        for (n, key), rows in want.items():
            assert torch.equal(kv.state[n][key][new], rows), (n, key)


def test_prefetch_backpressure_and_join_ledger_match_jax():
    jkv, pkv = _caches(host_pages=4, slots=3, pps=2)   # 2 device pages
    steps = [("admit", 0, 4, 8), ("spill", 0, 0), ("admit", 1, 4, 8),
             ("prefetch", 0, 1), ("evict", 1), ("prefetch", 0, 2),
             ("join", 0, 10, 2)]
    for op, *args in steps:
        got = [getattr(kv, op)(*args) for kv in (jkv, pkv)]
        assert got[0] == got[1], op
        assert _ledger(pkv) == _ledger(jkv), op
    # device full: the first prefetch did nothing and the slot stayed
    # rotation-eligible; the join with 8 steps of lead is a hit
    assert pkv.tier_counters == jkv.tier_counters
    assert pkv.tier_counters["kv_prefetch_hits"] == 1
    with pytest.raises(ValueError):
        pkv.join(0, 11, 2)
    with pytest.raises(ValueError):
        pkv.prefetch(2, 11)


def test_admission_capacity_spans_both_tiers():
    """A request that the shrunken device pool alone could never hold is
    admissible counting the host pages, and shed as prompt_too_long
    without them, in both packages."""
    for host, want in ((2, None), (0, "prompt_too_long")):
        reasons = []
        for spec_cls, cache_cls, req_cls, kw in (
                (JKVCacheSpec, JPagedKVCache, JRequest, {}),
                (KVCacheSpec, PagedKVCache, Request, {"device": "cpu"})):
            spec = spec_cls(layers=1, heads=2, head_dim=4, slots=2,
                            pages_per_slot=4, page_size=4, host_pages=host,
                            device_pages=2)
            kv = cache_cls(spec, ["attn0"], **kw)
            assert kv.capacity_pages() == 2 + host
            from flexflow_tpu_torch.serving.fleet import AdmissionControl
            ac = AdmissionControl(seq=128, max_context=0, queue_cap=0,
                                  overhead_tokens=0,
                                  pages_needed=kv.pages_needed,
                                  capacity_pages=kv.capacity_pages)
            reasons.append(ac.permanent_shed_reason(
                req_cls(rid=0, prompt=[1] * 10, max_new_tokens=4)))
        assert reasons == [want, want]


def test_derive_prefetch_ahead_matches_jax_on_a_grid():
    grid = [None, 0.0, 1e-6, 3.3e-4, 2e-3, 0.05, 1.0]
    for t in grid:
        for d in grid + [-1.0]:
            for fb in (0, 1, 2, 7):
                assert derive_prefetch_ahead(t, d, fb) == \
                    jderive_prefetch_ahead(t, d, fb), (t, d, fb)
    spec = KVCacheSpec(layers=1, heads=2, head_dim=4, slots=2,
                       pages_per_slot=4, page_size=4, host_pages=2)
    assert learned_kv_transfer_seconds(FFConfig(), spec) is None


def test_format_kv_tier_matches_jax():
    stats = {"kv_prefetch_hits": 3, "kv_prefetch_stalls": 1, "kv_spills": 4,
             "kv_refills": 4, "kv_hot_pages": 5, "kv_cold_pages": 2,
             "kv_parked_slots": 1, "kv_host_pages_total": 8,
             "kv_spilled_bytes": 10, "kv_refilled_bytes": 10}
    assert format_kv_tier(stats) == jformat_kv_tier(stats)
    assert format_kv_tier(stats)["prefetch_hit_rate"] == pytest.approx(0.75)
    assert format_kv_tier({}) == jformat_kv_tier({})


def test_engine_op_attribution_prices_as_jax(engines):
    """`op_attribution` of the tiered engine: the prefill rows carry JAX's
    predicted (serving cost function) and roofline seconds layer for
    layer, and the decode program's attention is measured over the
    synthetic full cache, forward only."""
    pt, jt = engines["int8"]["port"][1], engines["int8"]["jax"][1]
    rep = pt.op_attribution(step_time_s=1e-3, prefill_step_time_s=2e-3)
    jrep = jt.op_attribution(kind="prefill", prefill_step_time_s=2e-3)
    got = {r["layer"]: r for r in rep["serve_prefill"]["rows"]}
    want = {r["layer"]: r for r in jrep["serve_prefill"]["rows"]}
    assert set(got) == set(want)
    for name, r in got.items():
        for k in ("predicted_s", "roofline_s"):
            assert r[k] == pytest.approx(want[name][k], rel=1e-9), (name, k)
    dec = {r["layer"]: r for r in rep["serve_decode"]["rows"]}
    assert set(dec) == set(got)
    assert dec["h0_attn"]["measured_s"] > 0
    assert rep["serve_decode"]["attributed_total_s"] == pytest.approx(1e-3)
    assert pt.kv.tier_stats()["kv_parked_slots"] == 0
