"""The pipeline's pure functions on the port against the JAX package, no
ranks: search/cost_model.py's pipeline terms (the schedule grids and
per-stage orders for gpipe and 1f1b at S in {2, 4} and M in {1, 4, 8},
the replay's timeline, span and bubble, the closed form, the in-flight
stash, the phase split, the step time), search/simulator.py
`simulate_pipeline`, search/candidates.py `stage_cut_candidates` (single
tensor cuts) and `cut_boundary_tensor`, search/dp.py `stage_machine_for`,
`search_pipelined` (cuts, cost, bubble, memory) and `choose_pipeline`, on
the same MachineSpec numbers ("cpu-sim", JAX's CPU stand-in, which both
packages keep alike) for JAX's `_mlp` and 2-layer GPT-2
(tests/test_pipeline.py:16-33). Also the strategy cache's pipeline knobs,
`--pipeline-schedule` and the compile's refusal at world 1. Costs equal
JAX's to 1e-9 relative (the same closed forms in float64)."""

import numpy as np
import pytest

import flexflow_tpu_torch as F
from flexflow_tpu_torch.search import cost_model as pcm
from flexflow_tpu_torch.search import simulator as psim

GRIDS = [(sched, S, M) for sched in ("gpipe", "1f1b") for S in (2, 4)
         for M in (1, 4, 8)]
REL = 1e-9


def _mlp(pkg, cfg, batch=8):
    m = pkg.FFModel(cfg)
    t = m.create_tensor([batch, 64], name="x")
    h = m.dense(t, 256, activation="gelu", name="up")
    h = m.dense(h, 64, name="down")
    h = m.dense(h, 128, activation="relu", name="mid")
    m.dense(h, 8, name="head")
    return m


def _gpt2(pkg, cfg, batch=8):
    import importlib

    models = importlib.import_module(pkg.__name__ + ".models")
    m = pkg.FFModel(cfg)
    models.build_gpt2(m, models.GPT2Config(vocab=512, seq=16, d_model=64,
                                           heads=2, layers=2, dropout=0.0),
                      batch=batch)
    return m


def _pair(kind):
    import flexflow_tpu as J

    build = _gpt2 if kind == "gpt2" else _mlp
    jm = build(J, J.FFConfig(batch_size=8, log_level="warning"))
    pm = build(F, F.FFConfig(batch_size=8))
    return jm, pm


def _machines(axes):
    from flexflow_tpu.parallel.machine import MachineSpec as JM

    from flexflow_tpu_torch.parallel.machine import MachineSpec as PM

    return JM(mesh_axes=dict(axes), chip="cpu-sim"), \
        PM(mesh_axes=dict(axes), chip="cpu-sim")


# ------------------------------------------------------ the cost terms
@pytest.mark.parametrize("sched,S,M", GRIDS)
def test_schedule_grid_and_order_equal_jax(devices, sched, S, M):
    from flexflow_tpu.search import cost_model as jcm

    assert pcm.pipeline_schedule(sched, S, M) == \
        jcm.pipeline_schedule(sched, S, M)
    assert pcm.pipeline_order(sched, S, M) == jcm.pipeline_order(sched, S, M)
    ops = [op for row in pcm.pipeline_schedule(sched, S, M) for op in row]
    assert len(ops) == len(set(ops)) == 2 * S * M
    assert pcm.pipeline_inflight_acts(sched, S, M) == \
        jcm.pipeline_inflight_acts(sched, S, M)
    assert pcm.pipeline_bubble_fraction(sched, S, M) == \
        jcm.pipeline_bubble_fraction(sched, S, M)


@pytest.mark.parametrize("sched,S,M", GRIDS)
def test_timeline_span_bubble_and_replay_equal_jax(devices, sched, S, M):
    from flexflow_tpu.search import cost_model as jcm
    from flexflow_tpu.search import simulator as jsim

    rng = np.random.default_rng(S * 100 + M)
    costs = list(rng.uniform(1.0, 3.0, size=S))
    fwd, bwd = pcm.pipeline_phase_times(costs)
    assert (fwd, bwd) == jcm.pipeline_phase_times(costs)
    for p2p in (0.0, 0.25):
        span, ev = pcm.pipeline_timeline(sched, M, fwd, bwd, p2p)
        jspan, jev = jcm.pipeline_timeline(sched, M, fwd, bwd, p2p)
        assert span == jspan and ev == jev
        assert pcm.pipeline_span(sched, M, fwd, bwd, p2p) == \
            jcm.pipeline_span(sched, M, fwd, bwd, p2p)
        assert pcm.pipeline_bubble(sched, M, fwd, bwd, p2p) == \
            jcm.pipeline_bubble(sched, M, fwd, bwd, p2p)
        rep = psim.simulate_pipeline(fwd, bwd, sched, M, p2p)
        jrep = jsim.simulate_pipeline(fwd, bwd, sched, M, p2p)
        assert rep["makespan"] == jrep["makespan"]
        assert rep["bubble"] == jrep["bubble"]
        assert rep["events"] == jrep["events"]
    # balanced stages reproduce the closed form
    rep = psim.simulate_pipeline([1.0] * S, [2.0] * S, sched, M)
    assert rep["bubble"] == pytest.approx(
        pcm.pipeline_bubble_fraction(sched, S, M), abs=1e-9)


def test_step_time_and_p2p_equal_jax_on_the_same_numbers(devices):
    from flexflow_tpu.search import cost_model as jcm

    jm, pm = _machines({"data": 4})
    assert pcm.p2p_time(1 << 20, pm) == pytest.approx(
        jcm.p2p_time(1 << 20, jm), rel=REL)
    fwd, bwd = pcm.pipeline_phase_times([3.0, 2.0, 4.0])
    for sched in ("gpipe", "1f1b"):
        assert pcm.pipeline_step_time(fwd, bwd, [4096, 8192], pm, sched,
                                      4) == pytest.approx(
            jcm.pipeline_step_time(fwd, bwd, [4096, 8192], jm, sched, 4),
            rel=REL)


def test_simulate_pipeline_refuses_a_broken_timeline(monkeypatch):
    """The replay checks every dependency: a producer that ends after its
    consumer starts raises."""
    span, ev = pcm.pipeline_timeline("1f1b", 2, [1.0, 1.0], [2.0, 2.0])
    ev = dict(ev)
    s, e = ev[("F", 0, 1)]
    ev[("F", 0, 1)] = (s, e + 100.0)
    monkeypatch.setattr(pcm, "pipeline_timeline", lambda *a, **k: (span, ev))
    with pytest.raises(RuntimeError, match="invalid pipeline schedule"):
        psim.simulate_pipeline([1.0, 1.0], [2.0, 2.0], "1f1b", 2)


# ----------------------------------------------------- cuts and search
@pytest.mark.parametrize("kind", ["mlp", "gpt2"])
def test_stage_cut_candidates_equal_jax(devices, kind):
    from flexflow_tpu.core.graph import topo_order as jtopo
    from flexflow_tpu.search.candidates import (
        cut_boundary_tensor as jcut, stage_cut_candidates as jcands)

    from flexflow_tpu_torch.core.graph import topo_order
    from flexflow_tpu_torch.search.candidates import (cut_boundary_tensor,
                                                      stage_cut_candidates)
    from flexflow_tpu_torch.search.unity import sequence_cut_indices

    jm, pm = _pair(kind)
    jmach, pmach = _machines({"data": 4})
    for S in (2, 3):
        got = stage_cut_candidates(pm, pmach, S, max_candidates=6)
        assert got == jcands(jm, jmach, S, max_candidates=6)
        assert got
        ok = set(sequence_cut_indices(topo_order(pm.layers),
                                      pm.input_tensors))
        for combo in got:
            assert len(combo) == S - 1 and set(combo) <= ok
    order, jorder = topo_order(pm.layers), jtopo(jm.layers)
    for c in sorted(sequence_cut_indices(order, pm.input_tensors)):
        t, jt = cut_boundary_tensor(order, c), jcut(jorder, c)
        assert t.owner.name == jt.owner.name and t.owner_idx == jt.owner_idx


@pytest.mark.parametrize("axes,S", [({"data": 8}, 2), ({"data": 8}, 4),
                                    ({"pipe": 2, "data": 2}, 2),
                                    ({"data": 4, "model": 2}, 2),
                                    ({"data": 2, "model": 2}, 2)])
def test_stage_machine_for_equals_jax(devices, axes, S):
    from flexflow_tpu.search.dp import stage_machine_for as jsmf

    from flexflow_tpu_torch.search.dp import stage_machine_for

    jm, pm = _machines(axes)
    got, want = stage_machine_for(pm, S), jsmf(jm, S)
    assert dict(got.mesh_axes) == dict(want.mesh_axes)
    assert got.flops == want.flops and got.hbm_bytes == want.hbm_bytes


def test_stage_machine_for_refuses_as_jax(devices):
    from flexflow_tpu.search.dp import stage_machine_for as jsmf

    from flexflow_tpu_torch.search.dp import stage_machine_for

    for axes, S in (({"data": 3}, 2), ({"pipe": 4, "data": 2}, 2)):
        jm, pm = _machines(axes)
        with pytest.raises(ValueError) as je:
            jsmf(jm, S)
        with pytest.raises(ValueError) as pe:
            stage_machine_for(pm, S)
        assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("kind,sched,S", [("mlp", "1f1b", 2),
                                          ("mlp", "gpipe", 2),
                                          ("gpt2", "1f1b", 2),
                                          ("gpt2", "gpipe", 4)])
def test_search_pipelined_equals_jax(devices, kind, sched, S):
    from flexflow_tpu.search.dp import search_pipelined as jsearch

    from flexflow_tpu_torch.search.dp import search_pipelined

    jm, pm = _pair(kind)
    jmach, pmach = _machines({"data": 8})
    got = search_pipelined(pm, pmach, S, 4, schedule=sched)
    want = jsearch(jm, jmach, S, 4, schedule=sched)
    assert got.cuts == want.cuts and got.stages == want.stages
    assert got.cost == pytest.approx(want.cost, rel=REL)
    assert got.bubble == pytest.approx(want.bubble, rel=REL)
    assert got.mem_bytes == want.mem_bytes
    np.testing.assert_allclose(got.stage_costs, want.stage_costs, rtol=REL)
    assert 0.0 < got.bubble < 1.0


def test_choose_pipeline_under_a_memory_cap_equals_jax(devices):
    """JAX's MULTICHIP-style assertion on the same numbers: under a cap
    pure data parallelism cannot meet, the pick is pipelined, and the
    port picks what JAX picks."""
    from flexflow_tpu.search.dp import choose_pipeline as jchoose
    from flexflow_tpu.search.dp import search_graph as jsg

    from flexflow_tpu_torch.search.dp import choose_pipeline, search_graph

    jm, pm = _pair("gpt2")
    jmach, pmach = _machines({"data": 8})
    r0, jr0 = search_graph(pm, pmach), jsg(jm, jmach)
    assert r0.mem_bytes == jr0.mem_bytes
    cap = r0.mem_bytes * 0.6
    got = choose_pipeline(pm, pmach, 8, stages_options=(1, 2, 4),
                          mem_budget=cap)
    want = jchoose(jm, jmach, 8, stages_options=(1, 2, 4), mem_budget=cap)
    assert got.stages == want.stages > 1
    assert got.cuts == want.cuts
    assert got.score == pytest.approx(want.score, rel=REL)
    assert got.mem_bytes < r0.mem_bytes


# ------------------------------------------------- config, cache, compile
def test_strategy_cache_keys_on_pipeline_knobs():
    from flexflow_tpu_torch.search.strategy_cache import knob_fingerprint

    base = F.FFConfig(batch_size=8)
    assert knob_fingerprint(base) == knob_fingerprint(
        F.FFConfig(batch_size=8, accum_steps=4))
    for other in (F.FFConfig(batch_size=8, pipeline_stages=2),
                  F.FFConfig(batch_size=8, pipeline_stages=2,
                             pipeline_schedule="gpipe"),
                  F.FFConfig(batch_size=8, pipeline_stages=2, accum_steps=4)):
        assert knob_fingerprint(other) != knob_fingerprint(base)
    assert knob_fingerprint(F.FFConfig(batch_size=8, pipeline_stages=2)) != \
        knob_fingerprint(F.FFConfig(batch_size=8, pipeline_stages=2,
                                    accum_steps=4))


def test_pipelined_compile_raises_at_world_1_as_jax():
    cfg = F.FFConfig(batch_size=8, pipeline_stages=2, accum_steps=4)
    m = _mlp(F, cfg)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        m.compile(F.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy",
                  [], device="cpu")


def test_launcher_takes_both_pipeline_flags():
    from flexflow_tpu_torch.__main__ import split_argv

    derived = F.FFConfig.launcher_value_flags()
    assert {"--pipeline-stages", "--pipeline-schedule"} <= derived
    script, largs, sargs = split_argv(["--pipeline-stages", "2",
                                       "--pipeline-schedule", "gpipe",
                                       "train.py", "x"])
    assert script == "train.py" and sargs == ["x"]
    cfg = F.FFConfig.parse_args(largs)
    assert (cfg.pipeline_stages, cfg.pipeline_schedule) == (2, "gpipe")
