"""The port's MCMC strategy search against the JAX package's
(tests/test_mcmc.py), on the CPU.

`random.Random(seed)` is the same generator in both packages and the cost
model is the same float arithmetic, so for the same model, machine and
seed both packages walk the same chain: equal MCMC stats (steps, accepted,
improved, initial and best cost to a relative 1e-12) and the same
strategy, under the additive and the task-graph evaluators.
"""

import numpy as np
import pytest

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.parallel.machine import MachineSpec as JMachineSpec
from flexflow_tpu.search import mcmc as jmcmc
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.parallel.sharding import Strategy
from flexflow_tpu_torch.search import mcmc
from flexflow_tpu_torch.search.candidates import layer_candidates
from flexflow_tpu_torch.search.dp import search_graph
from flexflow_tpu_torch.search.optimize import mcmc_optimize

REL = 1e-12
MACH = {"mesh_axes": {"data": 2, "model": 4}, "chip": "h100"}


def _machines(d=MACH):
    p = MachineSpec.from_json(dict(d))
    return p, JMachineSpec.from_json(p.to_json())


def mlp_pair(ffm, ffc):
    m = ffm(ffc(batch_size=32))
    x = m.create_tensor([32, 8192], name="x")
    h = m.dense(x, 4 * 8192, activation="gelu", name="up")
    m.dense(h, 8192, name="down")
    return m


def chain(ffm, ffc, d=1024, n=3, b=16, s=128):
    m = ffm(ffc(batch_size=b))
    h = m.create_tensor([b, s, d], name="x")
    for i in range(n):
        h = m.dense(h, d, activation="relu", name=f"l{i}")
    return m


def _stats(st):
    return (st.steps, st.accepted, st.improved)


@pytest.mark.parametrize("which,evaluator,budget,seed", [
    ("mlp", "additive", 400, 0), ("chain", "additive", 300, 1),
    ("mlp", "taskgraph", 60, 2), ("chain", "taskgraph", 40, 3)])
def test_same_chain_as_jax(which, evaluator, budget, seed):
    build = mlp_pair if which == "mlp" else chain
    p_m, j_m = _machines()
    pst, ps = mcmc.mcmc_optimize(build(FFModel, FFConfig), p_m,
                                 budget=budget, seed=seed,
                                 evaluator=evaluator)
    jst, js = jmcmc.mcmc_optimize(build(JFFModel, JFFConfig), j_m,
                                  budget=budget, seed=seed,
                                  evaluator=evaluator)
    assert _stats(ps) == _stats(js)
    for a, b in ((ps.best_cost, js.best_cost), (ps.init_cost, js.init_cost)):
        assert a == pytest.approx(b, rel=REL, abs=0.0)
    assert pst.to_json() == jst.to_json()
    assert ps.best_cost <= ps.init_cost


def test_finds_megatron_on_mlp_pair():
    p_m, _ = _machines()
    st, stats = mcmc_optimize(mlp_pair(FFModel, FFConfig), p_m, budget=400,
                              seed=0)
    assert stats.best_cost < stats.init_cost
    assert st.op_shardings["up"].weights["kernel"] == [None, "model"]
    assert st.op_shardings["down"].weights["kernel"] == ["model", None]


def test_matches_dp_optimum_on_chain():
    """On a chain the frontier DP is exact; annealing with a generous
    budget lands on the same cost."""
    p_m, _ = _machines()
    m = FFModel(FFConfig(batch_size=16))
    h = m.create_tensor([16, 512], name="x")
    h = m.dense(h, 1024, name="l0")
    h = m.dense(h, 1024, name="l1")
    m.dense(h, 256, name="l2")
    dp_cost = search_graph(m, p_m, beam_width=10_000).cost
    _, stats = mcmc.mcmc_optimize(m, p_m, budget=600, seed=1)
    assert stats.best_cost == pytest.approx(dp_cost, rel=REL, abs=0.0)


def test_assignment_cost_matches_dp_edge_pricing():
    """At the DP's chosen assignment the MCMC evaluator prices what the
    DP priced."""
    p_m, _ = _machines()
    m = mlp_pair(FFModel, FFConfig)
    r = search_graph(m, p_m)
    layers = topo_order(m.layers)
    cand_lists = {l.name: layer_candidates(l, p_m, {32}) for l in layers}
    assignment = {l.name: [c.name for c in cand_lists[l.name]].index(
        r.choices[l.name].name) for l in layers}
    cost = mcmc.assignment_cost(layers, m.input_tensors, assignment,
                                cand_lists, p_m)
    assert cost == pytest.approx(r.cost, rel=REL, abs=0.0)


def test_mcmc_strategy_trains(tmp_path):
    """MCMC on the one-device machine the compile runs on: its strategy,
    saved and imported, trains 2 steps to finite losses (as JAX's
    test_mcmc_strategy_trains adopts it)."""
    m = FFModel(FFConfig(batch_size=16))
    x = m.create_tensor([16, 256], name="x")
    m.dense(m.dense(x, 1024, activation="relu", name="up"), 4, name="head")
    st, _ = mcmc_optimize(m, MachineSpec.detect(device="cpu"), budget=20)
    path = str(tmp_path / "mcmc.json")
    st.save(path)
    m2 = FFModel(FFConfig(batch_size=16, import_strategy_file=path))
    x = m2.create_tensor([16, 256], name="x")
    m2.dense(m2.dense(x, 1024, activation="relu", name="up"), 4, name="head")
    cm = m2.compile(SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy",
                    [], device="cpu")
    assert cm.strategy.to_json() == Strategy.load(path).to_json()
    cm.init(seed=0)
    rng = np.random.default_rng(0)
    xv = rng.normal(size=(32, 256)).astype(np.float32)
    yv = rng.integers(0, 4, size=(32,)).astype(np.int32)
    hist = cm.fit(xv, yv, epochs=1, verbose=False)
    assert np.isfinite(hist[0]["loss"])
    assert cm.step_stats["dispatches"] == 2
