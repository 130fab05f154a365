"""graph_optimize — the search entry point
(counterpart: flexflow_tpu/search/optimize.py).

Reference analog: `Graph::graph_optimize_task` →
`GraphSearchHelper::graph_optimize` (src/runtime/substitution.cc:1898-1945):
build the PCG, search, serialize the strategy. Here: the Unity search
(search/unity.py) over the frontier DP, behind the persistent strategy
cache (search/strategy_cache.py), with per-op costs analytic or measured
on the device (search/measure.py).
"""

from __future__ import annotations

import time

from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.parallel.sharding import OpSharding, Strategy
from flexflow_tpu_torch.search import cost_model as cm
from flexflow_tpu_torch.search import strategy_cache as sc
from flexflow_tpu_torch.search.candidates import (_dp_dims, candidate_attrs,
                                                  compiled_candidate)
from flexflow_tpu_torch.search.dp import SearchResult, search_graph
from flexflow_tpu_torch.search.mcmc import mcmc_optimize  # noqa: F401


def result_to_strategy(model, machine: MachineSpec,
                       result: SearchResult) -> Strategy:
    st = Strategy(mesh_axes=dict(machine.mesh_axes), name="searched")
    batch_sizes = {t.shape[0] for t in model.input_tensors if t.ndim > 0}
    for t in model.input_tensors:
        st.input_shardings[t.name] = _dp_dims(t.shape, machine, batch_sizes)
    for layer in topo_order(model.layers):
        cand = result.choices[layer.name]
        st.op_shardings[layer.name] = OpSharding(
            outputs=[list(d) for d in cand.out_dims],
            weights={w: list(d) for w, d in cand.weight_dims.items()},
            attrs=candidate_attrs(cand),
        )
    return st


def graph_optimize(model, machine: MachineSpec, measured: bool = False,
                   optimizer=None, measure_device=None) -> Strategy:
    """Unity search: graph substitutions (best-first under budget/alpha)
    over the frontier DP.

    With `measured` (or cfg.profiling) the per-op costs are timed on
    `measure_device` in cfg.compute_dtype by search/measure.py's
    MeasuredCost, whose store persists under the strategy-cache dir. With
    `simulator_mode="learned"` and a model file (search/learned_cost.py),
    the learned model prices the ops when nothing is measured, prunes the
    DP's candidates and finalists, and emits a `search/learned_cost`
    event with its coverage. Unless cfg.strategy_cache is off, the winning
    Strategy is persisted keyed by (graph hash, machine fingerprint,
    search knobs, calibration fingerprint, optimizer memory, learned
    model fingerprint) — a warm call on an unchanged model returns the
    validated cached strategy without a single DP expansion.

    The returned strategy carries `_predicted_cost` (the search's best
    per-step time), `_predicted_op_costs`, `_search_stats` (the
    UnityStats of a cold search; None on a cache hit) and `_learned` (the
    LearnedCost that priced it, with its hits and misses, or None)."""
    cfg = model.config
    # the optimizer's memory model (moment count/dtype): changes what
    # memory-constrained searches predict, so it rides the cache key
    opt_mem = cm.opt_mem_spec(optimizer, cfg, machine)
    opt_fp = repr(opt_mem.fingerprint()) if opt_mem is not None else ""
    use_cache = bool(cfg.strategy_cache)
    cache_dir = sc.resolve_dir(cfg) if use_cache else None
    cost_fn = None
    measure_cache_path = None
    if measured or cfg.profiling:
        from flexflow_tpu_torch.search.measure import MeasuredCost

        # the measured-cost store keeps persisting under the resolved cache
        # dir even when the STRATEGY cache is off (fresh searches need not
        # re-run every microbenchmark)
        mc = MeasuredCost(machine, cache_dir=sc.resolve_dir(cfg),
                          device=measure_device,
                          compute_dtype=cfg.compute_dtype,
                          enable_fusion=cfg.enable_fusion)
        cost_fn = mc.op_time
        measure_cache_path = mc.cache_path
    # the learned tier: None unless simulator_mode is "learned" and a model
    # file resolves; with None the search is the one without the tier
    from flexflow_tpu_torch.search import learned_cost as lcm

    learned = lcm.load_for_config(cfg, machine)
    learned_fp = sc.learned_fingerprint(
        learned.path if learned is not None else None)
    if learned is not None and cost_fn is None:
        cost_fn = learned.op_time
    if use_cache:
        calib = sc.calibration_fingerprint(measure_cache_path)
        key = sc.cache_key(model, machine, cfg, calib, opt_fp,
                           learned_fp=learned_fp)
        cached = sc.lookup(cache_dir, key, model, machine)
        if cached is not None:
            cached._search_stats = None
            cached._learned = learned
            return cached
    from flexflow_tpu_torch.search.unity import unity_optimize

    t0 = time.perf_counter()
    with tel.span("search/unity", cat="compile",
                  measured=bool(cost_fn is not None)):
        st, stats = unity_optimize(model, machine, cost_fn=cost_fn,
                                   opt_mem=opt_mem, learned=learned)
    wall = time.perf_counter() - t0
    if learned is not None:
        tel.event("search/learned_cost", cat="compile",
                  coverage=learned.coverage(), hits=learned.hits,
                  misses=learned.misses, fingerprint=learned.model.fingerprint,
                  finalists_pruned=stats.finalists_pruned)
    st._learned = learned
    st._predicted_cost = stats.best_cost
    st._predicted_op_costs = dict(stats.op_costs)
    tel.event("search/result", cat="compile", cost_s=stats.best_cost,
              baseline_cost_s=stats.baseline_cost,
              expansions=stats.expansions)
    st._search_stats = stats
    st._search_seconds = wall
    if use_cache:
        if measure_cache_path is not None:
            # the measured search wrote new microbenchmarks into the store
            # it is fingerprinted by: re-key on the POST-search content so
            # the next run's lookup (which hashes the populated store)
            # finds this entry instead of orphaning it
            calib = sc.calibration_fingerprint(measure_cache_path)
            key = sc.cache_key(model, machine, cfg, calib, opt_fp,
                               learned_fp=learned_fp)
        meta = {
            "cost_s": stats.best_cost,
            "op_costs_s": dict(stats.op_costs),
            "baseline_cost_s": stats.baseline_cost,
            "expansions": stats.expansions,
            "search_wallclock_s": wall,
            "calibration": calib,
        }
        if learned is not None:
            meta["learned_fingerprint"] = learned.model.fingerprint
            meta["learned_coverage"] = learned.coverage()
        sc.store(cache_dir, key, st, meta=meta)
    return st


def predict_step_time(model, machine: MachineSpec,
                      beam_width: int = 64) -> float:
    """Predicted per-step time of the best found strategy (simulator
    query)."""
    return search_graph(model, machine, beam_width=beam_width).cost


def strategy_cost(model, machine: MachineSpec, strategy: Strategy,
                  cost_fn=None, optimizer=None) -> SearchResult:
    """The search's price of a given strategy: every layer pinned to the
    candidate matching its compiled layout (candidates.compiled_candidate),
    then one frontier-DP pass, so reshards and overlap are priced exactly
    as for the searched winner. How the templates (parallel/templates.py)
    and the data-parallel baseline are compared with the search."""
    batch_sizes = {t.shape[0] for t in model.input_tensors if t.ndim > 0}
    pins = {l.name: compiled_candidate(l, strategy, machine, batch_sizes).name
            for l in model.layers}
    return search_graph(model, machine, cost_fn=cost_fn, pins=pins,
                        opt_mem=cm.opt_mem_spec(optimizer, model.config,
                                                machine))

