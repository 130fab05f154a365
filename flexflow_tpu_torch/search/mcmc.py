"""MCMC strategy search, the optimizer from before Unity
(counterpart: flexflow_tpu/search/mcmc.py).

Reference analog: `FFModel::mcmc_optimize` (src/runtime/model.cc:3286-3357)
with `rewrite` (:3261): simulated annealing over per-op parallel configs.
Propose a random change of one op, accept improvements always and
regressions with probability exp(-alpha * delta). States are full per-op
candidate assignments in the Unity stack's vocabulary, costed by the same
analytic model (op roofline and reshard edges) the frontier DP uses, or
replayed by the task-graph simulator. `random.Random(seed)` draws the
chain, so both packages walk the same chain for the same model, machine
and seed.

Entry: `mcmc_optimize(model, machine, budget, alpha)` -> (Strategy, stats).
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Tuple

from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.parallel.sharding import OpSharding, Strategy
from flexflow_tpu_torch.search import cost_model as cm
from flexflow_tpu_torch.search.candidates import (Candidate, _batch_axes,
                                                  _dp_dims, candidate_attrs,
                                                  layer_candidates)
from flexflow_tpu_torch.search.dp import _drop_axis, _freeze_dims


@dataclasses.dataclass
class MCMCStats:
    steps: int = 0
    accepted: int = 0
    improved: int = 0
    best_cost: float = 0.0
    init_cost: float = 0.0


def assignment_cost(layers, input_tensors, assignment: Dict[str, int],
                    cand_lists: Dict[str, List[Candidate]],
                    machine: MachineSpec) -> float:
    """Cost of a full per-op candidate assignment: op times and the reshard
    time at every edge (what the reference prices per proposal)."""
    batch_sizes = {t.shape[0] for t in input_tensors if t.ndim > 0}
    lay: Dict[int, Tuple] = {
        t.guid: _freeze_dims(_dp_dims(t.shape, machine, batch_sizes))
        for t in input_tensors}
    total = 0.0
    for layer in layers:
        cand = cand_lists[layer.name][assignment[layer.name]]
        if cand.passthrough:
            src = lay.get(layer.inputs[0].guid) if layer.inputs else None
            if src is None:
                src = _freeze_dims([None] * layer.inputs[0].spec.ndim)
            od = tuple(_drop_axis(d, cand.drop_axis) for d in src)
            if od != src:
                total += cm.reshard_time(layer.inputs[0].spec, list(src),
                                         list(od), machine)
            for o in layer.outputs:
                lay[o.guid] = od
            continue
        edge_comm = 0.0
        for ii, tin in enumerate(layer.inputs):
            cur = lay.get(tin.guid)
            if cur is None:
                cur = _freeze_dims([None] * tin.spec.ndim)
            want = _freeze_dims(cand.in_dims[ii] if ii < len(cand.in_dims)
                                else [None] * tin.spec.ndim)
            edge_comm += cm.reshard_time(tin.spec, list(cur), list(want), machine)
        # same overlap-aware accumulation as the frontier DP (search/dp.py)
        op_comm = cand.extra_comm + cm.grad_sync_time(
            layer.weight_specs, cand.weight_dims, machine,
            _batch_axes(machine))
        comp = max(0.0, cand.op_time(layer, machine) - op_comm)
        total += cm.overlapped_step_cost(comp, edge_comm + op_comm, machine)
        for oi, o in enumerate(layer.outputs):
            lay[o.guid] = _freeze_dims(
                cand.out_dims[oi] if oi < len(cand.out_dims)
                else [None] * o.spec.ndim)
    return total


def mcmc_optimize(model, machine: MachineSpec, budget: int = 500,
                  alpha: float = 0.05, seed: int = 0,
                  enable_parameter: bool = True,
                  enable_attribute: bool = True,
                  evaluator: str = "additive") -> Tuple[Strategy, MCMCStats]:
    """Simulated annealing over per-op candidates (reference
    model.cc:3286-3357: start from the data-parallel config, propose
    single-op rewrites, accept by the Metropolis rule).

    evaluator="taskgraph" scores each full assignment by the event-driven
    simulator (search/simulator.py) instead of the additive sum, as the
    reference's MCMC evaluated through its task-graph simulator."""
    rng = random.Random(seed)
    layers = topo_order(model.layers)
    batch_sizes = {t.shape[0] for t in model.input_tensors if t.ndim > 0}
    cand_lists = {l.name: layer_candidates(l, machine, batch_sizes,
                                           enable_parameter, enable_attribute)
                  for l in layers}
    mutable = [l.name for l in layers if len(cand_lists[l.name]) > 1]
    # start data-parallel (the reference starts from the default config)
    assignment = {l.name: 0 for l in layers}

    if evaluator == "taskgraph":
        from flexflow_tpu_torch.search.simulator import simulate_strategy

        def _eval(assign):
            choices = {n: cand_lists[n][i] for n, i in assign.items()}
            return simulate_strategy(model, choices, machine).makespan
    else:
        def _eval(assign):
            return assignment_cost(layers, model.input_tensors, assign,
                                   cand_lists, machine)

    cur = _eval(assignment)
    best, best_assign = cur, dict(assignment)
    stats = MCMCStats(init_cost=cur, best_cost=cur)
    for _step in range(budget if mutable else 0):
        stats.steps += 1
        name = rng.choice(mutable)
        old = assignment[name]
        choices = [i for i in range(len(cand_lists[name])) if i != old]
        assignment[name] = rng.choice(choices)
        nxt = _eval(assignment)
        delta = nxt - cur
        if delta <= 0 or rng.random() < math.exp(-alpha * delta / max(best, 1e-12)):
            cur = nxt
            stats.accepted += 1
            if cur < best:
                best, best_assign = cur, dict(assignment)
                stats.improved += 1
        else:
            assignment[name] = old  # reject: revert
    stats.best_cost = best

    st = Strategy(mesh_axes=dict(machine.mesh_axes), name=f"mcmc(cost={best * 1e3:.3f}ms)")
    for t in model.input_tensors:
        st.input_shardings[t.name] = _dp_dims(t.shape, machine, batch_sizes)
    for layer in layers:
        cand = cand_lists[layer.name][best_assign[layer.name]]
        if cand.passthrough:
            continue
        st.op_shardings[layer.name] = OpSharding(
            outputs=[list(d) for d in cand.out_dims],
            weights={w: list(d) for w, d in cand.weight_dims.items()},
            attrs=candidate_attrs(cand),
        )
    return st, stats
