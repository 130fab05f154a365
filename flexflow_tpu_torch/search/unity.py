"""Unity outer loop: best-first graph-substitution search
(counterpart: flexflow_tpu/search/unity.py).

Reference analog: `GraphSearchHelper::graph_optimize`
(src/runtime/substitution.cc:1898-1945) → `generic_sequence_optimize`
(recursive split at single-tensor cut points when the graph exceeds
`base_optimize_threshold`, :2094) → `base_optimize` (best-first over
GraphXfer applications with budget + alpha pruning, :2229-2311), each
candidate graph costed by the SearchHelper DP (graph.cc:1586).

Candidates are PCGs (search/pcg.py) rewritten by GraphXfers
(search/substitution.py); each is costed by the frontier DP (search/dp.py)
with the rewrite's layout choices pinned. The winner dissolves into a
Strategy: per-op output/weight DimShardings, with inserted parallel-op
nodes becoming the output constraint of their upstream producer (where
the collective the node represents runs).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.parallel.sharding import OpSharding, Strategy
from flexflow_tpu_torch.search import memo
from flexflow_tpu_torch.search.candidates import _dp_dims, candidate_attrs
from flexflow_tpu_torch.search.dp import (
    SEARCH_STATS,
    DPPrefixCache,
    SearchResult,
    _drop_axis,
    _freeze_dims,
    search_graph,
)
from flexflow_tpu_torch.search.pcg import PCG
from flexflow_tpu_torch.search.substitution import (
    GraphXfer,
    find_matches,
    generate_pcg_xfers,
    load_substitution_json,
)


@dataclasses.dataclass
class UnityStats:
    expansions: int = 0
    generated: int = 0
    deduped: int = 0
    pruned: int = 0
    best_cost: float = 0.0
    baseline_cost: float = 0.0
    json_rules: Optional[Dict] = None
    # rewrite path to the winner: ((xfer_index, matched topo positions), ...)
    # — replayable onto a structurally identical graph (segment memoization)
    best_path: Tuple = ()
    segments_replayed: int = 0
    # the learned pruner's cuts: layout finalists dropped before the
    # event-driven re-rank (per-layer candidate cuts are counted in
    # dp.SEARCH_STATS["cands_pruned"]: they happen inside the DP)
    finalists_pruned: int = 0
    # the DP's PER-OP cost under the winning strategy, model layer name ->
    # seconds — what the search believed each op costs (stamped on the
    # Strategy by graph_optimize)
    op_costs: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def improvement(self) -> float:
        return self.baseline_cost / self.best_cost if self.best_cost else 1.0


def substitution_optimize(pcg: PCG, machine: MachineSpec,
                          xfers: List[GraphXfer],
                          budget: int = 32, alpha: float = 1.05,
                          beam_width: int = 16,
                          mem_budget: Optional[float] = None,
                          cost_fn=None,
                          enable_parameter: bool = True,
                          enable_attribute: bool = True,
                          dp_cache: Optional[DPPrefixCache] = None,
                          opt_mem=None,
                          remat_policies=None,
                          learned=None,
                          ) -> Tuple[PCG, SearchResult, UnityStats]:
    """Best-first search over xfer applications (base_optimize analog).

    budget = max candidate-graph expansions; alpha prunes any graph costing
    more than alpha * best (reference best-first pruning semantics).
    `dp_cache` (tier-3 fast path) shares DP beam snapshots across the
    candidate graphs, so each rewrite only re-prices the frontier window it
    touched — it must be dedicated to this (machine, knobs, cost_fn)."""
    if dp_cache is None and memo.enabled():
        dp_cache = DPPrefixCache()

    def cost(g: PCG) -> SearchResult:
        return search_graph(g, machine, beam_width=beam_width,
                            mem_budget=mem_budget, cost_fn=cost_fn,
                            enable_parameter=enable_parameter,
                            enable_attribute=enable_attribute,
                            pins=g.pins, prefix_cache=dp_cache,
                            opt_mem=opt_mem, remat_policies=remat_policies,
                            learned=learned)

    r0 = cost(pcg)
    stats = UnityStats(baseline_cost=r0.cost, best_cost=r0.cost)
    best, best_r = pcg, r0
    seen = {pcg.key()}
    counter = 0  # heap tiebreak
    heap: List[Tuple[float, int, PCG, Tuple]] = [(r0.cost, counter, pcg, ())]
    while heap and stats.expansions < budget:
        c, _, g, path = heapq.heappop(heap)
        if c > alpha * best_r.cost:
            stats.pruned += 1
            continue
        stats.expansions += 1
        t_exp = tel.now_us() if tel.enabled() else None
        order = topo_order(g.layers)
        pos = {id(l): i for i, l in enumerate(order)}
        for xi, xfer in enumerate(xfers):
            for match in find_matches(xfer.src, g):
                try:
                    ng = xfer.apply(g, match)
                except (KeyError, ValueError):
                    ng = None
                if ng is None:
                    continue
                k = ng.key()
                if k in seen:
                    stats.deduped += 1
                    continue
                seen.add(k)
                try:
                    nr = cost(ng)
                except (KeyError, RuntimeError):
                    continue  # infeasible rewrite (pin missing / dead end)
                stats.generated += 1
                npath = path + ((xi, tuple(pos[id(m)] for m in match)),)
                if nr.cost < best_r.cost:
                    best, best_r = ng, nr
                    stats.best_path = npath
                if nr.cost <= alpha * best_r.cost:
                    counter += 1
                    heapq.heappush(heap, (nr.cost, counter, ng, npath))
        if t_exp is not None:
            tel.record("search/substitution_round", t_exp, cat="compile",
                       expansion=stats.expansions, frontier_cost_s=c)
    stats.best_cost = best_r.cost
    return best, best_r, stats


def replay_path(pcg: PCG, xfers: List[GraphXfer], path) -> Optional[PCG]:
    """Re-apply a recorded rewrite path onto a structurally identical PCG
    (layer names differ; topo positions coincide). Returns None when any step
    no longer applies — the caller falls back to a full search."""
    g = pcg
    for xi, positions in path:
        order = topo_order(g.layers)
        if any(p >= len(order) for p in positions) or xi >= len(xfers):
            return None
        match = [order[p] for p in positions]
        try:
            ng = xfers[xi].apply(g, match)
        except (KeyError, ValueError):
            ng = None
        if ng is None:
            return None
        g = ng
    return g


# ----------------------------------------------------- sequence splitting
def sequence_cut_indices(layers, input_tensors) -> List[int]:
    """Indices i (in topo order) after which exactly ONE tensor is live — the
    single-tensor cut points of find_split_node (substitution.cc:2094)."""
    order = topo_order(layers)
    last_use: Dict[int, int] = {}
    for li, layer in enumerate(order):
        for t in layer.inputs:
            last_use[t.guid] = li
    live = {t.guid for t in input_tensors}
    cuts = []
    for li, layer in enumerate(order[:-1]):
        live = {g for g in live if last_use.get(g, -1) > li}
        for o in layer.outputs:
            if last_use.get(o.guid, -1) > li:
                live.add(o.guid)
        if len(live) == 1 and next(iter(live)) in {o.guid for o in layer.outputs}:
            cuts.append(li)
    return cuts


def _segment_pcgs(pcg: PCG, threshold: int,
                  machine: Optional[MachineSpec] = None) -> List[PCG]:
    """Split the PCG at single-tensor cut points into segments of at most
    ~threshold layers (generic_sequence_optimize analog). Boundary tensors
    take the data-parallel layout on both sides."""
    order = topo_order(pcg.layers)
    if len(order) <= threshold:
        return [pcg]
    cuts = sequence_cut_indices(order, pcg.input_tensors)
    if not cuts:
        return [pcg]
    # choose cuts so each segment stays near the threshold
    chosen, last = [], -1
    for c in cuts:
        if c - last >= threshold:
            chosen.append(c)
            last = c
    if not chosen:
        chosen = [cuts[len(cuts) // 2]]
    segments: List[PCG] = []
    start = 0
    bounds = chosen + [len(order) - 1]
    for si, end in enumerate(bounds):
        seg_layers = order[start:end + 1]
        ext_inputs = []
        seen_guids = set()
        internal = {o.guid for l in seg_layers for o in l.outputs}
        for l in seg_layers:
            for t in l.inputs:
                if t.guid not in internal and t.guid not in seen_guids:
                    seen_guids.add(t.guid)
                    ext_inputs.append(t)
        seg = PCG.from_layers(seg_layers, ext_inputs)
        if si < len(bounds) - 1 and machine is not None:
            _pin_boundary_dp(seg, machine)
        segments.append(seg)
        start = end + 1
    return segments


def _pin_boundary_dp(seg: PCG, machine: MachineSpec):
    """Force a segment's boundary output to the data-parallel layout the next
    segment's initial frontier assumes, so the cross-segment reshard is
    priced inside this segment (reference: the sequence split enumerates the
    cut tensor's machine views; we fix it to the DP view on both sides)."""
    last = topo_order(seg.layers)[-1]
    out = last.outputs[0]
    batch_sizes = {t.shape[0] for t in seg.input_tensors if t.ndim > 0}
    dims = _dp_dims(out.spec.shape, machine, batch_sizes)
    seg.insert_after(out, OperatorType.FUSED_PARALLEL, {"dims": list(dims)},
                     name=f"{last.name}_boundary")


# --------------------------------------------------- strategy extraction
def _tensor_layouts(pcg: PCG, machine: MachineSpec, result: SearchResult):
    batch_sizes = {t.shape[0] for t in pcg.input_tensors if t.ndim > 0}
    lay: Dict[int, tuple] = {
        t.guid: _freeze_dims(_dp_dims(t.shape, machine, batch_sizes))
        for t in pcg.input_tensors}
    for layer in topo_order(pcg.layers):
        cand = result.choices[layer.name]
        if cand.passthrough:
            src = lay[layer.inputs[0].guid]
            od = tuple(_drop_axis(d, cand.drop_axis) for d in src)
            for o in layer.outputs:
                lay[o.guid] = od
        else:
            for oi, o in enumerate(layer.outputs):
                lay[o.guid] = _freeze_dims(
                    cand.out_dims[oi] if oi < len(cand.out_dims)
                    else [None] * o.spec.ndim)
    return lay


def strategy_from_pcg(pcg: PCG, machine: MachineSpec, result: SearchResult,
                      model_layer_names, model_input_names,
                      strategy: Optional[Strategy] = None) -> Strategy:
    """Dissolve the winning PCG into a Strategy over the REAL model graph:
    compute layers keep their chosen shardings; each inserted parallel-op
    node overrides its upstream model producer's output sharding (that is
    where the collective the node represents runs)."""
    st = strategy or Strategy(mesh_axes=dict(machine.mesh_axes), name="unity")
    lay = _tensor_layouts(pcg, machine, result)
    for t in pcg.input_tensors:
        if t.name in model_input_names:
            st.input_shardings[t.name] = [_unfreeze(d) for d in lay[t.guid]]
    inserted = []
    for layer in topo_order(pcg.layers):
        cand = result.choices[layer.name]
        if layer.name in model_layer_names:
            st.op_shardings[layer.name] = OpSharding(
                outputs=[[_unfreeze(d) for d in lay[o.guid]] for o in layer.outputs],
                weights={w: list(d) for w, d in cand.weight_dims.items()},
                attrs=candidate_attrs(cand),
            )
        else:
            inserted.append(layer)
    for node in inserted:  # topo order: last override on a chain wins
        src = node.inputs[0]
        base, base_idx = _model_producer(src, model_layer_names)
        dims = [_unfreeze(d) for d in lay[node.outputs[0].guid]]
        if base is None:
            if src.name in model_input_names:
                st.input_shardings[src.name] = dims
            continue
        sh = st.op_shardings.get(base.name)
        if sh and base_idx < len(sh.outputs):
            sh.outputs[base_idx] = dims
    if result.remat:
        rm = dict(st.remat or {})
        rm.update({n: p for n, p in result.remat.items()
                   if n in model_layer_names})
        if rm:
            st.remat = rm
    return st


def _model_producer(tensor, model_layer_names):
    """Walk up through inserted (non-model) single-input nodes."""
    t = tensor
    while t.owner is not None and t.owner.name not in model_layer_names:
        if not t.owner.inputs:
            return None, 0
        t = t.owner.inputs[0]
    return (t.owner, t.owner_idx) if t.owner is not None else (None, 0)


def _unfreeze(d):
    return list(d) if isinstance(d, tuple) else d


# ------------------------------------------------------------ entry point
def unity_optimize(model, machine: MachineSpec, cost_fn=None,
                   opt_mem=None, learned=None) -> Tuple[Strategy, UnityStats]:
    """graph_optimize with the substitution engine (the Unity search).

    Honors FFConfig: search_budget (expansion budget), search_alpha (prune
    factor), base_optimize_threshold (sequence-split segment size),
    substitution_json (extra rules in the reference schema), memory_search,
    remat_search, and simulator_mode with simulator_topk and
    simulator_segment_size: "taskgraph" re-ranks each segment's top DP
    finalists by the event-driven replay (search/simulator.py), "learned"
    (with `learned`, a search/learned_cost.LearnedCost) prunes candidates
    and finalists by the learned model and prices the re-rank with it."""
    cfg = model.config
    en_param = cfg.enable_parameter_parallel and not cfg.only_data_parallel
    en_attr = cfg.enable_attribute_parallel and not cfg.only_data_parallel
    xfers = generate_pcg_xfers(machine, enable_parameter=en_param,
                               enable_attribute=en_attr)
    stats_all = UnityStats()
    if cfg.substitution_json:
        jx, report = load_substitution_json(cfg.substitution_json, machine)
        xfers += jx
        stats_all.json_rules = report
    pcg = PCG.from_model(model)
    mem_budget = machine.hbm_bytes if cfg.memory_search else None
    # searched remat: the per-layer policy set the DP expands over. None
    # keeps the exact search without remat (same expansion counts).
    remat_policies = (cfg.remat_policy_list()
                      if getattr(cfg, "remat_search", False) else None)
    segments = _segment_pcgs(pcg, max(2, cfg.base_optimize_threshold), machine)
    # search_budget is a GLOBAL expansion budget: structurally identical
    # segments (GPT-2's repeated blocks — equal PCG canonical keys) are
    # searched ONCE and the winning rewrite path is replayed onto the rest,
    # so the budget divides over the UNIQUE segment shapes only. The budget
    # widens the layout-DP beam too, capped so costing work doesn't scale
    # quadratically with it.
    beam_width = max(16, min(cfg.search_budget, 64))
    keys = [seg.key() for seg in segments]
    budget_left = max(8, cfg.search_budget)
    # seg key -> (rewrite path, baseline_cost, refined candidate names in
    # topo order once the re-rank ran — replayed as pins — or None)
    seg_memo: Dict[Tuple, Tuple] = {}
    st = Strategy(mesh_axes=dict(machine.mesh_axes), name="unity")
    model_layer_names = {l.name for l in model.layers}
    model_input_names = {t.name for t in model.input_tensors}
    for t in model.input_tensors:
        batch_sizes = {x.shape[0] for x in model.input_tensors if x.ndim > 0}
        st.input_shardings[t.name] = _dp_dims(t.shape, machine, batch_sizes)
    # one DP prefix cache for the whole optimize call (constant machine/
    # knobs/cost_fn): segment replays and the substitution loop's candidate
    # graphs all resume from shared beam snapshots (tier-3 fast path)
    dp_cache = DPPrefixCache() if memo.enabled() else None
    # the re-rank's pick per (segment, names, DP cost): the replay is
    # deterministic in those, so an unchanged pair yields the same pick
    sim_cache: Dict[Tuple, SearchResult] = {}

    def _cost_pcg(g: PCG) -> SearchResult:
        return search_graph(g, machine, beam_width=beam_width,
                            mem_budget=mem_budget, cost_fn=cost_fn,
                            enable_parameter=en_param,
                            enable_attribute=en_attr, pins=g.pins,
                            prefix_cache=dp_cache, opt_mem=opt_mem,
                            remat_policies=remat_policies, learned=learned)

    def _sim_refine(g: PCG, r: SearchResult) -> SearchResult:
        """simulator_mode="taskgraph": the additive DP prunes, the
        event-driven replay (search/simulator.py, the reference's
        LogicalTaskgraphBasedSimulator) decides among the segment winner's
        top layout finalists by simulated makespan.

        simulator_mode="learned": the same finalists, but the learned model
        drops those whose learned score exceeds the best by its
        finalist_margin, and prices the re-rank's task times."""
        if cfg.simulator_mode not in ("taskgraph", "learned") \
                or cfg.simulator_topk < 2:
            return r
        if cfg.simulator_mode == "learned" and learned is None:
            return r
        # layer names ride the key: PCG.key() is name-free, but the cached
        # result's choices are addressed by name
        sim_key = (g.key(), tuple(l.name for l in topo_order(g.layers)),
                   r.cost)
        hit = sim_cache.get(sim_key)
        if hit is not None:
            return hit
        # one more DP per segment recovers the ranked finalists
        from flexflow_tpu_torch.search import simulator as sim

        finalists = search_graph(g, machine, beam_width=beam_width,
                                 mem_budget=mem_budget, cost_fn=cost_fn,
                                 enable_parameter=en_param,
                                 enable_attribute=en_attr, pins=g.pins,
                                 topk=cfg.simulator_topk,
                                 prefix_cache=dp_cache, opt_mem=opt_mem,
                                 remat_policies=remat_policies,
                                 learned=learned)
        if learned is not None and isinstance(finalists, list):
            kept, f_dropped = learned.prune_finalists(g, finalists)
            if f_dropped:
                stats_all.finalists_pruned += f_dropped
                SEARCH_STATS["finalists_pruned"] = SEARCH_STATS.get(
                    "finalists_pruned", 0) + f_dropped
                finalists = kept
        with tel.span("search/sim_rerank", cat="compile",
                      finalists=len(finalists)
                      if isinstance(finalists, list) else 1):
            rerank_cost = (learned.op_time if learned is not None
                           and cfg.simulator_mode == "learned" else cost_fn)
            picked, _reports = sim.rerank(
                g, machine, finalists, cost_fn=rerank_cost,
                segment_bytes=cfg.simulator_segment_size)
        sim_cache[sim_key] = picked
        return picked

    for si, (seg, k) in enumerate(zip(segments, keys)):
        best = best_r = None
        refined_done = False
        if k in seg_memo:
            path, base_cost, rnames = seg_memo[k]
            replayed = replay_path(seg, xfers, path)
            if replayed is not None:
                try:
                    if rnames is not None:
                        # a structurally identical segment: re-apply the
                        # refined choices by name as pins (topo positions
                        # coincide) instead of re-running the top-k DP and
                        # the replays for every repetition
                        pins = {l.name: nm for l, nm in
                                zip(topo_order(replayed.layers), rnames)}
                        best_r = search_graph(
                            replayed, machine, beam_width=beam_width,
                            mem_budget=mem_budget, cost_fn=cost_fn,
                            enable_parameter=en_param,
                            enable_attribute=en_attr, pins=pins,
                            prefix_cache=dp_cache, opt_mem=opt_mem,
                            remat_policies=remat_policies, learned=learned)
                        best, refined_done = replayed, True
                    else:
                        best, best_r = replayed, _cost_pcg(replayed)
                except (KeyError, RuntimeError):
                    best = best_r = None
                    refined_done = False
            if best is not None:
                stats_all.segments_replayed += 1
                stats_all.baseline_cost += base_cost
                stats_all.best_cost += best_r.cost
        if best is None:
            uniq_left = len(set(keys[si:]) - set(seg_memo))
            seg_budget = max(1, budget_left // max(1, uniq_left))
            best, best_r, stats = substitution_optimize(
                seg, machine, xfers, budget=seg_budget,
                alpha=cfg.search_alpha, beam_width=beam_width,
                mem_budget=mem_budget, cost_fn=cost_fn,
                enable_parameter=en_param, enable_attribute=en_attr,
                dp_cache=dp_cache, opt_mem=opt_mem,
                remat_policies=remat_policies, learned=learned)
            budget_left = max(0, budget_left - stats.expansions)
            seg_memo[k] = (stats.best_path, stats.baseline_cost, None)
            stats_all.expansions += stats.expansions
            stats_all.generated += stats.generated
            stats_all.deduped += stats.deduped
            stats_all.pruned += stats.pruned
            stats_all.baseline_cost += stats.baseline_cost
            stats_all.best_cost += stats.best_cost
        if not refined_done:
            refined = _sim_refine(best, best_r)
            if refined is not best_r:
                # the totals describe the returned strategy: the re-rank
                # may pick a finalist whose additive cost differs
                stats_all.best_cost += refined.cost - best_r.cost
                best_r = refined
            if (cfg.simulator_mode == "taskgraph"
                    or (cfg.simulator_mode == "learned"
                        and learned is not None)) and k in seg_memo:
                seg_memo[k] = (seg_memo[k][0], seg_memo[k][1],
                               [best_r.choices[l.name].name
                                for l in topo_order(best.layers)])
        strategy_from_pcg(best, machine, best_r, model_layer_names,
                          model_input_names, strategy=st)
        # per-op predicted costs of the winner, priced by the SAME cost
        # function the DP ranked with (measured when cost_fn is set)
        for layer in topo_order(best.layers):
            if layer.name not in model_layer_names:
                continue
            cand = best_r.choices.get(layer.name)
            if cand is None or cand.passthrough:
                continue
            stats_all.op_costs[layer.name] = float(
                cost_fn(layer, cand) if cost_fn
                else cand.op_time(layer, machine))
    st.name = (f"unity(cost={stats_all.best_cost * 1e3:.3f}ms, "
               f"x{stats_all.improvement:.2f} vs dp, "
               f"{stats_all.expansions} expansions, "
               f"{stats_all.segments_replayed} replayed)")
    return st, stats_all
