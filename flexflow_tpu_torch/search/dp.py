"""Frontier dynamic program with beam pruning
(counterpart: flexflow_tpu/search/dp.py).

Reference analog: `SearchHelper::graph_cost<T>` (src/runtime/graph.cc:1586),
Unity's memoized DP over sequence and nonsequence splits. Processing
layers in topological order, the DP state is the layout assignment of the
live frontier (tensors still awaited by a future consumer). On a chain
the frontier is one tensor and the DP is exact; at joins (residual
connections) the frontier carries both tensors, which prices the branch
interaction exactly. Beam pruning bounds the state count on wide graphs.

Memory is tracked per state and a quadratic penalty applies beyond the HBM
budget (the memory-aware lambda search analog, graph.cc:2046-2160). The
pipelined cut search (`stage_machine_for`, `search_pipelined`) is not
ported yet: it comes with the pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.search import cost_model as cm
from flexflow_tpu_torch.search import memo
from flexflow_tpu_torch.search.candidates import Candidate, layer_candidates

# Process-wide search instrumentation (the search fast path's observable):
# calls = search_graph invocations, expansions = (beam entry x candidate)
# inner-loop evaluations (the DP's unit of work — a strategy-cache hit must
# leave this at 0), layers_skipped / prefix_hits = tier-3 prefix reuse.
SEARCH_STATS: Dict[str, int] = {}


def reset_search_stats() -> None:
    SEARCH_STATS.update(calls=0, expansions=0, layers_skipped=0,
                        prefix_hits=0, prefix_misses=0)


reset_search_stats()


# canonical None|str|tuple form per dim — ONE implementation, shared with
# the memo/prefix-cache keys so layout canonicalization can never drift
# between the DP's frontier keys and the tier-2/3 cache keys
_freeze_dims = memo.freeze_dims


def _drop_axis(d, ax):
    if ax is None:
        return d
    if d == ax:
        return None
    if isinstance(d, tuple):
        kept = tuple(a for a in d if a != ax)
        return kept if len(kept) > 1 else (kept[0] if kept else None)
    return d


def _score(cost: float, mem: int, mem_budget: float) -> float:
    """Cost scaled by a quadratic over-HBM penalty (memory-aware lambda
    analog). Multiplicative so the penalty has the same units as the cost;
    the small floor keeps the penalty alive even at zero accumulated cost.
    Under the budget the rank is by time alone."""
    if mem > mem_budget:
        over = (mem - mem_budget) / mem_budget
        return (cost + 1e-9) * (1.0 + 10.0 * over * over)
    return cost


@dataclasses.dataclass
class SearchResult:
    choices: Dict[str, Candidate]  # layer name -> chosen candidate
    cost: float                    # predicted step time (s)
    mem_bytes: int                 # predicted per-device memory high-water
    # layer name -> chosen remat policy ("dots"/"full"; "none" omitted) —
    # populated only when the DP searched remat_policies
    remat: Dict[str, str] = dataclasses.field(default_factory=dict)


# ------------------------------------------------- tier-3 incremental DP
class DPPrefixCache:
    """Cross-graph reuse of DP beam states for the substitution loop.

    After a GraphXfer rewrite, every layer BEFORE the rewrite site is
    unchanged — but `search_graph` re-ran the whole frontier DP anyway.
    This cache snapshots the (pruned) beam after each layer, keyed by a
    canonical, name/guid-free identity of the graph prefix plus the set of
    prefix tensors still live at that boundary; a later `search_graph` on a
    rewritten clone resumes from the deepest matching snapshot and only
    re-prices the affected frontier window (the analog of the reference's
    memoized sequence-split sub-results, graph.cc:1586).

    Correctness: two graphs share a snapshot iff (a) their prefix rows
    (op/params/wiring/pins/weight specs + graph-input specs) are identical —
    so per-layer candidates, edge costs and within-prefix liveness coincide
    — and (b) the set of prefix tensors consumed at-or-after the boundary is
    identical (frontier composition depends on suffix consumption). Beam
    frontiers are stored under canonical tensor coordinates (producer topo
    position, output slot) and remapped to the resuming graph's guids.

    One instance is only valid for a fixed (machine, beam_width, mem_budget,
    cost_fn, enable flags) — stored traces index into the candidate lists —
    and the substitution loop creates one per search.
    """

    def __init__(self, max_entries: int = 100_000):
        self.snaps: Dict[Tuple, Dict] = {}
        self.max_entries = max_entries

    def get(self, key):
        return self.snaps.get(key)

    def put(self, key, beam):
        if len(self.snaps) < self.max_entries:
            self.snaps[key] = beam


def _prefix_identity(layers, input_tensors, pins):
    """Per-layer cumulative canonical keys + guid -> coordinate map. A
    coordinate is ("in", input_idx) or (producer_topo_idx, output_slot).
    Keys are rolling sha256 hexdigests of the canonical rows — O(row) per
    layer and O(1) to hash/compare in the snapshot dict (a nested-tuple
    chain would re-walk the whole prefix on every lookup)."""
    import hashlib

    from flexflow_tpu_torch.search.pcg import _freeze as _freeze_params

    coords: Dict[int, Tuple] = {
        t.guid: ("in", i) for i, t in enumerate(input_tensors)}
    h = hashlib.sha256(repr(tuple(
        (t.spec.shape, t.spec.dtype) for t in input_tensors)).encode())
    keys = []
    for li, layer in enumerate(layers):
        row = (layer.op_type.value, _freeze_params(layer.params),
               tuple(coords.get(t.guid, ("?", t.guid)) for t in layer.inputs),
               pins.get(layer.name) if pins else None,
               memo.freeze_weight_specs(layer.weight_specs),
               memo.branches_signature(layer))
        h.update(repr(row).encode())
        keys.append(h.hexdigest())  # digest-so-far: cumulative prefix id
        for oi, o in enumerate(layer.outputs):
            coords[o.guid] = (li, oi)
    return keys, coords


def _live_coords(li, n_layers, coords, last_use):
    """Canonical coords of tensors in the DP frontier after layer li (the
    exact rule the DP applies: produced at or before li, consumed after li —
    plus the last layer's outputs, which the DP always keeps)."""
    out = set()
    for g, c in coords.items():
        produced = -1 if c[0] == "in" else c[0]
        if produced > li:
            continue
        if last_use.get(g, -1) > li or (li == n_layers - 1 and produced == li):
            out.add(c)
    return frozenset(out)


def search_graph(model, machine, *args, **kwargs):
    """One `search/dp` span per DP run (telemetry.py), carrying the
    expansions this run added to SEARCH_STATS, over `_search_graph_impl`
    (the signature and the docstring below)."""
    if not tel.enabled():
        return _search_graph_impl(model, machine, *args, **kwargs)
    t0 = tel.now_us()
    e0 = SEARCH_STATS.get("expansions", 0)
    r = _search_graph_impl(model, machine, *args, **kwargs)
    tel.record("search/dp", t0, cat="compile",
               layers=len(model.layers),
               expansions=SEARCH_STATS.get("expansions", 0) - e0,
               cost_s=(r.cost if not isinstance(r, list)
                       else (r[0].cost if r else None)))
    return r


def _search_graph_impl(model, machine: MachineSpec, beam_width: int = 64,
                 enable_parameter: bool = True, enable_attribute: bool = True,
                 mem_budget: Optional[float] = None,
                 cost_fn=None,
                 pins: Optional[Dict[str, str]] = None,
                 prefix_cache: Optional[DPPrefixCache] = None,
                 opt_mem: "Optional[cm.OptMemSpec]" = None,
                 remat_policies: Optional[Sequence[str]] = None,
                 ) -> SearchResult:
    """The best SearchResult for `model` (anything with .layers /
    .input_tensors: an FFModel or a PCG) on `machine`.

    `cost_fn(layer, cand) -> seconds` overrides the analytic op time (the
    measured path, search/measure.py).

    `remat_policies` makes rematerialization a PER-LAYER search dimension:
    each compute candidate expands once per policy in the set
    (cost_model.REMAT_POLICY_SPECS — none / dots / full), the policy's
    recompute time is added to the step cost and its keep fraction scales
    the layer outputs' live-activation multiplier, so under a memory cap
    the DP trades HBM for FLOPs layer by layer. None / ("none",)
    reproduces the DP without remat: same expansions, costs and memory.

    `opt_mem` (cost_model.OptMemSpec) is the optimizer's memory model:
    moments counted and sized by the optimizer's actual state dtype. None
    keeps the legacy params-x4 accounting.

    `prefix_cache` (tier-3 fast path) resumes the DP from the deepest beam
    snapshot whose canonical graph prefix + boundary liveness match this
    graph, re-pricing only the frontier window a rewrite touched. The
    caller guarantees one cache instance per (machine, beam_width,
    mem_budget, cost_fn, enable flags) combination.

    `pins` restricts named layers to one candidate (by candidate name) —
    the substitution engine's hook: a rewritten PCG is costed with its
    rewrite choices pinned while the DP still lays out every unpinned op."""
    SEARCH_STATS["calls"] = SEARCH_STATS.get("calls", 0) + 1
    layers = topo_order(model.layers)
    batch_sizes = {t.shape[0] for t in model.input_tensors if t.ndim > 0}
    mem_budget = mem_budget or machine.hbm_bytes
    from flexflow_tpu_torch.search.candidates import _batch_axes

    _batch_axes_cached = _batch_axes(machine)

    # liveness: tensor guid -> index of last consuming layer
    last_use: Dict[int, int] = {}
    for li, layer in enumerate(layers):
        for t in layer.inputs:
            last_use[t.guid] = li

    # initial frontier: graph inputs, data-parallel layout
    from flexflow_tpu_torch.search.candidates import _dp_dims

    init_frontier = tuple(sorted(
        (t.guid, _freeze_dims(_dp_dims(t.shape, machine, batch_sizes)))
        for t in model.input_tensors))
    specs = {t.guid: t.spec for t in model.input_tensors}

    # forward value + gradient held for the backward pass
    act_mult = 2

    # searched remat: "none" is always present at index 0 (passthrough
    # candidates pin to it, and the search must be able to keep any layer
    # unrematerialized).
    policies: Tuple[str, ...] = tuple(dict.fromkeys(
        ("none",) + tuple(remat_policies or ())))

    def _live_act_bytes(frontier_map, mults=None) -> int:
        # act_mult x: forward value + gradient held for the backward pass;
        # outputs of remat'd layers carry a reduced per-guid multiplier
        # (cost_model.remat_act_mult)
        if not mults:
            return sum(act_mult * cm.shard_bytes(specs[g], list(d), machine)
                       for g, d in frontier_map.items())
        return int(sum(
            mults.get(g, act_mult) * cm.shard_bytes(specs[g], list(d),
                                                    machine)
            for g, d in frontier_map.items()))

    def score(c: float, m: int) -> float:
        return _score(c, m, mem_budget)

    # beam entries: frontier -> (cost, w_mem, act_high, trace, mults)
    # w_mem = cumulative persistent weight memory (params+grads+opt moments:
    # ALL of it is resident for the whole step, init allocates up front);
    # act_high = max over layers of live activation bytes. The reported
    # high-water is final_w_mem + act_high — weights from layers not yet
    # processed are still counted against an early activation peak.
    # trace elements are (candidate_idx, policy_idx); mults maps a frontier
    # guid to its effective activation multiplier when a remat policy
    # reduced it (absent guid = act_mult).
    init_act = _live_act_bytes(dict(init_frontier))
    beam: Dict[Tuple, Tuple[float, int, int, Tuple, Dict[int, float]]] = {
        init_frontier: (0.0, 0, init_act, (), {})}
    cand_cache: Dict[str, List[Candidate]] = {}

    # tier-3: resume from the deepest matching prefix snapshot
    resume_li = -1
    pc_keys = pc_coords = None
    if prefix_cache is not None:
        pc_keys, pc_coords = _prefix_identity(layers, model.input_tensors,
                                              pins)
        inv = {c: g for g, c in pc_coords.items()}
        for li in range(len(layers) - 1, -1, -1):
            live = _live_coords(li, len(layers), pc_coords, last_use)
            snap = prefix_cache.get((pc_keys[li], live))
            if snap is None:
                continue
            resumed = {}
            for cf, entry in snap.items():
                guids = [(inv.get(c), d) for c, d in cf]
                if any(g is None for g, _ in guids):
                    resumed = None
                    break
                # entry mults were stored under canonical coords too —
                # remap back to this graph's guids (all mult guids are
                # frontier guids, so the same inv map covers them)
                ec, ew, ea, et, emu = entry
                mu = {inv[c]: m for c, m in emu}
                resumed[tuple(sorted(guids))] = (ec, ew, ea, et, mu)
            if resumed:
                beam = resumed
                resume_li = li
                SEARCH_STATS["prefix_hits"] = SEARCH_STATS.get(
                    "prefix_hits", 0) + 1
                SEARCH_STATS["layers_skipped"] = SEARCH_STATS.get(
                    "layers_skipped", 0) + li + 1
                break
        else:
            SEARCH_STATS["prefix_misses"] = SEARCH_STATS.get(
                "prefix_misses", 0) + 1

    for li, layer in enumerate(layers):
        for o in layer.outputs:
            specs[o.guid] = o.spec
        cands = layer_candidates(layer, machine, batch_sizes,
                                 enable_parameter, enable_attribute)
        if pins and layer.name in pins:
            want = pins[layer.name]
            sel = [c for c in cands if c.name == want]
            if not sel:
                raise KeyError(f"pinned candidate {want!r} not available for "
                               f"{layer.name} (have {[c.name for c in cands]})")
            cands = sel
        cand_cache[layer.name] = cands
        if li <= resume_li:
            continue  # beam restored from snapshot; candidates only decode traces
        new_beam: Dict[Tuple, Tuple[float, int, int, Tuple, Dict]] = {}
        for frontier, (cost, w_mem, act_high, trace, mults) in beam.items():
            fmap = dict(frontier)
            fmap_act = _live_act_bytes(fmap, mults)

            def commit(c, wm, out_dims, new_mults, ci, pi):
                # peak while this layer runs: ALL its inputs (even those
                # dying here) are live together with its outputs (out guids
                # are new, so the two contributions are disjoint)
                ah = max(act_high,
                         fmap_act + _live_act_bytes(out_dims, new_mults))
                # new frontier: drop dead tensors, add outputs
                nf = {g: d for g, d in fmap.items()
                      if last_use.get(g, -1) > li}
                for o in layer.outputs:
                    if last_use.get(o.guid, -1) > li or layer is layers[-1]:
                        nf[o.guid] = out_dims[o.guid]
                nm = {g: m for g, m in new_mults.items() if g in nf} \
                    if new_mults else {}
                key = tuple(sorted(nf.items()))
                prev = new_beam.get(key)
                if prev is None or score(c, wm + ah) < score(
                        prev[0], prev[1] + prev[2]):
                    new_beam[key] = (c, wm, ah, trace + ((ci, pi),), nm)

            for ci, cand in enumerate(cands):
                if cand.passthrough:
                    SEARCH_STATS["expansions"] = SEARCH_STATS.get(
                        "expansions", 0) + 1
                    c = cost
                    # identity layout marker: adopt input-0's layout (minus
                    # drop_axis). When dropping the axis actually changes the
                    # layout (the input really was sharded over it), the
                    # implied all-gather is priced — a free drop would let
                    # the search hide a real collective (e.g. a tp_col
                    # output feeding a later rewrite's Replicate).
                    cur0 = fmap.get(layer.inputs[0].guid) if layer.inputs else None
                    if cur0 is None:
                        continue
                    od = tuple(_drop_axis(d, cand.drop_axis) for d in cur0)
                    if od != cur0:
                        c += cm.reshard_time(layer.inputs[0].spec,
                                             list(cur0), list(od), machine)
                    # passthrough outputs alias input-0: they inherit its
                    # multiplier (a remat'd producer's saving propagates
                    # through resharding markers), and "none" (index 0) is
                    # the only policy — there is no compute to re-run
                    nm = mults
                    if mults and layer.inputs:
                        m0 = mults.get(layer.inputs[0].guid)
                        if m0 is not None:
                            nm = dict(mults)
                            for o in layer.outputs:
                                nm[o.guid] = m0
                    commit(c, w_mem, {o.guid: od for o in layer.outputs},
                           nm, ci, 0)
                    continue
                SEARCH_STATS["expansions"] = SEARCH_STATS.get(
                    "expansions", 0) + 1
                # edge costs: reshard each input from its frontier layout
                feasible = True
                edge_comm = 0.0
                for ii, tin in enumerate(layer.inputs):
                    cur = fmap.get(tin.guid)
                    if cur is None:
                        feasible = False
                        break
                    want = _freeze_dims(cand.in_dims[ii] if ii < len(cand.in_dims)
                                        else [None] * tin.spec.ndim)
                    edge_comm += cm.reshard_time(tin.spec, list(cur), list(want), machine)
                if not feasible:
                    continue
                total = cost_fn(layer, cand) if cost_fn else cand.op_time(layer, machine)
                # compute/comm overlap (the event-driven-simulator gap,
                # reference simulator.h:785-827, closed-form): async
                # collectives hide input-edge + op-inherent collective
                # time behind up to overlap_frac of the consumer's pure
                # compute. Purely additive costing
                # (overlap_frac=0) systematically over-prices strategies
                # whose collectives ride behind the next op's matmuls.
                op_comm = cand.extra_comm + cm.grad_sync_time(
                    layer.weight_specs, cand.weight_dims, machine,
                    _batch_axes_cached,
                    zero=bool(opt_mem and opt_mem.zero_axes))
                comp = max(0.0, total - op_comm)
                base_c = cost + cm.overlapped_step_cost(
                    comp, edge_comm + op_comm, machine)
                wm = w_mem + cand.weight_mem_bytes(layer, machine, opt_mem)
                out_dims = {
                    o.guid: _freeze_dims(cand.out_dims[oi] if oi < len(cand.out_dims)
                                         else [None] * o.spec.ndim)
                    for oi, o in enumerate(layer.outputs)}
                # the remat dimension: one expansion per policy — "none"
                # replays the pre-remat DP exactly; "dots"/"full" pay the
                # recompute fraction of THIS op's step cost and shrink the
                # outputs' live multiplier (cost_model REMAT_POLICY_SPECS)
                for pi, pol in enumerate(policies):
                    if pi:  # the "none" expansion was counted above
                        SEARCH_STATS["expansions"] = SEARCH_STATS.get(
                            "expansions", 0) + 1
                    if pol == "none":
                        commit(base_c, wm, out_dims, mults, ci, pi)
                        continue
                    c = base_c + cm.remat_recompute_time(total, pol)
                    pm = cm.remat_act_mult(pol, act_mult)
                    nm = dict(mults)
                    for o in layer.outputs:
                        nm[o.guid] = pm
                    commit(c, wm, out_dims, nm, ci, pi)
        # beam prune (ranked by cost + memory penalty; wm+ah understates the
        # final high-water by weights not yet placed, uniformly across states)
        if len(new_beam) > beam_width:
            ranked = sorted(new_beam.items(),
                            key=lambda kv: score(kv[1][0], kv[1][1] + kv[1][2]))
            new_beam = dict(ranked[:beam_width])
        beam = new_beam
        if not beam:
            raise RuntimeError(f"search dead-ended at layer {layer.name}")
        if prefix_cache is not None:
            # snapshot the pruned beam under canonical coordinates (store
            # key carries the boundary liveness so only suffixes consuming
            # the same prefix tensors resume from it)
            live = _live_coords(li, len(layers), pc_coords, last_use)
            # key=repr: coords mix ("in", i) and (topo_idx, slot) tuples,
            # which plain tuple ordering cannot compare
            snap = {}
            for f, e in beam.items():
                ec, ew, ea, et, emu = e
                cmu = tuple(sorted(((pc_coords[g], m)
                                    for g, m in emu.items()), key=repr))
                snap[tuple(sorted(((pc_coords[g], d) for g, d in f),
                                  key=repr))] = (ec, ew, ea, et, cmu)
            prefix_cache.put((pc_keys[li], live), snap)

    def _to_result(entry) -> SearchResult:
        cost, wm, ah, trace, _mults = entry
        choices: Dict[str, Candidate] = {}
        remat: Dict[str, str] = {}
        for layer, (ci, pi) in zip(layers, trace):
            choices[layer.name] = cand_cache[layer.name][ci]
            if policies[pi] != "none":
                remat[layer.name] = policies[pi]
        return SearchResult(choices=choices, cost=cost, mem_bytes=wm + ah,
                            remat=remat)

    ranked = sorted(beam.values(),
                    key=lambda v: score(v[0], v[1] + v[2]))
    return _to_result(ranked[0])
