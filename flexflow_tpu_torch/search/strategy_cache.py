"""Persistent strategy cache — tier 1 of the search fast path
(counterpart: flexflow_tpu/search/strategy_cache.py).

`graph_optimize` keys the winning Strategy by

    (canonical graph hash, MachineSpec fingerprint, search-knob tuple,
     calibration fingerprint, optimizer-memory fingerprint)

and stores it on disk in the same JSON schema as `--export`, so a warm
`compile()` of an unchanged model skips the substitution search entirely —
zero DP frontier expansions — after validating that the cached strategy
still type-checks against the graph (layer names, output/weight ranks,
mesh axes).

Invalidation is purely key-based: edit the graph, change the mesh or chip
coefficients, turn a search knob, or re-measure the measured cost store
(search/measure.py's on-disk microbenchmarks — their content hash IS the
calibration fingerprint) and the key changes, forcing a fresh search. A
stale entry that survives a code drift fails the type-check and counts as
`invalidated`, never silently applied.

Layout: one `<key>.json` per entry under the cache dir
(`strategy_cache_dir` > `$FF_STRATEGY_CACHE_DIR` >
`~/.cache/flexflow_tpu_torch/strategy`), carrying the strategy plus a meta
block (fingerprints, predicted cost, search wall-clock).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, List, Optional

from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.parallel.sharding import Strategy, used_axes
from flexflow_tpu_torch.search import memo

# bump when the cached schema or the search's output semantics change in a
# way old entries must not survive
CACHE_VERSION = 1


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    stores: int = 0
    invalidated: int = 0  # key hit but the strategy no longer type-checks
    errors: int = 0       # unreadable/unwritable cache dir (degraded, not fatal)

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


STATS = CacheStats()


def resolve_dir(cfg) -> str:
    """--strategy-cache-dir > $FF_STRATEGY_CACHE_DIR > ~/.cache default."""
    d = getattr(cfg, "strategy_cache_dir", "") or \
        os.environ.get("FF_STRATEGY_CACHE_DIR", "") or \
        os.path.join("~", ".cache", "flexflow_tpu_torch", "strategy")
    return os.path.expanduser(d)


# ------------------------------------------------------------ fingerprints
def graph_fingerprint(model) -> str:
    """Canonical hash of the layer graph INCLUDING names: the cached
    strategy is name-addressed (op_shardings key on layer names), so a
    renamed twin must miss and re-search rather than hit an artifact it
    cannot apply."""
    order = topo_order(model.layers)
    idx = {id(l): i for i, l in enumerate(order)}
    in_idx = {t.guid: i for i, t in enumerate(model.input_tensors)}
    rows = [tuple((t.name, t.spec.shape, str(t.spec.dtype))
                  for t in model.input_tensors)]
    from flexflow_tpu_torch.search.pcg import _freeze as _freeze_params

    for l in order:
        ins = []
        for t in l.inputs:
            if t.owner is not None and id(t.owner) in idx:
                ins.append((idx[id(t.owner)], t.owner_idx))
            else:
                ins.append((-1, in_idx.get(t.guid, -9)))
        rows.append((l.name, l.op_type.value, _freeze_params(l.params),
                     tuple(ins), memo.freeze_weight_specs(l.weight_specs),
                     memo.branches_signature(l), len(l.outputs)))
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:24]


def knob_fingerprint(cfg) -> str:
    """The search-affecting FFConfig knobs (machine-shape knobs are covered
    by the machine fingerprint; --substitution-json by its file content).
    The remat knobs change both the searched space and the artifact
    (Strategy.remat): a strategy searched without the remat dimension must
    never serve a compile that asked for it, and vice versa."""
    sub = ""
    if cfg.substitution_json:
        try:
            with open(cfg.substitution_json, "rb") as f:
                sub = hashlib.sha256(f.read()).hexdigest()[:16]
        except OSError:
            sub = "unreadable:" + cfg.substitution_json
    knobs = (cfg.search_budget, cfg.search_alpha, cfg.only_data_parallel,
             cfg.enable_parameter_parallel, cfg.enable_attribute_parallel,
             cfg.base_optimize_threshold, cfg.memory_search, sub,
             cfg.simulator_mode, cfg.remat, cfg.remat_search,
             cfg.remat_policies if cfg.remat_search else "")
    return hashlib.sha256(repr(knobs).encode()).hexdigest()[:16]


def calibration_fingerprint(measure_cache_path: Optional[str]) -> str:
    """Content hash of the persistent measured-cost store, or "analytic"
    when the analytic model prices the search. Re-running calibration
    rewrites that store, changes this fingerprint, and invalidates every
    strategy it priced — the invalidation rule documented in the README."""
    if not measure_cache_path:
        return "analytic"
    try:
        with open(measure_cache_path, "rb") as f:
            return "measured:" + hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError:
        return "measured:empty"


def cache_key(model, machine: MachineSpec, cfg,
              calib_fp: str = "analytic", opt_fp: str = "") -> str:
    # opt_fp: the OptMemSpec fingerprint (search/cost_model.py) — the
    # optimizer's moment count/dtype change the memory accounting
    # memory-constrained searches rank by
    parts = (CACHE_VERSION, graph_fingerprint(model),
             memo.machine_fingerprint(machine), knob_fingerprint(cfg),
             calib_fp, opt_fp)
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:32]


# ------------------------------------------------------------- validation
def validate_strategy(strategy: Strategy, model,
                      machine: MachineSpec) -> List[str]:
    """Type-check a cached strategy against the live graph: every named
    layer exists, dim lists match tensor ranks, every axis is on the mesh.
    Returns the list of problems (empty = valid)."""
    problems: List[str] = []
    layers = {l.name: l for l in model.layers}
    inputs = {t.name: t for t in model.input_tensors}
    axes = set(machine.mesh_axes)
    if strategy.mesh_axes and dict(strategy.mesh_axes) != dict(machine.mesh_axes):
        problems.append(f"mesh {dict(strategy.mesh_axes)} != "
                        f"{dict(machine.mesh_axes)}")
    for name, sh in strategy.op_shardings.items():
        l = layers.get(name)
        if l is None:
            problems.append(f"unknown layer {name!r}")
            continue
        for oi, dims in enumerate(sh.outputs):
            if oi >= len(l.outputs) or len(dims) != l.outputs[oi].spec.ndim:
                problems.append(f"{name} output {oi} rank mismatch")
            elif any(a not in axes for a in used_axes(dims)):
                problems.append(f"{name} output {oi} uses unknown axis")
        for w, dims in sh.weights.items():
            spec = l.weight_specs.get(w)
            if spec is None or len(dims) != spec.ndim:
                problems.append(f"{name} weight {w!r} rank mismatch")
            elif any(a not in axes for a in used_axes(dims)):
                problems.append(f"{name} weight {w!r} uses unknown axis")
    for name, dims in strategy.input_shardings.items():
        t = inputs.get(name)
        if t is None or len(dims) != t.spec.ndim:
            problems.append(f"input {name!r} rank mismatch")
        elif any(a not in axes for a in used_axes(dims)):
            problems.append(f"input {name!r} uses unknown axis")
    return problems


# -------------------------------------------------------------------- io
def _path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"{key}.json")


def lookup(cache_dir: str, key: str, model,
           machine: MachineSpec) -> Optional[Strategy]:
    """Load + validate; returns the Strategy on a usable hit, else None
    (miss or invalidated — STATS records which)."""
    try:
        with open(_path(cache_dir, key)) as f:
            entry = json.load(f)
    except (OSError, ValueError):
        STATS.misses += 1
        tel.event("search/strategy_cache", cat="compile", event="miss")
        return None
    if entry.get("version") != CACHE_VERSION:
        STATS.misses += 1
        tel.event("search/strategy_cache", cat="compile", event="miss")
        return None
    try:
        st = Strategy.from_json(entry["strategy"])
        problems = validate_strategy(st, model, machine)
    except (KeyError, TypeError, ValueError, AttributeError):
        # readable but malformed (hand-edited / schema drift without a
        # version bump): degrade to a miss, never abort the compile
        STATS.invalidated += 1
        tel.event("search/strategy_cache", cat="compile",
                  event="invalidated")
        return None
    if problems:
        STATS.invalidated += 1
        tel.event("search/strategy_cache", cat="compile",
                  event="invalidated")
        return None
    STATS.hits += 1
    tel.event("search/strategy_cache", cat="compile", event="hit", key=key)
    st._cache_info = {"event": "hit", "key": key, "dir": cache_dir,
                      "meta": entry.get("meta", {})}
    # the stored search's predicted per-step cost (and per-op breakdown)
    # rides back out with the strategy: CompiledModel.predicted_step_time
    # reads it on warm compiles as on cold ones
    cost = entry.get("meta", {}).get("cost_s")
    if cost:
        st._predicted_cost = float(cost)
    op_costs = entry.get("meta", {}).get("op_costs_s")
    if isinstance(op_costs, dict):
        st._predicted_op_costs = {str(k): float(v)
                                  for k, v in op_costs.items()}
    return st


def store(cache_dir: str, key: str, strategy: Strategy,
          meta: Optional[dict] = None) -> None:
    """Write-through (atomic rename); an unwritable dir degrades to a
    per-process no-op rather than failing the compile."""
    entry = {"version": CACHE_VERSION, "strategy": strategy.to_json(),
             "meta": dict(meta or {}, created_unix=time.time())}
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = _path(cache_dir, key) + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(entry, f, indent=1)
        os.replace(tmp, _path(cache_dir, key))
    except OSError:
        STATS.errors += 1
        return
    STATS.stores += 1
    tel.event("search/strategy_cache", cat="compile", event="store", key=key)
    strategy._cache_info = {"event": "store", "key": key, "dir": cache_dir,
                            "meta": entry["meta"]}
