"""Search-wide memoization: the interned cost-evaluation tables
(counterpart: flexflow_tpu/search/memo.py).

`Candidate.op_time`, `reshard_time`, `grad_sync_time` and whole
`layer_candidates` enumerations intern their results by (op params key,
layout, machine fingerprint), so repeated DP states and structural twins
(GPT-2's blocks) never re-price the same candidate. The tables are
process-global (costs are pure functions of their keys), keyed by a
`MachineSpec` content fingerprint rather than object identity; a spec is
treated as immutable once built, and the fingerprint is cached on it.

`FF_SEARCH_MEMO=0` (or `set_enabled(False)`) disables every table. A miss
runs exactly the original code and a hit returns the float that code
produced, so memoized and unmemoized costs are bitwise equal.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict

_ENABLED = os.environ.get("FF_SEARCH_MEMO", "1").lower() not in ("0", "false")

_MISS = object()  # sentinel: distinguishes "absent" from a cached None

_TABLES: Dict[str, Dict[Any, Any]] = {}
_HITS: Dict[str, int] = {}
_MISSES: Dict[str, int] = {}


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def get(table: str, key):
    """Cached value or the module sentinel `MISS` (use `is`)."""
    v = _TABLES.get(table, {}).get(key, _MISS)
    if v is _MISS:
        _MISSES[table] = _MISSES.get(table, 0) + 1
    else:
        _HITS[table] = _HITS.get(table, 0) + 1
    return v


MISS = _MISS

# per-table entry cap: a long-lived process (Jupyter kernel, sweep script)
# compiling many distinct models/meshes must not grow without bound. Epoch
# eviction — drop the whole table when full — keeps hits O(1) with zero
# bookkeeping; one search repopulates its working set in a few ms.
MAX_TABLE_ENTRIES = 200_000


def put(table: str, key, value):
    t = _TABLES.setdefault(table, {})
    if len(t) >= MAX_TABLE_ENTRIES:
        t.clear()
    t[key] = value
    return value


def clear() -> None:
    """Drop every table and counter (tests / benchmarks)."""
    _TABLES.clear()
    _HITS.clear()
    _MISSES.clear()


def stats() -> Dict[str, Dict[str, int]]:
    """Per-table {size, hits, misses} snapshot (cache-stats reporting)."""
    names = set(_TABLES) | set(_HITS) | set(_MISSES)
    return {n: {"size": len(_TABLES.get(n, ())),
                "hits": _HITS.get(n, 0),
                "misses": _MISSES.get(n, 0)} for n in sorted(names)}


def stats_line() -> str:
    """One line of every table's hits over lookups (the compile report's
    [search] line)."""
    s = stats()
    if not s:
        return "memo: empty"
    total_h = sum(v["hits"] for v in s.values())
    total_m = sum(v["misses"] for v in s.values())
    parts = " ".join(f"{n}={v['hits']}/{v['hits'] + v['misses']}"
                     for n, v in s.items())
    return (f"memo: {total_h}/{total_h + total_m} hits ({parts})"
            if _ENABLED else "memo: disabled")


# ------------------------------------------------------------- fingerprints
def machine_fingerprint(machine) -> str:
    """Content hash of a MachineSpec — the (machine view) half of every memo
    key, and the machine component of the persistent strategy-cache key."""
    fp = machine.__dict__.get("_ff_fingerprint")
    if fp is None:
        blob = json.dumps(machine.to_json(), sort_keys=True, default=str)
        fp = hashlib.sha256(blob.encode()).hexdigest()[:16]
        machine.__dict__["_ff_fingerprint"] = fp
    return fp


def freeze_dims(dims):
    """Hashable form of a DimSharding sequence (None | str | tuple per dim)."""
    out = []
    for d in dims or ():
        if d is None or isinstance(d, str):
            out.append(d)
        else:
            out.append(tuple(d))
    return tuple(out)


def freeze_weight_specs(weight_specs) -> tuple:
    """Hashable identity of a layer's weight TensorSpecs."""
    return tuple(sorted((w, s.shape, s.dtype)
                        for w, s in weight_specs.items()))


def branches_signature(layer):
    """Canonical content of a fork_join composite's branch sub-graphs, or
    None for other layers. The branches live outside the composite's
    params and weight_specs yet decide its cost and placement
    (branch_flops, congruent_branches, inter_placeable): every graph or
    prefix fingerprint of a fork_join row includes this, or an edited
    branch body would keep the old identity."""
    branches = getattr(layer, "branches", None)
    if not branches:
        return None
    sig = []
    for ls, _bx, out in branches:
        sig.append((tuple((l.params_key(), freeze_weight_specs(l.weight_specs))
                          for l in ls),
                    out.spec.shape, out.spec.dtype))
    return tuple(sig)
