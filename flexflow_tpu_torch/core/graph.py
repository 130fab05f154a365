"""Layer-graph utilities (counterpart: flexflow_tpu/core/graph.py)."""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, List, Sequence

from flexflow_tpu_torch.core.layer import Layer


def topo_order(layers: Sequence[Layer]) -> List[Layer]:
    """Kahn topological order over layer dependencies (input-tensor
    owners), stable: ready layers leave in their original order. The JAX
    package's native path walks the same order."""
    layers = list(layers)
    index = {l: i for i, l in enumerate(layers)}
    indeg = {l: 0 for l in layers}
    succs: Dict[Layer, List[Layer]] = defaultdict(list)
    for l in layers:
        for t in l.inputs:
            if t.owner is not None and t.owner in index:
                succs[t.owner].append(l)
                indeg[l] += 1
    queue = deque(l for l in layers if indeg[l] == 0)
    out: List[Layer] = []
    while queue:
        l = queue.popleft()
        out.append(l)
        for s in succs[l]:
            indeg[s] -= 1
            if indeg[s] == 0:
                queue.append(s)
    if len(out) != len(layers):
        raise ValueError("cycle detected in layer graph")
    return out
