"""Layer-graph utilities (counterpart: flexflow_tpu/core/graph.py):
topological order, dominator and post-dominator sets, and the Graphviz
export `FFModel.dot` writes (`--compgraph`).
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, List, Optional, Sequence, Set

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


def predecessors(layer: Layer, universe: Set[Layer]) -> List[Layer]:
    return [t.owner for t in layer.inputs
            if t.owner is not None and t.owner in universe]


def dominators(layers: Sequence[Layer]) -> Dict[Layer, Set[Layer]]:
    """Forward dominator sets: dom(n) = {n} and the intersection of its
    predecessors' sets; a source dominates itself."""
    order = topo_order(layers)
    universe = set(order)
    dom: Dict[Layer, Set[Layer]] = {}
    for l in order:
        preds = predecessors(l, universe)
        if not preds:
            dom[l] = {l}
        else:
            inter = set(dom[preds[0]])
            for p in preds[1:]:
                inter &= dom[p]
            inter.add(l)
            dom[l] = inter
    return dom


def post_dominators(layers: Sequence[Layer]) -> Dict[Layer, Set[Layer]]:
    """Post-dominator sets, the dominators of the reversed graph."""
    order = topo_order(layers)
    universe = set(order)
    succs: Dict[Layer, List[Layer]] = defaultdict(list)
    for l in order:
        for p in predecessors(l, universe):
            succs[p].append(l)
    pdom: Dict[Layer, Set[Layer]] = {}
    for l in reversed(order):
        ss = succs[l]
        if not ss:
            pdom[l] = {l}
        else:
            inter = set(pdom[ss[0]])
            for s in ss[1:]:
                inter &= pdom[s]
            inter.add(l)
            pdom[l] = inter
    return pdom


def to_dot(layers: Sequence[Layer],
           annotations: Optional[Dict[Layer, str]] = None) -> str:
    """Graphviz text of the layer graph, byte for byte the JAX package's:
    one record node a layer (name, output specs, its annotation), one
    edge an input."""
    annotations = annotations or {}
    lines = ["digraph PCG {", "  rankdir=TB;",
             '  node [shape=record, fontsize=10];']
    ids = {l: f"n{l.guid}" for l in layers}
    for l in layers:
        extra = annotations.get(l, "")
        outspecs = "/".join(repr(o.spec) for o in l.outputs)
        label = f"{l.name}|{outspecs}"
        if extra:
            label += f"|{extra}"
        label = label.replace("[", "(").replace("]", ")")
        lines.append(f'  {ids[l]} [label="{{{label}}}"];')
    for l in layers:
        for t in l.inputs:
            if t.owner is not None and t.owner in ids:
                lines.append(f"  {ids[t.owner]} -> {ids[l]};")
    lines.append("}")
    return "\n".join(lines)
