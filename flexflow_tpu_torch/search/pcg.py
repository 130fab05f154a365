"""Parallel Computation Graph: the substitution engine's working IR
(counterpart: flexflow_tpu/search/pcg.py).

A PCG is a clone of the model's layer graph (rewrites never mutate the
user's model) in which parallel ops (Repartition/Combine/Replicate/
Reduction) are first-class nodes that rewrites insert and remove, and
compute nodes can carry a pin: the name of the sharding candidate
(search/candidates.py) the rewrite chose for them. Costing a PCG runs the
frontier DP (search/dp.py) with pinned nodes restricted to their pin.
Reference analog: `Graph` of `Node{guid, Op*}` (include/flexflow/graph.h:
293-360), on which GraphXfer rewrites operate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.core.layer import Layer, _freeze  # noqa: F401 (dp, strategy_cache)
from flexflow_tpu_torch.core.tensor import Tensor
from flexflow_tpu_torch.ops.op_type import PARALLEL_OPS, OperatorType


@dataclasses.dataclass
class PCG:
    """A candidate parallel computation graph: cloned layers + layout pins."""

    layers: List[Layer]
    input_tensors: List[Tensor]
    pins: Dict[str, str] = dataclasses.field(default_factory=dict)  # layer name -> candidate name

    # ------------------------------------------------------------ construction
    @staticmethod
    def from_model(model) -> "PCG":
        return PCG.from_layers(model.layers, model.input_tensors)

    @staticmethod
    def from_layers(layers, input_tensors) -> "PCG":
        tmap: Dict[int, Tensor] = {}
        new_inputs = []
        for t in input_tensors:
            nt = Tensor(t.spec, name=t.name)
            tmap[t.guid] = nt
            new_inputs.append(nt)
        new_layers: List[Layer] = []
        for l in topo_order(layers):
            nl = Layer(l.op_type, l.params, [tmap[t.guid] for t in l.inputs], name=l.name)
            nl.weight_specs = dict(l.weight_specs)
            nl.branches = l.branches  # fork_join sub-graphs (read-only)
            for i, o in enumerate(l.outputs):
                tmap[o.guid] = nl.add_output(o.spec, i, name=o.name)
            new_layers.append(nl)
        return PCG(new_layers, new_inputs)

    def clone(self) -> "PCG":
        g = PCG.from_layers(self.layers, self.input_tensors)
        g.pins = dict(self.pins)
        return g

    # -------------------------------------------------------------- structure
    def consumers(self, tensor: Tensor) -> List[Tuple[Layer, int]]:
        out = []
        for l in self.layers:
            for i, t in enumerate(l.inputs):
                if t.guid == tensor.guid:
                    out.append((l, i))
        return out

    def layer_by_name(self, name: str) -> Layer:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)

    def insert_after(self, tensor: Tensor, op_type: OperatorType,
                     params: Dict, name: Optional[str] = None) -> Layer:
        """Insert a (parallel) op consuming `tensor`; every existing consumer
        of `tensor` is rewired to the new op's output. Reference analog:
        parallel-op node insertion in GraphXfer::run (substitution.cc:596)."""
        node = Layer(op_type, params, [tensor], name=name)
        node.add_output(tensor.spec, 0)
        cons = self.consumers(tensor)
        for l, i in cons:
            l.inputs[i] = node.outputs[0]
        # place right after the producer in the list (topo order preserved)
        if tensor.owner is not None:
            idx = self.layers.index(tensor.owner) + 1
        else:
            idx = 0
        self.layers.insert(idx, node)
        return node

    def remove_identity(self, node: Layer):
        """Remove a single-input single-output node, rewiring its consumers
        to its input (parallel-op elimination rules)."""
        assert len(node.inputs) == 1 and len(node.outputs) == 1
        src = node.inputs[0]
        for l, i in self.consumers(node.outputs[0]):
            l.inputs[i] = src
        self.layers.remove(node)
        self.pins.pop(node.name, None)

    # ------------------------------------------------------------------- keys
    def key(self) -> Tuple:
        """Canonical structural identity for visited-set dedup (name-free so
        two applications producing isomorphic graphs collide)."""
        order = topo_order(self.layers)
        idx = {l: i for i, l in enumerate(order)}
        in_idx = {t.guid: i for i, t in enumerate(self.input_tensors)}
        rows = []
        for l in order:
            ins = []
            for t in l.inputs:
                if t.owner is not None and t.owner in idx:
                    ins.append((idx[t.owner], t.owner_idx))
                else:
                    ins.append((-1, in_idx.get(t.guid, -9)))
            rows.append((l.op_type.value, _freeze(l.params), tuple(ins),
                         self.pins.get(l.name)))
        return tuple(rows)

    @property
    def num_parallel_nodes(self) -> int:
        return sum(1 for l in self.layers if l.op_type in PARALLEL_OPS)
