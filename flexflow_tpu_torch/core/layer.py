"""Layer — a node in the frontend graph (counterpart: flexflow_tpu/core/layer.py).

A Layer records its op type, a params dict, its input tensors and the
output tensors it produces; shape inference fills `weight_specs`. A
fork-join composite (ops/fork_join.py) also holds `branches`: one
(sub_layers, branch_input, branch_output) per branch, None on every other
layer.
`params_key()` is its hashable identity (op type, params, input specs),
the key the search's memo tables and measured-cost store intern by.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from flexflow_tpu_torch.core.tensor import Tensor, TensorSpec
from flexflow_tpu_torch.ops.op_type import OperatorType


def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if hasattr(v, "tobytes") and hasattr(v, "shape"):  # ndarray constants
        return (tuple(v.shape), str(getattr(v, "dtype", "")), v.tobytes())
    return v


class Layer:
    _next_guid = [100]

    def __init__(self, op_type: OperatorType, params: Dict[str, Any],
                 inputs: List[Tensor], name: Optional[str] = None):
        self.op_type = op_type
        self.params = dict(params)
        self.inputs = list(inputs)
        self.outputs: List[Tensor] = []
        self.guid = Layer._next_guid[0]
        Layer._next_guid[0] += 1
        self.name = name or f"{op_type.value}_{self.guid}"
        self.weight_specs: Dict[str, TensorSpec] = {}
        self.branches: Optional[List[Tuple[List["Layer"], Tensor, Tensor]]] \
            = None

    def add_output(self, spec: TensorSpec, idx: int = 0,
                   name: Optional[str] = None) -> Tensor:
        t = Tensor(spec, owner=self, owner_idx=idx,
                   name=name or f"{self.name}:out{idx}")
        self.outputs.append(t)
        return t

    def params_key(self) -> Tuple:
        """Hashable identity: op type + params + input specs."""
        return (
            self.op_type,
            _freeze(self.params),
            tuple((i.spec.shape, i.spec.dtype) for i in self.inputs),
        )

    def __repr__(self):
        ins = ", ".join(str(list(i.shape)) for i in self.inputs)
        outs = ", ".join(str(list(o.shape)) for o in self.outputs)
        return f"Layer[{self.name}]({ins} -> {outs})"
