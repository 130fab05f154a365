"""Layer — a node in the frontend graph (counterpart: flexflow_tpu/core/layer.py).

A Layer records its op type, a params dict, its input tensors and the
output tensors it produces; shape inference fills `weight_specs`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from flexflow_tpu_torch.core.tensor import Tensor, TensorSpec
from flexflow_tpu_torch.ops.op_type import OperatorType


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

    def add_output(self, spec: TensorSpec, idx: int = 0,
                   name: Optional[str] = None) -> Tensor:
        t = Tensor(spec, owner=self, name=name or f"{self.name}:out{idx}")
        self.outputs.append(t)
        return t

    def __repr__(self):
        ins = ", ".join(str(list(i.shape)) for i in self.inputs)
        outs = ", ".join(str(list(o.shape)) for o in self.outputs)
        return f"Layer[{self.name}]({ins} -> {outs})"
