"""Layer graph -> PyTorch forward (counterpart: flexflow_tpu/compiler/lowering.py).

`build_forward` returns a module that interprets the graph in topological
order on every call; PyTorch runs eagerly, so there is no trace and no
mesh. `training` selects the train-step lowering, as the JAX forward's
`training` argument does; the graph then runs under autograd and the
gradients reach the f32 master params through the per-layer casts. There
is no remat yet, and no dropout in training: a dropout of rate > 0 raises
there (ops/norm_ops.py, ops/attention_ops.py). The mixed-precision policy
is the JAX package's: floating inputs and weights are cast to the compute
dtype, except norm params (gamma/beta), whose lowerings compute the affine
in f32.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.tensor import Tensor
from flexflow_tpu_torch.dtype import torch_dtype
from flexflow_tpu_torch.ops import get_op_def
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import LoweringCtx

NORM_TYPES = (OperatorType.LAYERNORM,)


def cast_dtype(compute_dtype: Optional[str]) -> Optional[torch.dtype]:
    """The dtype the mixed policy casts to, or None for f32 (no cast)."""
    if compute_dtype and compute_dtype not in ("float32", "f32"):
        return torch_dtype(compute_dtype)
    return None


def cast_exempt(layers: Sequence[Layer]) -> Dict[str, set]:
    """Per-layer weight names exempt from the compute-dtype cast."""
    return {l.name: set(l.weight_specs) for l in layers
            if l.op_type in NORM_TYPES}


class GraphForward(nn.Module):
    """forward(params, state, input_arrays, training=False) ->
    (output_arrays, new_state)."""

    def __init__(self, layers: Sequence[Layer], graph_inputs: Sequence[Tensor],
                 outputs: Sequence[Tensor], compute_dtype: Optional[str] = None,
                 enable_fusion: bool = True):
        super().__init__()
        self.order = topo_order(layers)
        self.graph_inputs = list(graph_inputs)
        self.outputs = list(outputs)
        self.cast_to = cast_dtype(compute_dtype)
        self.enable_fusion = enable_fusion
        self.exempt = cast_exempt(layers)

    def forward(self, params: Dict[str, Dict[str, torch.Tensor]],
                state: Dict[str, Any], input_arrays: List[torch.Tensor],
                training: bool = False):
        ctx = LoweringCtx(state=dict(state), enable_fusion=self.enable_fusion,
                          training=training)
        cast_to = self.cast_to
        env: Dict[int, torch.Tensor] = {}
        for t, arr in zip(self.graph_inputs, input_arrays):
            if cast_to is not None and arr.is_floating_point():
                arr = arr.to(cast_to)
            env[t.guid] = arr
        for layer in self.order:
            ins = [env[t.guid] for t in layer.inputs]
            w = params.get(layer.name, {})
            if cast_to is not None:
                ex = self.exempt.get(layer.name, ())
                w = {k: (v.to(cast_to) if k not in ex and v.is_floating_point()
                         else v) for k, v in w.items()}
            outs = get_op_def(layer.op_type).lower(layer, ins, w, ctx)
            for t, o in zip(layer.outputs, outs):
                env[t.guid] = o
        new_state = dict(state)
        new_state.update(ctx.new_state)
        return [env[t.guid] for t in self.outputs], new_state


def build_forward(layers: Sequence[Layer], graph_inputs: Sequence[Tensor],
                  outputs: Sequence[Tensor], compute_dtype: Optional[str] = None,
                  enable_fusion: bool = True) -> GraphForward:
    return GraphForward(layers, graph_inputs, outputs,
                        compute_dtype=compute_dtype, enable_fusion=enable_fusion)
