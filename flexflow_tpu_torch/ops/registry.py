"""Op registry: shape inference + PyTorch lowering per OperatorType
(counterpart: flexflow_tpu/ops/registry.py).

An op needs:

- ``infer(layer)`` — output TensorSpecs (and fills layer.weight_specs);
- ``lower(layer, inputs, weights, ctx)`` — a function on tensors that
  returns the layer's outputs.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Dict, List

import torch

from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.ops.op_type import OperatorType

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer


@dataclasses.dataclass
class LoweringCtx:
    """Per-run context threaded through op lowerings."""

    # non-trainable state (the paged KV cache) in, updated state out
    state: Dict[str, Any] = dataclasses.field(default_factory=dict)
    new_state: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # --fusion: False keeps the hand-written attention kernels off
    enable_fusion: bool = True
    # training (the train step) or inference (serving, eval, infer)
    training: bool = False
    # what one run computes once and its layers share (the decode step's
    # cache write indices)
    memo: Dict[Any, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class OpDef:
    infer: Callable[["Layer"], List[TensorSpec]]
    lower: Callable[["Layer", List[torch.Tensor], Dict[str, torch.Tensor],
                     LoweringCtx], List[torch.Tensor]]


_REGISTRY: Dict[OperatorType, OpDef] = {}


def register_op(op_type: OperatorType, infer, lower) -> OpDef:
    d = OpDef(infer=infer, lower=lower)
    _REGISTRY[op_type] = d
    return d


def get_op_def(op_type: OperatorType) -> OpDef:
    if op_type not in _REGISTRY:
        raise NotImplementedError(f"no OpDef registered for {op_type}")
    return _REGISTRY[op_type]
