"""Op registry: shape inference + PyTorch lowering + cost facts per
OperatorType (counterpart: flexflow_tpu/ops/registry.py).

An op needs:

- ``infer(layer)`` — output TensorSpecs (and fills layer.weight_specs);
- ``lower(layer, inputs, weights, ctx)`` — a function on tensors that
  returns the layer's outputs;
- ``flops(layer)`` (optional) — forward FLOPs for the search's cost model
  (search/cost_model.py); without it an op counts one operation per
  output element, as in the JAX package;
- ``init_state(layer, device)`` (optional) — the non-trainable state the
  train step writes, as the values its lowering reads in its place while
  the key is missing (batch norm's running stats). A captured train step
  reads and writes fixed buffers, so it fills them first
  (compiler/compile.py).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional

import torch

from flexflow_tpu_torch import random as ff_random
from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.ops.op_type import OperatorType

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer


@dataclasses.dataclass
class LoweringCtx:
    """Per-run context threaded through op lowerings."""

    # non-trainable state (the paged KV cache, batch-norm running stats)
    # in, updated state out
    state: Dict[str, Any] = dataclasses.field(default_factory=dict)
    new_state: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # --fusion: False keeps the hand-written attention kernels off
    enable_fusion: bool = True
    # the run's device (where a lowering without inputs, a constant,
    # makes its tensor) and the mixed policy's compute dtype (None: f32)
    device: Optional[torch.device] = None
    compute_dtype: Optional[torch.dtype] = None
    # training (the train step) or inference (serving, eval, infer)
    training: bool = False
    # what one run computes once and its layers share (the decode step's
    # cache write indices)
    memo: Dict[Any, Any] = dataclasses.field(default_factory=dict)
    # the run's key (flexflow_tpu_torch/random.py: a host int, or a
    # device key inside a captured graph), None when the caller gave none:
    # the train step's dropout draws from it
    rng: Any = None
    # test hook: mask_hook(layer, rng, shape, keep) -> bool mask replaces
    # the dropout draw (the tests feed the JAX package's masks through it)
    mask_hook: Optional[Callable] = None
    # what a lowering builds once for the life of the forward and reads
    # on every run (the constants' device tensors), keyed by the lowering
    cache: Dict[Any, Any] = dataclasses.field(default_factory=dict)
    # the DeviceMesh the run's DTensors live on (None: the one-device
    # program); the parallel ops redistribute over it
    mesh: Any = None
    # the run's Strategy: over a mesh the lowerings read the ring, the
    # placement and the expert layouts from it (`mesh_sharding`)
    strategy: Any = None

    def mesh_sharding(self, layer: "Layer"):
        """The strategy's sharding of `layer` over a mesh (its `attrs`
        name the ring and placement axes), None for the one-device
        program, which applies none. The compile held it to its guards
        (compiler/compile.py `_check_mesh_strategy`)."""
        if self.mesh is None or self.strategy is None:
            return None
        return self.strategy.sharding_for(layer.name)

    def layer_key(self, layer: "Layer"):
        """fold_in(rng, layer.guid), a host or a device key as the rng is:
        every call gives the same key, so a rematerialized layer redraws
        its mask."""
        if self.rng is None:
            raise ValueError(
                f"layer {layer.name} needs an rng but none was provided")
        return ff_random.fold_in(self.rng, layer.guid)

    rng_for = layer_key  # JAX's name

    def dropout_mask(self, layer: "Layer", shape, keep: float,
                     device) -> torch.Tensor:
        """The layer's keep mask: bool, True with probability `keep`
        (`random.bernoulli_mask` of the layer's key)."""
        k = self.layer_key(layer)  # raises without an rng
        if self.mask_hook is not None:
            return self.mask_hook(layer, self.rng, tuple(shape),
                                  keep).to(device)
        return ff_random.bernoulli_mask(k, tuple(shape), keep, device)


@dataclasses.dataclass
class OpDef:
    infer: Callable[["Layer"], List[TensorSpec]]
    lower: Callable[["Layer", List[torch.Tensor], Dict[str, torch.Tensor],
                     LoweringCtx], List[torch.Tensor]]
    flops: Optional[Callable[["Layer"], float]] = None  # per forward pass
    init_state: Optional[Callable[["Layer", Any], Dict[str, torch.Tensor]]] \
        = None

    def flop_count(self, layer: "Layer") -> float:
        if self.flops is not None:
            return float(self.flops(layer))
        # default: one vector op per output element
        return float(sum(o.spec.num_elements for o in layer.outputs))


_REGISTRY: Dict[OperatorType, OpDef] = {}


def register_op(op_type: OperatorType, infer, lower, flops=None,
                init_state=None) -> OpDef:
    d = OpDef(infer=infer, lower=lower, flops=flops, init_state=init_state)
    _REGISTRY[op_type] = d
    return d


def get_op_def(op_type: OperatorType) -> OpDef:
    if op_type not in _REGISTRY:
        raise NotImplementedError(f"no OpDef registered for {op_type}")
    return _REGISTRY[op_type]


def has_op_def(op_type: OperatorType) -> bool:
    return op_type in _REGISTRY


def io_bytes(layer: "Layer") -> int:
    """Bytes moved through memory for one forward pass (inputs + weights +
    outputs)."""
    n = sum(i.spec.size_bytes for i in layer.inputs)
    n += sum(s.size_bytes for s in layer.weight_specs.values())
    n += sum(o.spec.size_bytes for o in layer.outputs)
    return n
