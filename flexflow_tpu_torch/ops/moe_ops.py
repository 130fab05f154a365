"""MoE ops: group_by (dispatch), experts, aggregate (combine) and cache
(counterpart: flexflow_tpu/ops/moe_ops.py).

Capacity-factor routing with static shapes, as in the JAX package:
group_by writes a dense (n_experts, capacity, d) dispatch buffer and the
per-(token, choice) slot positions, -1 where a choice overflowed its
expert's capacity `cap = max(1, ceil(alpha * k * batch / n_experts))`;
`experts` is one batched per-expert dense; aggregate gathers each choice's
expert output back and weights it by its gate.

Nothing here reads a count back to the host (no `nonzero`, `.item()` or
boolean indexing), so a K-step CUDA graph can capture the ops:

- the positions are `cumsum(one_hot) * one_hot - 1` and a max over the
  experts, in int32 (JAX's dtype and tie order), the one-hot taken by a
  comparison with `arange`;
- the tokens are written with `index_put` (no accumulation) into a
  `cap + 1` buffer whose last slot takes the overflowed tokens and is
  sliced off, as JAX's `.at[].set(mode="drop")` into the same buffer: an
  overflowed token's gradient is then exactly 0;
- a dropped pair reads slot 0 of its expert with gate weight 0, so the
  gather's backward adds exact zeros there: every buffer row gets at most
  one nonzero term, and two backward passes agree bitwise.

The expert product is `torch.einsum` (a batched matmul), which JAX leaves
to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import torch

from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.dtype import DataType
from flexflow_tpu_torch.ops.activations import apply_activation
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import register_op

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer


def _group_by_infer(layer: "Layer"):
    data, assign = layer.inputs[0].spec, layer.inputs[1].spec
    n_experts = layer.params["n_experts"]
    alpha = layer.params.get("alpha", 1.0)
    b, k = assign.shape
    cap = max(1, int(math.ceil(alpha * k * b / n_experts)))
    layer.params["capacity"] = cap
    return [
        TensorSpec((n_experts, cap, data.shape[-1]), data.dtype),
        TensorSpec((b, k), DataType.INT32),
    ]


def _group_by_lower(layer: "Layer", inputs, weights, ctx):
    data, assign = inputs
    n_experts = layer.params["n_experts"]
    cap = layer.params["capacity"]
    b, k = assign.shape
    flat = assign.reshape(-1).to(torch.int32)  # (b*k,)
    experts = torch.arange(n_experts, dtype=torch.int32, device=flat.device)
    oh = (flat[:, None] == experts[None, :]).to(torch.int32)  # (b*k, E)
    # each (token, choice)'s rank among its expert's, -1 in other columns
    pos = torch.cumsum(oh, dim=0, dtype=torch.int32) * oh - 1
    pos_own = pos.max(dim=1).values
    valid = pos_own < cap
    slot = torch.where(valid, pos_own, torch.full_like(pos_own, cap))
    # token i once per choice, (b*k, d) in (token, choice) order, as a
    # view and a copy (no repeat count read back)
    tokens = data[:, None, :].expand(b, k, data.shape[-1]).reshape(b * k, -1)
    buf = data.new_zeros((n_experts, cap + 1, data.shape[-1]))
    buf = buf.index_put((flat.long(), slot.long()), tokens)
    positions = torch.where(valid, pos_own,
                            torch.full_like(pos_own, -1)).reshape(b, k)
    return [buf[:, :cap], positions]


register_op(OperatorType.GROUP_BY, _group_by_infer, _group_by_lower)


def _experts_infer(layer: "Layer"):
    x = layer.inputs[0].spec  # (E, cap, d)
    p = layer.params
    e, cap, d = x.shape
    out_dim = p["out_dim"]
    layer.weight_specs = {"kernel": TensorSpec((e, d, out_dim), x.dtype)}
    if p.get("use_bias", True):
        layer.weight_specs["bias"] = TensorSpec((e, out_dim), x.dtype)
    return [x.with_shape((e, cap, out_dim))]


def _experts_lower(layer: "Layer", inputs, weights, ctx):
    x = inputs[0]
    y = torch.einsum("ecd,edo->eco", x, weights["kernel"].to(x.dtype))
    if "bias" in weights:
        y = y + weights["bias"].to(y.dtype)[:, None, :]
    return [apply_activation(layer.params.get("activation"), y)]


def _experts_flops(layer: "Layer"):
    x = layer.inputs[0].spec
    return 2.0 * x.num_elements * layer.params["out_dim"]


register_op(OperatorType.EXPERTS, _experts_infer, _experts_lower,
            _experts_flops)


def _aggregate_infer(layer: "Layer"):
    gates, assign, positions, exp = [t.spec for t in layer.inputs]
    b, k = gates.shape
    return [TensorSpec((b, exp.shape[-1]), exp.dtype)]


def _aggregate_lower(layer: "Layer", inputs, weights, ctx):
    gates, assign, positions, exp = inputs
    valid = positions >= 0
    slot = torch.where(valid, positions, torch.zeros_like(positions))
    gathered = exp[assign.long(), slot.long()]  # (b, k, dout)
    w = torch.where(valid, gates, torch.zeros_like(gates)).to(exp.dtype)
    return [torch.einsum("bk,bkd->bd", w, gathered)]


register_op(OperatorType.AGGREGATE, _aggregate_infer, _aggregate_lower)
# aggregate_spec (the speculative-assignment variant used with cache):
# the same combine on the forward path
register_op(OperatorType.AGGREGATE_SPEC, _aggregate_infer, _aggregate_lower)


def _cache_infer(layer: "Layer"):
    return [layer.inputs[0].spec]


def _cache_lower(layer: "Layer", inputs, weights, ctx):
    # a pass-through that keeps the last training input in the
    # non-trainable state, as the JAX lowering does
    x = inputs[0]
    if ctx.training:
        ctx.new_state[f"{layer.name}/cached"] = x.detach()
    return [x]


def _cache_init_state(layer: "Layer", device):
    """The state key the training lowering writes, zero (a captured step
    reads and writes a fixed buffer)."""
    spec = layer.inputs[0].spec
    return {f"{layer.name}/cached": torch.zeros(
        spec.shape, dtype=spec.dtype.torch_dtype, device=device)}


register_op(OperatorType.CACHE, _cache_infer, _cache_lower,
            init_state=_cache_init_state)
