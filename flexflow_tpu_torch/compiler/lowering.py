"""Layer graph -> PyTorch forward (counterpart: flexflow_tpu/compiler/lowering.py).

`build_forward` returns a module that interprets the graph in topological
order on every call; PyTorch runs eagerly, so there is no trace and no
mesh. `training` selects the train-step lowering, as the JAX forward's
`training` argument does; the graph then runs under autograd and the
gradients reach the f32 master params through the per-layer casts, and
`rng` (a key of flexflow_tpu_torch/random.py, host or device) feeds the
dropout draws.

Per-layer rematerialization follows `remat` ({layer name: policy}, the
strategy's map): "full" runs the layer's lowering under
`torch.utils.checkpoint.checkpoint` (non-reentrant), which keeps only the
layer's inputs and recomputes the rest in the backward; "dots" keeps the
outputs of the matmuls (`mm`, `addmm`, `bmm`: what `@` and `einsum` lower
to) through a selective-checkpoint policy, the counterpart of
`jax.checkpoint_policies.checkpoint_dots`, and recomputes the elementwise
rest. A checkpointed layer runs on a sub-context of its own, so its
`new_state` comes back as an output and its recompute writes nothing
outside; the recompute draws the same dropout mask (a hash of the layer's
key), so remat never changes the numbers. Under `--profiling` the
compile sets `layer_ranges`: each layer's lowering, its casts included,
then runs in a `torch.profiler.record_function` range named after the
layer (JAX's `jax.named_scope(layer.name)`), which attribution.py reads
back from the trace; off, the loop opens no range. The
hand-written kernels' autograd Functions rerun in the recompute, and their
launches count again. The mixed-precision policy
is the JAX package's: floating inputs and weights are cast to the compute
dtype, except norm params (gamma/beta), those inside fork-join branches
included, whose lowerings compute the affine in f32.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.tensor import Tensor
from flexflow_tpu_torch.dtype import torch_dtype
from flexflow_tpu_torch.ops import get_op_def
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import LoweringCtx

NORM_TYPES = (OperatorType.LAYERNORM, OperatorType.BATCHNORM)


# the matmul ops whose outputs the "dots" policy saves
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


REMAT_POLICIES = ("full", "dots")


def _checkpointed(fn: Callable, policy: str, *args):
    """fn(*args) under non-reentrant checkpoint with `policy`'s saving."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    # the dropout masks are hashes of the run's key, not draws from
    # torch's global RNG, so its state need not be stashed
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def cast_dtype(compute_dtype: Optional[str]) -> Optional[torch.dtype]:
    """The dtype the mixed policy casts to, or None for f32 (no cast)."""
    if compute_dtype and compute_dtype not in ("float32", "f32"):
        return torch_dtype(compute_dtype)
    return None


def cast_exempt(layers: Sequence[Layer]) -> Dict[str, set]:
    """Per-layer weight names exempt from the compute-dtype cast: norm
    params, those of norms nested in fork-join branches included (named
    `b{i}.{sub}.{w}` or `stk.{sub}.{w}` on the composite), as JAX's
    lowering exempts them."""
    out: Dict[str, set] = {}
    for l in layers:
        if l.op_type in NORM_TYPES:
            out[l.name] = set(l.weight_specs)
        elif l.op_type is OperatorType.FORK_JOIN:
            ex = set()
            for bi, (bls, _bx, _bo) in enumerate(l.branches):
                for bl in bls:
                    if bl.op_type in NORM_TYPES:
                        ex.update(f"b{bi}.{bl.name}.{w}" for w in bl.weight_specs)
                        ex.update(f"stk.{bl.name}.{w}" for w in bl.weight_specs)
            if ex:
                out[l.name] = ex
    return out


class GraphForward(nn.Module):
    """forward(params, state, input_arrays, training=False) ->
    (output_arrays, new_state)."""

    def __init__(self, layers: Sequence[Layer], graph_inputs: Sequence[Tensor],
                 outputs: Sequence[Tensor], compute_dtype: Optional[str] = None,
                 enable_fusion: bool = True,
                 remat: Optional[Dict[str, str]] = None):
        super().__init__()
        self.order = topo_order(layers)
        self.graph_inputs = list(graph_inputs)
        self.outputs = list(outputs)
        self.cast_to = cast_dtype(compute_dtype)
        self.enable_fusion = enable_fusion
        self.exempt = cast_exempt(layers)
        self.remat = {k: v for k, v in (remat or {}).items()
                      if v in REMAT_POLICIES}
        # test hook, handed to every LoweringCtx (registry.py)
        self.mask_hook: Optional[Callable] = None
        # the lowerings' per-forward cache (LoweringCtx.cache)
        self.cache: Dict[Any, Any] = {}
        # under --profiling: each layer's lowering, its casts included, in
        # a torch.profiler record_function range named after the layer
        # (attribution.py credits the trace's kernels through them)
        self.layer_ranges = False

    def _ctx(self, state, training, rng, device) -> LoweringCtx:
        return LoweringCtx(state=state, enable_fusion=self.enable_fusion,
                           training=training, rng=rng,
                           mask_hook=self.mask_hook, device=device,
                           compute_dtype=self.cast_to, cache=self.cache)

    def _lower_checkpointed(self, layer: Layer, ins, w, ctx: LoweringCtx):
        """One layer's lowering as a function of (ins, w) on a sub-context:
        the outputs and the layer's new state come back; the recompute's
        state is dropped with its sub-context."""
        def one(l_ins, l_w):
            sub = self._ctx(dict(ctx.state), ctx.training, ctx.rng,
                            ctx.device)
            outs = get_op_def(layer.op_type).lower(layer, l_ins, l_w, sub)
            return outs, sub.new_state

        outs, delta = _checkpointed(one, self.remat[layer.name], ins, w)
        ctx.new_state.update(delta)
        return outs

    def _layer(self, layer: Layer, params, env, ctx: LoweringCtx,
               training: bool) -> None:
        """One layer: its weights cast to the compute dtype, its lowering
        (checkpointed under remat), its outputs into `env`."""
        ins = [env[t.guid] for t in layer.inputs]
        w = params.get(layer.name, {})
        cast_to = self.cast_to
        if cast_to is not None:
            ex = self.exempt.get(layer.name, ())
            w = {k: (v.to(cast_to) if k not in ex and v.is_floating_point()
                     else v) for k, v in w.items()}
        if training and layer.name in self.remat:
            outs = self._lower_checkpointed(layer, ins, w, ctx)
        else:
            outs = get_op_def(layer.op_type).lower(layer, ins, w, ctx)
        for t, o in zip(layer.outputs, outs):
            env[t.guid] = o

    def forward(self, params: Dict[str, Dict[str, torch.Tensor]],
                state: Dict[str, Any], input_arrays: List[torch.Tensor],
                training: bool = False, rng=None):
        device = input_arrays[0].device if input_arrays else None
        ctx = self._ctx(dict(state), training, rng, device)
        cast_to = self.cast_to
        env: Dict[int, torch.Tensor] = {}
        for t, arr in zip(self.graph_inputs, input_arrays):
            if cast_to is not None and arr.is_floating_point():
                arr = arr.to(cast_to)
            env[t.guid] = arr
        scope = (torch.profiler.record_function if self.layer_ranges
                 else None)
        for layer in self.order:
            if scope is None:
                self._layer(layer, params, env, ctx, training)
            else:
                with scope(layer.name):
                    self._layer(layer, params, env, ctx, training)
        new_state = dict(state)
        new_state.update(ctx.new_state)
        return [env[t.guid] for t in self.outputs], new_state


def build_forward(layers: Sequence[Layer], graph_inputs: Sequence[Tensor],
                  outputs: Sequence[Tensor], compute_dtype: Optional[str] = None,
                  enable_fusion: bool = True,
                  remat: Optional[Dict[str, str]] = None) -> GraphForward:
    return GraphForward(layers, graph_inputs, outputs,
                        compute_dtype=compute_dtype, enable_fusion=enable_fusion,
                        remat=remat)
