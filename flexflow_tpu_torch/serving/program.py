"""Serving programs by replay (counterpart: flexflow_tpu/serving/program.py).

The serving stack runs two programs per decoder model: a prefill program
over the full prompt `[slots, S]` and a decode program over `[slots, 1]`
that reads and writes the paged KV cache. Both are built by REPLAYING the
model's graph into a fresh FFModel with transformed input shapes and
per-op param overrides: layer names, weight specs and topological order
are preserved, so params transfer 1:1. On one device there is no strategy
search (the JAX engine takes its data-parallel strategy there too).
"""

from __future__ import annotations

from typing import List, Tuple

from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.model import FFModel
from flexflow_tpu_torch.core.tensor import Tensor, TensorSpec
from flexflow_tpu_torch.ops import get_op_def
from flexflow_tpu_torch.ops.op_type import OperatorType


def _serving_params(layer: Layer, kind: str) -> dict:
    """Per-op param overrides for a serving clone: every dropout is
    hard-zeroed and attention switches into the kv_out (prefill) or paged
    decode mode (the decode lowering is its own branch, so it never takes
    the flash kernel)."""
    p = dict(layer.params)
    if layer.op_type is OperatorType.MULTIHEAD_ATTENTION:
        p["dropout"] = 0.0
        if kind == "decode":
            p["decode"] = True
        else:
            p["kv_out"] = True
    elif layer.op_type is OperatorType.DROPOUT:
        p["rate"] = 0.0
    return p


def clone_for_serving(model: FFModel, kind: str, slots: int,
                      decode_seq: int = 1) -> Tuple[FFModel, List[str]]:
    """Replay `model`'s graph into a fresh FFModel shaped for serving.

    Inputs follow the decoder contract `[batch, seq, ...]`: the batch dim
    becomes `slots` and, for kind="decode", the seq dim becomes
    `decode_seq`. Returns (serving_model, attention_layer_names), the
    latter in topological order."""
    if kind not in ("prefill", "decode"):
        raise ValueError(f"unknown serving program kind {kind!r}")
    if not model.input_tensors:
        raise ValueError("model has no inputs")
    orig_batch = model.input_tensors[0].spec.shape[0]

    def map_shape(shape):
        s = list(shape)
        if s and s[0] == orig_batch:
            s[0] = slots
        if kind == "decode" and len(s) > 1:
            s[1] = int(decode_seq)
        return tuple(s)

    sm = FFModel(model.config)
    tmap = {}
    for t in model.input_tensors:
        nt = Tensor(TensorSpec(map_shape(t.spec.shape), t.spec.dtype),
                    name=t.name)
        tmap[t.guid] = nt
        sm.input_tensors.append(nt)
    attn: List[str] = []
    for l in topo_order(model.layers):
        nl = Layer(l.op_type, _serving_params(l, kind),
                   [tmap[t.guid] for t in l.inputs], name=l.name)
        specs = get_op_def(nl.op_type).infer(nl)
        for i, spec in enumerate(specs):
            tmap[l.outputs[i].guid] = nl.add_output(spec, idx=i,
                                                    name=l.outputs[i].name)
        sm.layers.append(nl)
        if l.op_type is OperatorType.MULTIHEAD_ATTENTION:
            attn.append(l.name)
    sm._initializer_overrides = dict(model._initializer_overrides)
    return sm, attn
