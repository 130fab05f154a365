"""Serving programs by replay (counterpart: flexflow_tpu/serving/program.py).

The serving stack runs two programs per decoder model: a prefill program
over the full prompt `[slots, S]` and a decode program over `[slots, 1]`
that reads and writes the paged KV cache. Both are built by REPLAYING the
model's graph into a fresh FFModel with transformed input shapes and
per-op param overrides: layer names, weight specs and topological order
are preserved, so params transfer 1:1. On one device there is no strategy
search (the JAX engine takes its data-parallel strategy there too).

The serving cost functions (`_prefill_cost_fn`, `_decode_cost_fn`) price
each op of a serving program as the JAX package's serving search does:
the engine's `op_attribution` reports with them. `serving_optimize`, the
search itself, is not ported (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.model import FFModel
from flexflow_tpu_torch.core.tensor import Tensor, TensorSpec
from flexflow_tpu_torch.ops import get_op_def
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.search import cost_model as cm


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


def _fwd_comm(cand) -> float:
    """Forward-only collectives of a candidate: serving programs never run
    the backward pass, so extra_comm_fwd (when a candidate sets it) wins
    over the fwd+bwd extra_comm."""
    fwd = getattr(cand, "extra_comm_fwd", None)
    return cand.extra_comm if fwd is None else fwd


def _prefill_cost_fn(machine: MachineSpec):
    """Forward-only roofline: op_roofline's legs are fwd+bwd (3x flops, 2x
    bytes), divided back to the forward pass, plus the candidate's forward
    collectives. Prefill over a full prompt is compute-bound."""

    def cost(layer, cand):
        rf = cm.op_roofline(layer, cand, machine)
        return max(rf["t_flop_s"] / 3.0, rf["t_mem_s"] / 2.0) + _fwd_comm(cand)

    return cost


def _decode_cost_fn(machine: MachineSpec, kv_layer_bytes: int,
                    kv_spec=None, prefetch_ahead: int = 1):
    """Bandwidth-bound pricing of the single-token step: the forward memory
    leg (streaming the layer's weights: seq 1 makes every matmul a
    matvec) plus, for attention, this layer's share of the live KV working
    set over the head-shard degree. With a host tier (kv_spec.host_pages >
    0) each step also carries the tier's refill traffic: one slot-layer
    over the host link, amortized over the `prefetch_ahead` steps the
    scheduler issues it early."""

    def cost(layer, cand):
        rf = cm.op_roofline(layer, cand, machine)
        t = rf["t_mem_s"] / 2.0
        if kv_layer_bytes and \
                layer.op_type is OperatorType.MULTIHEAD_ATTENTION:
            wq = cand.weight_dims.get("wq")
            deg = cm.dims_degree([wq[1]], machine) \
                if wq and len(wq) > 1 else 1
            t += kv_layer_bytes / max(1, deg) / machine.hbm_bw
            if kv_spec is not None and kv_spec.host_pages > 0:
                t += (kv_spec.pages_per_slot * kv_spec.page_bytes()
                      / max(1, deg) / machine.host_bw
                      / max(1, prefetch_ahead))
        return t + _fwd_comm(cand)

    return cost
