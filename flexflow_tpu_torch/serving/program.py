"""Serving programs by replay (counterpart: flexflow_tpu/serving/program.py).

The serving stack runs two programs per decoder model: a prefill program
over the full prompt `[slots, S]` and a decode program over `[slots, 1]`
that reads and writes the paged KV cache. Both are built by REPLAYING the
model's graph into a fresh FFModel with transformed input shapes and
per-op param overrides: layer names, weight specs and topological order
are preserved, so params transfer 1:1.

Each program gets its own strategy from the frontier DP (`search_graph`)
under serving prices (`serving_optimize`, JAX `program.py:126-274`), when
the engine searches (`search_budget` > 0 on a machine of several devices;
on one device both programs take the data-parallel strategy, as in JAX):

- prefill is compute-bound: each candidate is priced by the forward legs
  of the roofline plus its forward collectives (`_prefill_cost_fn`);
- decode is memory-bound: the forward memory leg plus the attention's
  share of the live KV bytes over its head-shard degree, and with a host
  tier the refill traffic amortized over `prefetch_ahead` steps
  (`_decode_cost_fn`), so weight-sharded layouts win;
- the decode memory cap is the device's bytes less the KV pools' share a
  device, re-capped once by the shard degree the winner buys;
- `inference=True` (no gradient sync, the forward value alone live) and
  the `--serve-objective` score; no optimizer moments.

Both strategies persist in the strategy cache under keys of their own:
the graph fingerprints differ, and the opt fingerprint carries the
program's kind, the objective and the KV geometry (and `-pf{ahead}` with
a host tier), so a warm `compile_serving` restores both with no DP
expansion. The engine's `op_attribution` prices with the same cost
functions.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

from flexflow_tpu_torch import telemetry as tel
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
    decode mode. The decode lowering is its own branch and never takes
    the flash kernel; `impl="xla"` says so to the search, as in JAX (no
    ring candidate; the candidates price it as no flash)."""
    p = dict(layer.params)
    if layer.op_type is OperatorType.MULTIHEAD_ATTENTION:
        p["dropout"] = 0.0
        if kind == "decode":
            p["decode"] = True
            p["impl"] = "xla"
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


def attn_head_degree(strategy_or_result, attn_layers,
                     machine: MachineSpec) -> int:
    """The degree the search put on the attention heads: the sharding
    degree of wq's output-features dim (the concatenated heads), the
    largest over `attn_layers`. Takes a SearchResult (`choices`) or a
    Strategy (`op_shardings`)."""
    deg = 1
    for name in attn_layers:
        choices = getattr(strategy_or_result, "choices", None)
        if choices is not None:
            cand = choices.get(name)
            dims = cand.weight_dims.get("wq") if cand is not None else None
        else:
            sh = strategy_or_result.op_shardings.get(name)
            dims = sh.weights.get("wq") if sh is not None else None
        if dims and len(dims) > 1 and dims[1] is not None:
            deg = max(deg, cm.dims_degree([dims[1]], machine))
    return deg


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


def serving_optimize(smodel: FFModel, machine: MachineSpec, kind: str,
                     attn_layers: List[str], kv_spec=None,
                     prefetch_ahead: int = 0):
    """The frontier DP on one serving program; returns its Strategy.

    A warm call returns the cached strategy: the key is the serving graph's
    fingerprint plus the opt fingerprint `serve-{kind}-{objective}-{KV
    fingerprint}` (and `-pf{prefetch_ahead}` when the KV pool has a host
    tier, whose refill traffic the decode prices), byte for byte JAX's.
    The search runs inside a `serve/search_{kind}` span and ends with a
    `serve/search_result` event; the strategy is stored with its meta
    (cost, kind, objective, KV fingerprint, search wall time). Over a
    process group every rank runs the same search: each looks the key up
    before any stores it, and rank 0 writes it."""
    from flexflow_tpu_torch.runtime.distributed import rank, world_size
    from flexflow_tpu_torch.search import strategy_cache as sc
    from flexflow_tpu_torch.search.dp import search_graph
    from flexflow_tpu_torch.search.optimize import result_to_strategy

    cfg = smodel.config
    objective = getattr(cfg, "serve_objective", "latency")
    # no optimizer moments; weight_mem_bytes' param+grad pair over-counts
    # by the grad alike for every candidate, so the ranking holds and the
    # cap stays safe
    opt_mem = cm.OptMemSpec(moments=0)
    kv_fp = kv_spec.fingerprint() if kv_spec is not None else ()
    opt_fp = f"serve-{kind}-{objective}-{kv_fp}"
    if kv_spec is not None and kv_spec.host_pages > 0:
        opt_fp += f"-pf{int(prefetch_ahead)}"
    use_cache = bool(getattr(cfg, "strategy_cache", True))
    cache_dir = sc.resolve_dir(cfg) if use_cache else None
    key = None
    if use_cache:
        key = sc.cache_key(smodel, machine, cfg, "analytic", opt_fp)
        cached = sc.lookup(cache_dir, key, smodel, machine)
        if world_size() > 1:
            import torch.distributed as dist

            dist.barrier()
        if cached is not None:
            return cached
    beam = max(8, min(64, int(getattr(cfg, "search_budget", 16) or 16)))
    kv_layer = kv_spec.layer_bytes() if (kv_spec and kind == "decode") else 0
    cost_fn = (_decode_cost_fn(machine, kv_layer, kv_spec=kv_spec,
                               prefetch_ahead=prefetch_ahead)
               if kind == "decode" else _prefill_cost_fn(machine))
    t0 = time.perf_counter()
    degree = 1
    result = None
    with tel.span(f"serve/search_{kind}", cat="compile",
                  objective=objective,
                  slots=smodel.input_tensors[0].shape[0]):
        for _ in range(2):
            budget = float(machine.hbm_bytes)
            if kind == "decode" and kv_spec is not None:
                budget -= kv_spec.per_device_bytes(degree)
            result = search_graph(
                smodel, machine, beam_width=beam,
                enable_parameter=getattr(cfg, "enable_parameter_parallel",
                                         True),
                enable_attribute=getattr(cfg, "enable_attribute_parallel",
                                         True),
                mem_budget=budget, cost_fn=cost_fn, opt_mem=opt_mem,
                objective=objective, inference=True)
            new_degree = attn_head_degree(result, attn_layers, machine)
            if kind != "decode" or kv_spec is None or new_degree == degree:
                break
            degree = new_degree  # re-cap by the KV shard the winner buys
    st = result_to_strategy(smodel, machine, result)
    st._predicted_cost = result.cost
    tel.event("serve/search_result", cat="compile", kind=kind,
              cost_s=result.cost, objective=objective)
    if use_cache:
        meta = {"cost_s": result.cost, "kind": kind, "objective": objective,
                "kv_fingerprint": list(kv_fp),
                "search_wallclock_s": time.perf_counter() - t0}
        if rank() == 0:
            sc.store(cache_dir, key, st, meta=meta)
        else:
            st._cache_info = {"event": "store", "key": key,
                              "dir": cache_dir, "meta": meta}
    return st
