"""compile_serving — the prefill and decode programs + a paged cache per model
(counterpart: flexflow_tpu/serving/engine.py).

`compile_serving(model)` replays the model's graph into a prefill twin
(`[slots, S]`, attention exposing per-head K/V) and a decode twin
(`[slots, 1]`, attention reading and writing the paged KV cache), and
returns a `ServingCompiled` holding both programs and the `PagedKVCache`
they share. Serving is deterministic by construction: both programs run
in inference mode and every dropout in the clones is rate 0.

The entry points run on the GPU: `device=None` means "cuda", and without a
CUDA device they raise unless the caller asks for `device="cpu"` (as the
tests do). Params are placed once in the compute dtype (norm params stay
f32, as the forward's cast would leave them), so the per-step cast of the
mixed-precision policy is free.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from flexflow_tpu_torch.compiler.lowering import (build_forward, cast_dtype,
                                                  cast_exempt)
from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.device import resolve_device, to_device
from flexflow_tpu_torch.initializers import init_params
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.serving.kv_cache import (ACTIVE_KEY, POS_KEY,
                                                 KVCacheSpec, PagedKVCache)
from flexflow_tpu_torch.serving.program import clone_for_serving


def _resolve_kv_dtype(cfg, kv_cache_dtype: Optional[str]):
    """--kv-cache-dtype -> (pool dtype, itemsize, scale_itemsize, quantized).
    "auto" follows compute_dtype, "bf16" forces bf16 pools, "int8" stores
    int8 pools with per-(page entry, head) f32 scales."""
    choice = (kv_cache_dtype or getattr(cfg, "kv_cache_dtype", "auto")
              or "auto").lower()
    if choice == "int8":
        return torch.int8, 1, 4, True
    if choice == "bf16":
        return torch.bfloat16, 2, 0, False
    if choice != "auto":
        raise ValueError(f"unknown kv_cache_dtype {choice!r} "
                         "(choose auto, bf16, or int8)")
    dt = cast_dtype(cfg.compute_dtype) or torch.float32
    return dt, dt.itemsize, 0, False


def compile_serving(model, max_batch_slots: Optional[int] = None,
                    max_decode_len: Optional[int] = None,
                    kv_page_size: Optional[int] = None,
                    kv_cache_dtype: Optional[str] = None,
                    device=None) -> "ServingCompiled":
    """Build the serving programs for a decoder `model` (inputs shaped
    `[batch, seq, ...]`). Knob precedence: explicit args > FFConfig
    fields > defaults."""
    dev = resolve_device(device)
    cfg = model.config
    if getattr(cfg, "search_budget", 0) > 0:
        raise NotImplementedError(
            "compile_serving with search_budget > 0: the serving searches "
            "(serving_optimize) are not ported yet (ROADMAP Queue 1 item 8)")
    slots = int(max_batch_slots or getattr(cfg, "max_batch_slots", 8) or 8)
    max_new = int(max_decode_len or getattr(cfg, "max_decode_len", 0) or 32)
    page = int(kv_page_size or getattr(cfg, "kv_page_size", 16) or 16)
    kv_dtype, kv_itemsize, kv_scale_itemsize, kv_quantized = \
        _resolve_kv_dtype(cfg, kv_cache_dtype)
    attn_params = [l.params for l in model.layers
                   if l.op_type is OperatorType.MULTIHEAD_ATTENTION]
    if not attn_params:
        raise ValueError("compile_serving needs a model with attention "
                         "layers (nothing to cache)")
    heads = int(attn_params[0]["num_heads"])
    embed = int(attn_params[0]["embed_dim"])
    seq = int(model.input_tensors[0].spec.shape[1])
    pre_model, attn = clone_for_serving(model, "prefill", slots)
    dec_model, _ = clone_for_serving(model, "decode", slots)
    kv_spec = KVCacheSpec(
        layers=len(attn), heads=heads, head_dim=embed // heads, slots=slots,
        pages_per_slot=-(-(seq + max_new) // page), page_size=page,
        itemsize=kv_itemsize, scale_itemsize=kv_scale_itemsize)
    return ServingCompiled(model, pre_model, dec_model, attn, kv_spec,
                           max_new, kv_dtype=kv_dtype,
                           kv_quantized=kv_quantized, device=dev)


class ServingCompiled:
    """The two serving programs + the paged cache they share."""

    def __init__(self, model, prefill_model, decode_model,
                 attn_layers: List[str], kv_spec: KVCacheSpec,
                 max_decode_len: int, kv_dtype=torch.float32,
                 kv_quantized: bool = False, device=None):
        self.model = model
        self.cfg = model.config
        self.device = resolve_device(device)
        self.prefill_model = prefill_model
        self.decode_model = decode_model
        self.attn_layers = list(attn_layers)
        self.kv_spec = kv_spec
        self.max_decode_len = int(max_decode_len)
        self.slots = int(kv_spec.slots)
        self.kv_quantized = bool(kv_quantized)
        self.kv_dtype = kv_dtype
        self.kv = PagedKVCache(kv_spec, self.attn_layers, dtype=kv_dtype,
                               quantized=self.kv_quantized, device=self.device)
        fwd_kw = dict(compute_dtype=self.cfg.compute_dtype,
                      enable_fusion=self.cfg.enable_fusion)
        self._prefill_fwd = build_forward(
            prefill_model.layers, prefill_model.input_tensors,
            prefill_model.layers[-1].outputs[:1], **fwd_kw)
        self._decode_fwd = build_forward(
            decode_model.layers, decode_model.input_tensors,
            decode_model.layers[-1].outputs[:1], **fwd_kw)
        self.params: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------- weights
    def _weight_layers(self):
        return [l for l in topo_order(self.decode_model.layers) if l.weight_specs]

    def init(self, seed: Optional[int] = None) -> Dict[str, Any]:
        """Random weights from a `torch.Generator` seeded with `seed`
        (default cfg.seed), drawn on the engine's device with the JAX
        package's default initializers (other numbers than JAX's)."""
        seed = self.cfg.seed if seed is None else seed
        self.params = self._place_params(init_params(
            self._weight_layers(), self.model._initializer_overrides, seed,
            self.device))
        return self.params

    def _place_params(self, params) -> Dict[str, Any]:
        """Validate a params tree against the decode graph and place it on
        the device in the compute dtype (norm params stay f32)."""
        layers = self._weight_layers()
        live = {l.name for l in layers}
        diffs = sorted(set(params) ^ live)
        if diffs:
            raise ValueError(f"params tree does not match the serving graph: "
                             f"layers {diffs[:8]}")
        cast_to = cast_dtype(self.cfg.compute_dtype)
        exempt = cast_exempt(layers)
        placed = {}
        for layer in layers:
            d = {}
            for w, spec in layer.weight_specs.items():
                x = to_device(params[layer.name][w], self.device)
                if tuple(x.shape) != tuple(spec.shape):
                    raise ValueError(f"{layer.name}.{w}: shape {tuple(x.shape)} "
                                     f"vs expected {tuple(spec.shape)}")
                dt = spec.dtype.torch_dtype
                if cast_to is not None and dt.is_floating_point and \
                        w not in exempt.get(layer.name, ()):
                    dt = cast_to
                d[w] = x.to(dt).contiguous()
            placed[layer.name] = d
        return placed

    def load_params(self, params) -> Dict[str, Any]:
        """Adopt a params tree `{layer: {weight: tensor or array}}`."""
        self.params = self._place_params(params)
        return self.params

    # ------------------------------------------------------------ programs
    def prefill(self, params, input_arrays):
        """Run the prefill program: returns (logits, kv_state) where
        kv_state maps each attention layer to its `[slots, S, h, d]`
        per-head K/V for `PagedKVCache.commit_prefill`."""
        inputs = [to_device(x, self.device) for x in input_arrays]
        with torch.no_grad():
            outs, kv_state = self._prefill_fwd(params, {}, inputs)
        return outs[0], kv_state

    def decode_step(self, params, state, input_arrays):
        """One single-token step over all slots: returns (logits
        `[slots, 1, vocab]`, new cache state with positions advanced).
        Nothing is synchronized with the host."""
        inputs = [to_device(x, self.device) for x in input_arrays]
        with torch.no_grad():
            outs, ns = self._decode_fwd(params, state, inputs)
            # device-side sequence advance: every ACTIVE slot cached one
            # more token this step (inactive slots stay parked)
            ns[POS_KEY] = state[POS_KEY] + state[ACTIVE_KEY]
        return outs[0], ns

    def memory_stats(self) -> Dict[str, int]:
        """Predicted vs measured KV-cache bytes and the param bytes held."""
        return {
            "predicted_kv_cache_bytes": int(self.kv_spec.total_bytes()),
            "actual_kv_cache_bytes": self.kv.device_bytes(),
            "actual_param_bytes": sum(
                int(t.numel() * t.element_size())
                for d in (self.params or {}).values() for t in d.values()),
        }

