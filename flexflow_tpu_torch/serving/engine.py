"""compile_serving — the prefill and decode programs + a paged cache per model
(counterpart: flexflow_tpu/serving/engine.py).

`compile_serving(model)` replays the model's graph into a prefill twin
(`[slots, S]`, attention exposing per-head K/V) and a decode twin
(`[slots, 1]`, attention reading and writing the paged KV cache), and
returns a `ServingCompiled` holding both programs and the `PagedKVCache`
they share. Serving is deterministic by construction: both programs run
in inference mode and every dropout in the clones is rate 0.

Speculative decoding: with a `draft` model (or `--serve-draft-model`
naming a JSON of GPT2Config overrides) and `spec_tokens=K > 0`, the draft
is compiled by this same function with the target's slots, page size and
decode budget (its own programs and paged cache), and a third program,
the VERIFY twin (`[slots, K+1]`, the decode lowering over K+1 rows),
checks the K drafted tokens in one pass. `spec_round_step` runs one whole
round on the device (K chained draft steps, then the verify pass) without
a host sync. With an int8 cache and fusion on, the verify pass runs the
paged dequant kernel at K+1 query rows, so K+1 above its gate
(`MAX_QUERY_ROWS`) raises here, at compile time.

The entry points run on the GPU: `device=None` means "cuda", and without a
CUDA device they raise unless the caller asks for `device="cpu"` (as the
tests do). Params are placed once in the compute dtype (norm params stay
f32, as the forward's cast would leave them), so the per-step cast of the
mixed-precision policy is free.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional

import torch

from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.compiler.lowering import (build_forward, cast_dtype,
                                                  cast_exempt)
from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.device import resolve_device, to_device
from flexflow_tpu_torch.health import SLOTracker, parse_slo
from flexflow_tpu_torch.initializers import init_params
from flexflow_tpu_torch.kernels.dequant_attention import MAX_QUERY_ROWS
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


def _draft_from_spec(cfg, path: str, batch: int):
    """The --serve-draft-model graph: `path` is a JSON file of GPT2Config
    overrides (e.g. {"d_model": 64, "layers": 1}) for a small GPT-2 draft
    sharing the target's vocab and seq. Callers may pass `draft=` instead."""
    from flexflow_tpu_torch.core.model import FFModel
    from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2

    with open(path) as f:
        spec = json.load(f)
    dm = FFModel(cfg)
    build_gpt2(dm, GPT2Config(**spec), batch=batch)
    return dm


def compile_serving(model, max_batch_slots: Optional[int] = None,
                    max_decode_len: Optional[int] = None,
                    kv_page_size: Optional[int] = None,
                    draft=None, spec_tokens: Optional[int] = None,
                    kv_cache_dtype: Optional[str] = None,
                    device=None) -> "ServingCompiled":
    """Build the serving programs for a decoder `model` (inputs shaped
    `[batch, seq, ...]`). Knob precedence: explicit args > FFConfig
    fields (--max-batch-slots, --max-decode-len, --kv-page-size,
    --serve-draft-model, --serve-spec-tokens, --kv-cache-dtype) >
    defaults. A `draft` with `spec_tokens` K > 0 turns on speculative
    decoding (see the module docstring)."""
    dev = resolve_device(device)
    cfg = model.config
    # --telemetry-dir turns the span stream on for serving-only runs too
    if getattr(cfg, "telemetry_dir", ""):
        tel.configure(cfg.telemetry_dir,
                      max_mb=getattr(cfg, "telemetry_max_mb", None))
    if getattr(cfg, "search_budget", 0) > 0:
        raise NotImplementedError(
            "compile_serving with search_budget > 0: the serving searches "
            "(serving_optimize) are not ported yet (ROADMAP Queue 1 item 8)")
    slots = int(max_batch_slots or getattr(cfg, "max_batch_slots", 8) or 8)
    max_new = int(max_decode_len or getattr(cfg, "max_decode_len", 0) or 32)
    page = int(kv_page_size or getattr(cfg, "kv_page_size", 16) or 16)
    spec_k = int(spec_tokens if spec_tokens is not None
                 else getattr(cfg, "serve_spec_tokens", 0) or 0)
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
    if draft is None and spec_k > 0 and getattr(cfg, "serve_draft_model", ""):
        draft = _draft_from_spec(cfg, cfg.serve_draft_model,
                                 int(model.input_tensors[0].spec.shape[0]))
    with tel.span("serve/compile_serving", cat="compile", slots=slots,
                  max_decode_len=max_new, kv_page_size=page,
                  spec_tokens=spec_k if draft is not None else 0,
                  kv_dtype=str(kv_dtype)):
        pre_model, attn = clone_for_serving(model, "prefill", slots)
        dec_model, _ = clone_for_serving(model, "decode", slots)
        kv_spec = KVCacheSpec(
            layers=len(attn), heads=heads, head_dim=embed // heads,
            slots=slots, pages_per_slot=-(-(seq + max_new) // page),
            page_size=page, itemsize=kv_itemsize,
            scale_itemsize=kv_scale_itemsize)
        ver_model = None
        draft_engine = None
        if draft is not None and spec_k > 0:
            dseq = int(draft.input_tensors[0].spec.shape[1])
            if dseq != seq:
                raise ValueError(
                    f"draft model seq {dseq} != target seq {seq}: the "
                    "scheduler prefills both from one prompt batch")
            if kv_quantized and cfg.enable_fusion and \
                    spec_k + 1 > MAX_QUERY_ROWS:
                raise ValueError(
                    f"spec_tokens={spec_k}: the verify pass gives the int8 "
                    f"dequant decode kernel (kernels/dequant_attention.py) "
                    f"{spec_k + 1} query rows, past its gate of "
                    f"MAX_QUERY_ROWS={MAX_QUERY_ROWS}; take spec_tokens <= "
                    f"{MAX_QUERY_ROWS - 1}")
            ver_model, _ = clone_for_serving(model, "decode", slots,
                                             decode_seq=spec_k + 1)
            draft_engine = compile_serving(
                draft, max_batch_slots=slots, max_decode_len=max_new,
                kv_page_size=page, spec_tokens=0,
                kv_cache_dtype=kv_cache_dtype, device=dev)
        return ServingCompiled(model, pre_model, dec_model, attn, kv_spec,
                               max_new, kv_dtype=kv_dtype,
                               kv_quantized=kv_quantized, device=dev,
                               verify_model=ver_model,
                               spec_tokens=spec_k if draft_engine else 0,
                               draft=draft_engine)


class ServingCompiled:
    """The serving programs + the paged cache they share (and, when
    speculating, the verify program and the draft's engine)."""

    def __init__(self, model, prefill_model, decode_model,
                 attn_layers: List[str], kv_spec: KVCacheSpec,
                 max_decode_len: int, kv_dtype=torch.float32,
                 kv_quantized: bool = False, device=None,
                 verify_model=None, spec_tokens: int = 0,
                 draft: Optional["ServingCompiled"] = None):
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
        self.spec_tokens = int(spec_tokens)
        self.draft = draft
        self.verify_model = verify_model
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
        self._verify_fwd = None
        if verify_model is not None and self.spec_tokens > 0:
            self._verify_fwd = build_forward(
                verify_model.layers, verify_model.input_tensors,
                verify_model.layers[-1].outputs[:1], **fwd_kw)
        self.params: Optional[Dict[str, Any]] = None
        # inside spec_round_step: its steps record no span of their own
        self._in_round = False
        if tel.enabled():
            tel.event("serve/engine", cat="serve",
                      kv_dtype=str(self.kv_dtype),
                      kv_quantized=self.kv_quantized,
                      spec_tokens=self.spec_tokens)
        # the SLO error budgets of every request served on this engine
        self.slo = SLOTracker(parse_slo(getattr(self.cfg, "serve_slo", "")
                                        or ""))

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
        per-head K/V for `PagedKVCache.commit_prefill`. With telemetry
        on, a `serve/prefill` span of the host's dispatch."""
        t0 = tel.now_us() if tel.enabled() else None
        inputs = [to_device(x, self.device) for x in input_arrays]
        with torch.no_grad():
            outs, kv_state = self._prefill_fwd(params, {}, inputs)
        if t0 is not None:
            tel.record("serve/prefill", t0, cat="serve", slots=self.slots)
        return outs[0], kv_state

    def decode_step(self, params, state, input_arrays):
        """One single-token step over all slots: returns (logits
        `[slots, 1, vocab]`, new cache state with positions advanced).
        Nothing is synchronized with the host. With telemetry on, one
        `serve/decode_step` span of the host's dispatch (none inside a
        speculative round, which is one span)."""
        t0 = tel.now_us() if tel.enabled() and not self._in_round else None
        inputs = [to_device(x, self.device) for x in input_arrays]
        with torch.no_grad():
            outs, ns = self._decode_fwd(params, state, inputs)
            # device-side sequence advance: every ACTIVE slot cached one
            # more token this step (inactive slots stay parked)
            ns[POS_KEY] = state[POS_KEY] + state[ACTIVE_KEY]
        if t0 is not None:
            tel.record("serve/decode_step", t0, cat="serve")
        return outs[0], ns

    def verify_step(self, params, state, input_arrays):
        """One verify pass: the `[slots, K+1]` program takes the last
        committed token and the K drafted ones and returns logits
        `[slots, K+1, vocab]`. Every active slot caches K+1 entries; the
        scheduler re-publishes the committed extent after acceptance."""
        t0 = tel.now_us() if tel.enabled() and not self._in_round else None
        if self._verify_fwd is None:
            raise RuntimeError("verify_step: engine compiled without a "
                               "draft (pass draft=/--serve-draft-model and "
                               "spec_tokens > 0)")
        inputs = [to_device(x, self.device) for x in input_arrays]
        with torch.no_grad():
            outs, ns = self._verify_fwd(params, state, inputs)
            ns[POS_KEY] = state[POS_KEY] + \
                (self.spec_tokens + 1) * state[ACTIVE_KEY]
        if t0 is not None:
            tel.record("serve/decode_step", t0, cat="serve",
                       verify=True, steps=self.spec_tokens + 1)
        return outs[0], ns

    def build_spec_program(self, step_inputs_fn: Callable) -> Callable:
        """One whole speculative round as one function of device tensors:

            (params, draft_params, state, draft_state, last [slots, 1])
                -> (t_pred [slots, K+1], ver_in [slots, K+1],
                    new_state, new_draft_state)

        K chained greedy draft steps, each argmax feeding the next step on
        the device, then one verify pass over `[last, d1..dK]`. Nothing is
        synchronized with the host. `step_inputs_fn(tokens, state)` builds
        the model's inputs from device tensors (`gpt2_step_inputs`)."""
        if self.draft is None or self._verify_fwd is None:
            raise RuntimeError("build_spec_program requires an engine "
                               "compiled with draft= and spec_tokens > 0")
        K = self.spec_tokens
        draft = self.draft

        def spec_round(params, dparams, state, dstate, last):
            cur = last
            drafts = []
            for _ in range(K):
                dlogits, dstate = draft.decode_step(
                    dparams, dstate, step_inputs_fn(cur, dstate))
                cur = torch.argmax(dlogits[:, -1, :], dim=-1).to(
                    torch.int32)[:, None]
                drafts.append(cur)
            ver_in = torch.cat([last] + drafts, dim=1)
            vlogits, state = self.verify_step(params, state,
                                              step_inputs_fn(ver_in, state))
            t_pred = torch.argmax(vlogits, dim=-1).to(torch.int32)
            return t_pred, ver_in, state, dstate

        return spec_round

    def spec_round_step(self, params, draft_params, state, draft_state,
                        last, step_inputs_fn: Callable):
        """Run one speculative round (see `build_spec_program`); with
        telemetry on, one `serve/decode_step` span for the round."""
        fn = self.build_spec_program(step_inputs_fn)
        if not tel.enabled():
            return fn(params, draft_params, state, draft_state, last)
        t0 = tel.now_us()
        self._in_round = self.draft._in_round = True
        try:
            out = fn(params, draft_params, state, draft_state, last)
        finally:
            self._in_round = self.draft._in_round = False
        tel.record("serve/decode_step", t0, cat="serve",
                   spec_round=True, steps=self.spec_tokens + 1)
        return out

    def memory_stats(self) -> Dict[str, int]:
        """Predicted vs measured KV-cache bytes and the param bytes held;
        with a draft, the same three for the draft under `draft_` keys."""
        stats = {
            "predicted_kv_cache_bytes": int(self.kv_spec.total_bytes()),
            "actual_kv_cache_bytes": self.kv.device_bytes(),
            "actual_param_bytes": sum(
                int(t.numel() * t.element_size())
                for d in (self.params or {}).values() for t in d.values()),
        }
        if self.draft is not None:
            stats.update({f"draft_{k}": v for k, v in
                          self.draft.memory_stats().items()})
        return stats

