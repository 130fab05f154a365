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

Tiered KV (`kv_host_pages` H > 0): host pages SUBSTITUTE device pages.
The device pool shrinks to slots * pages_per_slot - H data pages (floored
at one slot's worth), so the two tiers together hold every slot's worth
while the device holds less; the scheduler rotates parked slots through
(serving/kv_cache.py, serving/scheduler.py).

Live hot-swap: `watch(root)` points the engine at a root of the port's
durable snapshots (runtime/resilience.py's atomic commits, the tree format
of runtime/checkpoint.py); `poll_swap()`, which the scheduler calls only
between dispatch windows, loads a newer committed snapshot into a second
param tree (its graph fingerprint validated first against the decode
program, `CheckpointMismatchError` on a foreign model), placed in the
compute dtype, then activates it by a pointer flip. Retained versions
(`retain` trees) keep their tensors for `rollback()`, which re-pins one:
`poll_swap` stops advancing until `unpin()`. A rejected snapshot
(`serve/swap_rejected`) or a read that fails past its retries
(`serve/param_swap` fault site, `serve/swap_failed`) leaves the live
version serving.

`health_report()` carries the watermark, the swap ledger, the SLO
scoreboard, the scaling signal and the KV tier's panel; `op_attribution()`
prices each op of the prefill and decode programs with the serving cost
functions (serving/program.py) beside its measured time.

The entry points run on the GPU: `device=None` means "cuda", and without a
CUDA device they raise unless the caller asks for `device="cpu"` (as the
tests do). Params are placed once in the compute dtype (norm params stay
f32, as the forward's cast would leave them), so the per-step cast of the
mixed-precision policy is free.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from flexflow_tpu_torch import health
from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.compiler.lowering import (build_forward, cast_dtype,
                                                  cast_exempt)
from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.device import resolve_device, to_device_async
from flexflow_tpu_torch.initializers import init_params
from flexflow_tpu_torch.kernels.dequant_attention import MAX_QUERY_ROWS
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.parallel.default_strategy import data_parallel_strategy
from flexflow_tpu_torch.runtime.checkpoint import (TREE_FILE,
                                                   CheckpointMismatchError,
                                                   _graph_fingerprint)
from flexflow_tpu_torch.runtime.resilience import (RetryPolicy,
                                                   committed_snapshots,
                                                   run_resilient)
from flexflow_tpu_torch.serving.kv_cache import (ACTIVE_KEY, PAGE_TABLE_KEY,
                                                 POS_KEY, KVCacheSpec,
                                                 PagedKVCache)
from flexflow_tpu_torch.serving.program import clone_for_serving

log = logging.getLogger("flexflow_tpu_torch")


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
    decoding; `kv_host_pages` gives the cache a host tier (see the module
    docstring)."""
    from flexflow_tpu_torch.compiler.compile import resolve_machine

    dev = resolve_device(device)
    cfg = model.config
    # --telemetry-dir turns the span stream on for serving-only runs too
    if getattr(cfg, "telemetry_dir", ""):
        tel.configure(cfg.telemetry_dir,
                      max_mb=getattr(cfg, "telemetry_max_mb", None))
    if getattr(cfg, "search_budget", 0) > 0:
        raise NotImplementedError(
            "compile_serving with search_budget > 0: the serving searches "
            "(serving_optimize) are not ported yet (ROADMAP Queue 1 item 9)")
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
        machine = resolve_machine(cfg, device=dev)
        pre_model, attn = clone_for_serving(model, "prefill", slots)
        dec_model, _ = clone_for_serving(model, "decode", slots)
        pages_per_slot = -(-(seq + max_new) // page)
        host_pages = max(0, int(getattr(cfg, "kv_host_pages", 0) or 0))
        device_pages = 0
        if host_pages:
            device_pages = max(pages_per_slot,
                               slots * pages_per_slot - host_pages)
        kv_spec = KVCacheSpec(
            layers=len(attn), heads=heads, head_dim=embed // heads,
            slots=slots, pages_per_slot=pages_per_slot,
            page_size=page, itemsize=kv_itemsize,
            scale_itemsize=kv_scale_itemsize,
            host_pages=host_pages, device_pages=device_pages)
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
                               draft=draft_engine, machine=machine)


class ServingCompiled:
    """The serving programs + the paged cache they share (and, when
    speculating, the verify program and the draft's engine)."""

    def __init__(self, model, prefill_model, decode_model,
                 attn_layers: List[str], kv_spec: KVCacheSpec,
                 max_decode_len: int, kv_dtype=torch.float32,
                 kv_quantized: bool = False, device=None,
                 verify_model=None, spec_tokens: int = 0,
                 draft: Optional["ServingCompiled"] = None, *, machine):
        self.model = model
        self.cfg = model.config
        self.device = resolve_device(device)
        self.machine = machine  # the MachineSpec compile_serving resolved
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
        # one device: both programs take the data-parallel strategy, as the
        # JAX engine does on one device (what op_attribution prices)
        self.prefill_strategy = data_parallel_strategy(prefill_model,
                                                       self.machine)
        self.decode_strategy = data_parallel_strategy(decode_model,
                                                      self.machine)
        self.kv = PagedKVCache(kv_spec, self.attn_layers, dtype=kv_dtype,
                               quantized=self.kv_quantized, device=self.device,
                               machine=self.machine)
        self._watermarks = health.WatermarkTracker()
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
        self.slo = health.SLOTracker(health.parse_slo(
            getattr(self.cfg, "serve_slo", "") or ""))
        # hot-swap: the watch root and the retained version trees
        self.swap_stats = health.SwapStats()
        self.swap_bytes = 0    # bytes placed by the last swap
        self._watch_root: Optional[str] = None
        self._watch_poll_s = 0.25
        self._last_poll = 0.0
        self._retain = 2
        self._versions: "OrderedDict[Any, Dict[str, Any]]" = OrderedDict()
        self._pinned = False
        self._bad_snapshots: set = set()
        self._swap_policy = RetryPolicy.from_config(self.cfg)
        if getattr(self.cfg, "serve_watch_dir", ""):
            self.watch(self.cfg.serve_watch_dir)

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
        self._sample_watermark("serve_init")
        return self.params

    def _sample_watermark(self, tag: str) -> None:
        self._watermarks.sample(tag, (self.params, self.kv.state),
                                device=self.device)

    def _validate_incoming(self, params, source: str) -> None:
        """Layer-name sets and per-weight shapes of an incoming tree against
        the decode graph; `CheckpointMismatchError` lists the diffs."""
        live = {l.name: l for l in self._weight_layers()}
        diffs: List[str] = []
        only_in = sorted(set(params) - set(live))
        only_live = sorted(set(live) - set(params))
        if only_in:
            diffs.append(f"layers only in incoming tree: {only_in[:8]}")
        if only_live:
            diffs.append(f"layers only in serving graph: {only_live[:8]}")
        for name in sorted(set(live) & set(params)):
            lp, layer = params[name], live[name]
            for w, s in sorted(layer.weight_specs.items()):
                if w not in lp:
                    diffs.append(f"{name}: missing weight {w!r}")
                elif tuple(lp[w].shape) != tuple(s.shape):
                    diffs.append(f"{name}.{w}: shape {tuple(lp[w].shape)}"
                                 f" vs expected {tuple(s.shape)}")
        if diffs:
            raise CheckpointMismatchError(
                f"params tree from {source} does not match the serving "
                "graph:\n  " + "\n  ".join(diffs))

    def _placed_dtypes(self) -> Dict[str, Dict[str, torch.dtype]]:
        """The dtype each weight is placed in: the compute dtype, norm
        params f32 (as the forward's cast would leave them)."""
        layers = self._weight_layers()
        cast_to = cast_dtype(self.cfg.compute_dtype)
        exempt = cast_exempt(layers)
        out = {}
        for layer in layers:
            d = {}
            for w, spec in layer.weight_specs.items():
                dt = spec.dtype.torch_dtype
                if cast_to is not None and dt.is_floating_point and \
                        w not in exempt.get(layer.name, ()):
                    dt = cast_to
                d[w] = dt
            out[layer.name] = d
        return out

    def _place_params(self, params, source: str = "load_params"
                      ) -> Dict[str, Any]:
        """Validate a params tree against the decode graph and place it on
        the device in `_placed_dtypes`."""
        self._validate_incoming(params, source)
        placed = {}
        for name, dtypes in self._placed_dtypes().items():
            d = {}
            for w, dt in dtypes.items():
                x = params[name][w]
                if not isinstance(x, torch.Tensor):
                    x = torch.from_numpy(np.ascontiguousarray(x))
                d[w] = x.to(device=self.device, dtype=dt).contiguous()
            placed[name] = d
        return placed

    def load_params(self, params) -> Dict[str, Any]:
        """Adopt a params tree `{layer: {weight: tensor or array}}`. Raises
        `CheckpointMismatchError` when its layer names or weight shapes do
        not match the serving graph."""
        self.params = self._place_params(params)
        self._sample_watermark("serve_load")
        return self.params

    # ------------------------------------------------------------ hot-swap
    @property
    def watching(self) -> bool:
        return bool(self._watch_root)

    @property
    def active_version(self) -> Optional[int]:
        """Training step of the live weights (None = init/load_params)."""
        return self.swap_stats.active_version

    def watch(self, root: str, poll_interval_s: float = 0.25,
              retain: int = 2, policy: Optional[RetryPolicy] = None
              ) -> "ServingCompiled":
        """Arm hot-swapping: poll `root` (a durable-checkpoint root) for
        newer committed snapshots every `poll_interval_s`, retaining
        `retain` param trees for rollback."""
        self._watch_root = os.path.abspath(root)
        self._watch_poll_s = float(poll_interval_s)
        self._retain = max(1, int(retain))
        if policy is not None:
            self._swap_policy = policy
        self._last_poll = 0.0
        return self

    def poll_swap(self, force: bool = False) -> bool:
        """Discover and swap: if the watch root holds a committed snapshot
        newer than the active version (and no rollback pin is set), load
        and activate it. The scheduler calls this between dispatch windows
        only. Returns True iff the live params changed. A snapshot that
        fails validation, or whose read fails past the retry budget, is
        rejected (counted, an error event) and the live version serves
        on."""
        if not self._watch_root or self._pinned:
            return False
        now = time.monotonic()
        if not force and now - self._last_poll < self._watch_poll_s:
            return False
        self._last_poll = now
        snaps = committed_snapshots(self._watch_root)
        if not snaps:
            return False
        step, path, _man = snaps[-1]
        cur = self.swap_stats.active_version
        if (cur is not None and step <= cur) or path in self._bad_snapshots:
            return False
        try:
            self.hot_swap(path, step)
            return True
        except CheckpointMismatchError as e:
            self._bad_snapshots.add(path)
            self.swap_stats.record_rejected()
            tel.error("serve/swap_rejected", path=path, error=str(e)[:400])
            log.warning("hot-swap rejected %s: %s", path, e)
            return False
        except Exception as e:  # noqa: BLE001 - a read failed past retries
            self.swap_stats.record_rejected()
            tel.error("serve/swap_failed", path=path, error=repr(e)[:400])
            log.warning("hot-swap failed for %s (will retry next poll): %s",
                        path, e)
            return False

    def hot_swap(self, path: str, step: Optional[int] = None,
                 rollback: bool = False) -> Dict[str, Any]:
        """Load the durable snapshot at `path` into a standby param tree
        (fingerprint-validated; `run_resilient` around the read, site
        `serve/param_swap`), place it on the device and activate it by a
        pointer flip. The latency includes a device sync, so it covers the
        placement; `swap_bytes` holds the bytes placed."""
        t0 = time.perf_counter()
        t0_us = tel.now_us() if tel.enabled() else 0

        def read():
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            saved = (meta.get("fingerprint") or {}).get("graph")
            if saved is not None:
                self._validate_graph_fp(saved, path)
            with open(os.path.join(path, TREE_FILE), "rb") as f:
                tree = torch.load(f, map_location="cpu", weights_only=True)
            return meta, tree["params"]

        meta, raw = run_resilient("serve/param_swap", read,
                                  policy=self._swap_policy)
        placed = self._place_params(raw, source=path)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if step is None:
            step = int(meta.get("iteration", -1))
        prev, prev_version = self.params, self.swap_stats.active_version
        self.params = placed  # THE swap: one pointer flip between windows
        if prev is not None and prev_version not in self._versions:
            self._versions[prev_version] = prev
        self._versions[step] = placed
        self._versions.move_to_end(step)
        while len(self._versions) > self._retain:
            oldest = next(iter(self._versions))
            if oldest == step:
                break
            del self._versions[oldest]
        lat = time.perf_counter() - t0
        self.swap_bytes = sum(int(t.numel() * t.element_size())
                              for d in placed.values() for t in d.values())
        self.swap_stats.record_swap(step, lat, rollback=rollback)
        if tel.enabled():
            tel.record("serve/param_swap", t0_us, cat="serve",
                       version=int(step), path=path, rollback=bool(rollback),
                       bytes=self.swap_bytes)
        self._sample_watermark("serve_swap")
        log.info("hot-swap: version %s live in %.1f ms (%s)", step,
                 1e3 * lat, path)
        return placed

    def _validate_graph_fp(self, saved_graph: Dict[str, str],
                           path: str) -> None:
        """The snapshot's training-graph fingerprint against the decode
        program's (a serving clone keeps every layer name and weight
        schema of the graph it was cloned from)."""
        live = _graph_fingerprint(self.decode_model)
        diffs: List[str] = []
        only_ck = sorted(set(saved_graph) - set(live))
        only_live = sorted(set(live) - set(saved_graph))
        changed = sorted(k for k in set(saved_graph) & set(live)
                         if saved_graph[k] != live[k])
        if only_ck:
            diffs.append(f"layers only in checkpoint: {only_ck[:8]}")
        if only_live:
            diffs.append(f"layers only in serving graph: {only_live[:8]}")
        if changed:
            diffs.append("layers with different weight schema "
                         f"(op/shape/dtype): {changed[:8]}")
        if diffs:
            raise CheckpointMismatchError(
                f"snapshot {path} does not match the serving graph:\n  "
                + "\n  ".join(diffs))

    def rollback(self, step: Any = "previous") -> Optional[int]:
        """Flip the live params back to a retained version `step` (default:
        the most recently retained one that is not live) and PIN it:
        `poll_swap` stops advancing until `unpin()`. A version no longer
        retained is reloaded from the watch root."""
        cur = self.swap_stats.active_version
        if step == "previous":
            candidates = [k for k in self._versions if k != cur]
            if not candidates:
                raise ValueError("rollback: no retained version to re-pin")
            step = candidates[-1]
        t0 = time.perf_counter()
        if step in self._versions:
            self.params = self._versions[step]
            self._versions.move_to_end(step)
            self.swap_stats.record_swap(step, time.perf_counter() - t0,
                                        rollback=True)
        else:
            on_disk = {s: p for s, p, _m in
                       committed_snapshots(self._watch_root or "")}
            if step not in on_disk:
                raise ValueError(f"rollback: version {step!r} not retained "
                                 "in memory or on disk")
            self.hot_swap(on_disk[step], step, rollback=True)
        self._pinned = True
        log.info("rollback: version %s re-pinned (auto-swap paused)", step)
        return step if isinstance(step, int) else None

    def unpin(self) -> None:
        """Resume auto-swapping after a rollback pin."""
        self._pinned = False
        self._last_poll = 0.0

    # ------------------------------------------------------------ programs
    def _input(self, x) -> torch.Tensor:
        """An input on the engine's device; a host array is copied without
        making the host wait."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return to_device_async(x, self.device)

    def prefill(self, params, input_arrays):
        """Run the prefill program: returns (logits, kv_state) where
        kv_state maps each attention layer to its `[slots, S, h, d]`
        per-head K/V for `PagedKVCache.commit_prefill`. With telemetry
        on, a `serve/prefill` span of the host's dispatch."""
        t0 = tel.now_us() if tel.enabled() else None
        inputs = [self._input(x) for x in input_arrays]
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
        inputs = [self._input(x) for x in input_arrays]
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
        inputs = [self._input(x) for x in input_arrays]
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

    def _predicted_param_bytes(self) -> int:
        """The bytes `_place_params` places."""
        specs = {l.name: l.weight_specs for l in self._weight_layers()}
        return sum(math.prod(specs[name][w].shape)
                   * torch.empty((), dtype=dt).element_size()
                   for name, d in self._placed_dtypes().items()
                   for w, dt in d.items())

    def memory_stats(self) -> Dict[str, int]:
        """Predicted vs measured KV-cache bytes (the device pool) and param
        bytes; the host tier's bytes beside them, apart from the device
        figures; with a draft, the draft's under `draft_` keys."""
        pred_kv = int(self.kv_spec.total_bytes())
        pred_params = self._predicted_param_bytes()
        stats = {
            "predicted_kv_cache_bytes": pred_kv,
            "actual_kv_cache_bytes": self.kv.device_bytes(),
            "predicted_param_bytes": pred_params,
            "predicted_total_bytes": pred_kv + pred_params,
            "actual_param_bytes": sum(
                int(t.numel() * t.element_size())
                for d in (self.params or {}).values() for t in d.values()),
            "kv_pool_pages": int(self.kv_spec.pool_pages),
            "predicted_kv_host_bytes": int(self.kv_spec.host_bytes()),
            "actual_kv_host_bytes": int(self.kv.host_bytes()),
        }
        if self.draft is not None:
            stats.update({f"draft_{k}": v for k, v in
                          self.draft.memory_stats().items()})
        return stats

    def health_report(self) -> Dict[str, Any]:
        """The serving footprint's watermark (params + KV pools; on the
        card the allocator's peak) against its prediction, the hot-swap
        ledger, the SLO scoreboard, the scaling signal and, with a host
        tier, the KV tier's panel."""
        serving = self.swap_stats.report()
        serving["slo"] = self.slo.report()
        serving["scaling"] = health.scaling_signal(serving["slo"])
        if self.kv.host_pages:
            serving["kv_tier"] = health.format_kv_tier(self.kv.tier_stats())
        return {"watermarks": self._watermarks.report(
                    self.memory_stats()["predicted_total_bytes"]),
                "serving": serving}

    def _measure_state(self, layer) -> Dict[str, Any]:
        """The lowering state MeasuredCost gives a decode attention: fresh
        pools of the cache's geometry, every slot holding all its pages
        and its position at the last one the cache admits (the longest
        context); nothing of the live cache is touched."""
        if not layer.params.get("decode"):
            return {}
        spec, dev = self.kv_spec, self.device
        pps, page = spec.pages_per_slot, spec.page_size
        st = PagedKVCache(dataclasses.replace(spec, layers=1,
                                              host_pages=0, device_pages=0),
                          [layer.name], device=dev, dtype=self.kv_dtype,
                          quantized=self.kv_quantized).state
        st[PAGE_TABLE_KEY] = (1 + torch.arange(
            spec.slots * pps, dtype=torch.int32, device=dev)).reshape(
                spec.slots, pps)
        st[POS_KEY] = torch.full((spec.slots,), pps * page - 1 -
                                 int(layer.inputs[0].spec.shape[1]),
                                 dtype=torch.int32, device=dev)
        return st

    def op_attribution(self, kind: str = "both",
                       step_time_s: Optional[float] = None,
                       prefill_step_time_s: Optional[float] = None,
                       print_table: bool = False, top: int = 0
                       ) -> Dict[str, Any]:
        """Per-op attribution of the serving programs: one report per
        program ("serve_prefill", "serve_decode"), each op priced by the
        serving cost functions and measured in isolation (MeasuredCost on
        the engine's device, forward only) and, with a step time, rescaled
        to it. step_time_s normalizes the decode rows, prefill_step_time_s
        the prefill rows."""
        from flexflow_tpu_torch import attribution
        from flexflow_tpu_torch.search.candidates import compiled_candidate
        from flexflow_tpu_torch.serving.program import (_decode_cost_fn,
                                                        _prefill_cost_fn)

        programs = []
        if kind in ("both", "prefill"):
            programs.append(("serve_prefill", self.prefill_model,
                             self.prefill_strategy,
                             _prefill_cost_fn(self.machine),
                             prefill_step_time_s))
        if kind in ("both", "decode"):
            programs.append(("serve_decode", self.decode_model,
                             self.decode_strategy,
                             _decode_cost_fn(self.machine,
                                             self.kv_spec.layer_bytes()),
                             step_time_s))
        reports: Dict[str, Any] = {}
        for tag, smodel, strategy, cost, t_step in programs:
            batch_sizes = {t.spec.shape[0] for t in smodel.input_tensors
                           if t.spec.ndim > 0}
            items = []
            for layer in topo_order(smodel.layers):
                cand = compiled_candidate(layer, strategy, self.machine,
                                          batch_sizes)
                if cand.passthrough:
                    continue
                try:
                    predicted = float(cost(layer, cand))
                except Exception:  # noqa: BLE001 - unpriced: the analytic
                    predicted = None  # op time stands in, as in JAX
                items.append({"layer": layer, "cand": cand,
                              "machine": self.machine,
                              "predicted_s": predicted, "stage": None})
            report = attribution.build_report(
                items, step_time_s=t_step, mult=1, source="measure",
                inference=True, tag=tag, device=self.device,
                compute_dtype=self.cfg.compute_dtype,
                state_fn=self._measure_state)
            if print_table:
                print(f"[{tag}]")
                for line in attribution.format_report(report, top=top):
                    print(line)
            reports[tag] = report
        return reports
