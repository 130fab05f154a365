"""Serving: prefill/decode/verify programs, a paged KV cache with a host
tier, continuous batching with speculative decoding, SLO-aware admission,
hot-swap, request tracing and replayable traces; the fleet of in-process
replicas (router, disaggregated handoff, rolling swap) and the capacity
twin that replays a trace through the same control plane."""

from flexflow_tpu_torch.serving import tracefmt  # noqa: F401
from flexflow_tpu_torch.serving.engine import (  # noqa: F401
    ServingCompiled, compile_serving)
from flexflow_tpu_torch.serving.fleet import (  # noqa: F401
    AdmissionControl, FleetRouter, ReplicaHandle, RollingSwapController,
    ServingFleet, merge_histograms, merge_slo_trackers)
from flexflow_tpu_torch.serving.kv_cache import (  # noqa: F401
    ACTIVE_KEY, PAGE_TABLE_KEY, POS_KEY, KVCacheSpec, KVPoolExhausted,
    PagedKVCache, derive_prefetch_ahead, kv_dequantize, kv_quantize)
from flexflow_tpu_torch.serving.reqtrace import (  # noqa: F401
    TERMINAL_FIELDS, RequestTracer, StreamingHistogram, terminal_record)
from flexflow_tpu_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatchingScheduler, Request, gpt2_prompt_inputs,
    gpt2_step_inputs)
from flexflow_tpu_torch.serving.tracefmt import (  # noqa: F401
    Trace, TraceRecord, load_trace, save_trace)
from flexflow_tpu_torch.serving.twin import (  # noqa: F401
    TwinCosts, TwinResult, TwinSpec, capacity_curve, simulate)
