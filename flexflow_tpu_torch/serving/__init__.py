"""Serving: prefill/decode/verify programs, paged KV cache, continuous
batching with speculative decoding and SLO-aware admission."""

from flexflow_tpu_torch.serving.engine import (  # noqa: F401
    ServingCompiled, compile_serving)
from flexflow_tpu_torch.serving.fleet import AdmissionControl  # noqa: F401
from flexflow_tpu_torch.serving.kv_cache import (  # noqa: F401
    KVCacheSpec, KVPoolExhausted, PagedKVCache, kv_dequantize, kv_quantize)
from flexflow_tpu_torch.serving.reqtrace import terminal_record  # noqa: F401
from flexflow_tpu_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatchingScheduler, Request, gpt2_prompt_inputs,
    gpt2_step_inputs)
