"""Serving: prefill/decode programs, paged KV cache, continuous batching."""

from flexflow_tpu_torch.serving.engine import (  # noqa: F401
    ServingCompiled, compile_serving)
from flexflow_tpu_torch.serving.kv_cache import (  # noqa: F401
    KVCacheSpec, PagedKVCache, kv_dequantize, kv_quantize)
from flexflow_tpu_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatchingScheduler, Request, gpt2_prompt_inputs,
    gpt2_step_inputs)
