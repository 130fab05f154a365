"""Model builders."""

from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2  # noqa: F401
