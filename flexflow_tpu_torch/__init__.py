"""flexflow_tpu_torch — the PyTorch/CUDA port of the JAX package `flexflow_tpu`.

The JAX package `flexflow_tpu` stays the reference; this package mirrors
its module tree and names, in PyTorch, and imports neither JAX nor
anything of `flexflow_tpu`. Every Pallas TPU kernel on a ported path is a
hand-written CUDA kernel for Hopper here (csrc/, kernels/).
"""

from flexflow_tpu_torch.config import FFConfig  # noqa: F401
from flexflow_tpu_torch.core.model import FFModel  # noqa: F401
from flexflow_tpu_torch.losses import LossType  # noqa: F401
from flexflow_tpu_torch.metrics import MetricsType  # noqa: F401
from flexflow_tpu_torch.optimizers import (  # noqa: F401
    AdamOptimizer, SGDOptimizer)

# set by the launcher (`python -m flexflow_tpu_torch [flags] script.py`,
# __main__.py)
_launch_config = None


def get_launch_config() -> "FFConfig":
    """The FFConfig the launcher parsed from its command line, or a default
    config when the script runs on its own."""
    return _launch_config if _launch_config is not None else FFConfig()
