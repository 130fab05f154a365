"""flexflow_tpu_torch — the PyTorch/CUDA port of the JAX package `flexflow_tpu`.

The JAX package `flexflow_tpu` stays the reference; this package mirrors
its module tree and names, in PyTorch, and imports neither JAX nor
anything of `flexflow_tpu`. Every Pallas TPU kernel on a ported path is a
hand-written CUDA kernel for Hopper here (csrc/, kernels/). The names it
exports are `flexflow_tpu`'s, `compile_serving` lazily as there.
"""

from flexflow_tpu_torch.dtype import DataType  # noqa: F401
from flexflow_tpu_torch.config import FFConfig  # noqa: F401
from flexflow_tpu_torch.core.tensor import Tensor, TensorSpec  # noqa: F401
from flexflow_tpu_torch.core.model import FFModel  # noqa: F401
from flexflow_tpu_torch.losses import LossType  # noqa: F401
from flexflow_tpu_torch.metrics import MetricsType  # noqa: F401
from flexflow_tpu_torch.ops.op_type import OperatorType  # noqa: F401
from flexflow_tpu_torch.optimizers import (  # noqa: F401
    AdamOptimizer, SGDOptimizer)

__version__ = "0.1.0"

# set by the launcher (`python -m flexflow_tpu_torch [flags] script.py`,
# __main__.py)
_launch_config = None


def get_launch_config() -> "FFConfig":
    """The FFConfig the launcher parsed from its command line, or a default
    config when the script runs on its own."""
    return _launch_config if _launch_config is not None else FFConfig()


def __getattr__(name):
    # lazy: the serving stack pulls in the compiler's, which a plain
    # `import flexflow_tpu_torch` (the launcher, the tests) need not load
    if name == "compile_serving":
        from flexflow_tpu_torch.serving.engine import compile_serving

        return compile_serving
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DataType",
    "FFConfig",
    "FFModel",
    "Tensor",
    "TensorSpec",
    "SGDOptimizer",
    "AdamOptimizer",
    "LossType",
    "MetricsType",
    "OperatorType",
    "compile_serving",
]
