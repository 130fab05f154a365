"""The torch.fx frontend (counterpart: flexflow_tpu/torch/). Import it as
`from flexflow_tpu_torch.torch import PyTorchModel`."""

from flexflow_tpu_torch.torch.model import (  # noqa: F401
    PyTorchModel,
    file_to_ff,
    torch_to_flexflow,
)
