"""Keras-compatible frontend (counterpart: flexflow_tpu/keras/).

    from flexflow_tpu_torch.keras.models import Model, Sequential
    from flexflow_tpu_torch.keras.layers import Input, Dense, Conv2D, ...
    import flexflow_tpu_torch.keras.optimizers
"""

from flexflow_tpu_torch.keras import (  # noqa: F401
    callbacks,
    datasets,
    initializers,
    layers,
    models,
    optimizers,
    preprocessing,
    regularizers,
)
from flexflow_tpu_torch.losses import LossType as losses  # noqa: F401
from flexflow_tpu_torch.metrics import MetricsType as metrics  # noqa: F401
