"""The C API (counterpart: flexflow_tpu/capi/): flexflow_c.h and
flexflow_c.cc, a library that embeds CPython and drives this package, so
a C program builds, compiles, fits and runs a model (examples/c/
mlp_train.c compiles against it unchanged). `build.py` builds it into
build/flexflow_tpu_torch/ and runs the example.

The helpers below are what the library calls back into: `host_f32`
copies a forward's output to a host array, and `on_finalize` writes the
kernels' launch counts to the file `FLEXFLOW_CAPI_LAUNCH_COUNTS` names
(how a caller sees which kernels a C program's fit launched).
"""

from __future__ import annotations

import json
import os

import numpy as np

LAUNCH_COUNTS_ENV = "FLEXFLOW_CAPI_LAUNCH_COUNTS"


def host_f32(out) -> np.ndarray:
    """A model output (a tensor on its device) as a host float32 array."""
    return np.ascontiguousarray(out.detach().float().cpu().numpy())


def on_finalize() -> None:
    from flexflow_tpu_torch.kernels import launch_counts

    path = os.environ.get(LAUNCH_COUNTS_ENV)
    if path:
        with open(path, "w") as f:
            json.dump(launch_counts(), f)
