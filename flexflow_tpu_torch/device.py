"""The one device resolver of the port's entry points.

`compile_serving` and `compile_model` (and the objects they return) run on
the GPU: `device=None` means "cuda", and a CUDA request without a CUDA
device raises instead of carrying on quietly on the CPU. The CPU is used
only when the caller asks for it (`device="cpu"`, as the tests do, or the
launcher's `FLEXFLOW_PLATFORM=cpu`, which sets the default below).
"""

from __future__ import annotations

import numpy as np
import torch


# the device that `device=None` means: "cuda" unless the launcher was
# asked for another platform (set_default_device)
_DEFAULT = ["cuda"]

# FLEXFLOW_PLATFORM's values (JAX's platform names) -> torch device types
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def set_default_device(platform: str) -> None:
    """Make `device=None` mean `platform` ("cpu", "gpu" or "cuda") for the
    rest of the process: the launcher's explicit request for a device."""
    if platform not in PLATFORMS:
        raise ValueError(f"FLEXFLOW_PLATFORM={platform!r}: the port runs on "
                         f"one of {sorted(PLATFORMS)}")
    _DEFAULT[0] = PLATFORMS[platform]


def resolve_device(device=None) -> torch.device:
    dev = torch.device(_DEFAULT[0] if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: flexflow_tpu_torch runs on the GPU; pass "
            "device='cpu' to run on the CPU")
    return dev


def to_device(x, device) -> torch.Tensor:
    """A tensor or numpy array on `device` (numpy arrays keep their type)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def to_device_async(x, device) -> torch.Tensor:
    """A copy of numpy array `x` on `device` that makes the host wait for
    nothing: on a CUDA device through a fresh pinned buffer and a
    non-blocking copy (the pinned allocator holds the buffer until the copy
    has run, so `x` may change at once), on the CPU a plain copy."""
    t = torch.from_numpy(np.array(x))
    dev = torch.device(device)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)
