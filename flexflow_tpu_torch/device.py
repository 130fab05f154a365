"""The one device resolver of the port's entry points.

`compile_serving` and `compile_model` (and the objects they return) run on
the GPU: `device=None` means "cuda", and a CUDA request without a CUDA
device raises instead of carrying on quietly on the CPU. The CPU is used
only when the caller asks for it (`device="cpu"`, as the tests do).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
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
