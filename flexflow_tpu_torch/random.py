"""Keys and generators for the port's random draws (the counterpart of the
JAX package's use of `jax.random`).

A key is a Python int below 2**64. `key(seed)` makes one from a seed and
`fold_in(key, data)` derives another from a key and an int, by a fixed
64-bit mix (splitmix64's finalizer), as `jax.random.fold_in` derives a
threefry key: the same (key, data) gives the same key in every process.
`generator(key, device)` returns a fresh `torch.Generator` on `device`
seeded from the key, so a draw depends on the key alone: drawing again
from a new generator of the same key repeats it (the recompute of a
rematerialized layer draws the same dropout mask). Nothing here touches
torch's global RNG.

The draws are PyTorch's (Philox on the GPU, mt19937 on the CPU), not
threefry's: the port's masks have the same law as the JAX package's, not
the same bits.
"""

from __future__ import annotations

import torch

_MASK = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _mix(z: int) -> int:
    z = (z + _GOLDEN) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def key(seed: int) -> int:
    """The key of an integer seed."""
    return _mix(int(seed) & _MASK)


def fold_in(k: int, data: int) -> int:
    """A new key from key `k` and the integer `data`."""
    return _mix(int(k) ^ _mix(int(data) & _MASK))


def generator(k: int, device) -> torch.Generator:
    """A fresh generator on `device`, seeded from key `k`."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(k) & _MASK)
    return g
