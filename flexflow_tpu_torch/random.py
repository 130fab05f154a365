"""Keys and generators for the port's random draws (the counterpart of the
JAX package's use of `jax.random`).

A key is a Python int below 2**64. `key(seed)` makes one from a seed and
`fold_in(key, data)` derives another from a key and an int, by a fixed
64-bit mix (splitmix64's finalizer), as `jax.random.fold_in` derives a
threefry key: the same (key, data) gives the same key in every process.
A key may also live on the device, as a 0-dim int64 tensor holding the
key's 64 bits (two's complement): `device_key(k, device)` puts one there,
and `fold_in` takes a device key or a device step index and returns a
device key, bitwise equal to the host mix (torch has no unsigned 64-bit
arithmetic, so each right shift of the mix is masked to a logical one).
That is how a captured CUDA graph of K train steps (compiler/compile.py
`make_multi_step`) draws step i's masks from fold_in(base, i0 + i) with
i0 written to the device before each replay.

`bernoulli_mask(key, shape, keep)` draws the dropout masks: element e is
kept when a counter-based hash of (key, e) falls below keep * 2**32. The
hash is int32 arithmetic on device tensors, the same ops on the CPU and
the card, so a host key and its device copy draw the same mask bit for
bit, eagerly or inside a graph, and the recompute of a rematerialized
layer draws its mask again. Nothing here touches torch's global RNG.

The hash is not threefry: the port's masks have the same law as the JAX
package's, not the same bits.
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


def _signed(z: int, bits: int = 64) -> int:
    z &= (1 << bits) - 1
    return z - (1 << bits) if z >> (bits - 1) else z


def _mix_t(z: torch.Tensor) -> torch.Tensor:
    """`_mix` on an int64 tensor (wrapping adds and products, shifts
    masked to logical ones)."""
    z = z + _signed(_GOLDEN)
    z = (z ^ ((z >> 30) & ((1 << 34) - 1))) * _signed(0xBF58476D1CE4E5B9)
    z = (z ^ ((z >> 27) & ((1 << 37) - 1))) * _signed(0x94D049BB133111EB)
    return z ^ ((z >> 31) & ((1 << 33) - 1))


def key(seed: int) -> int:
    """The key of an integer seed."""
    return _mix(int(seed) & _MASK)


def key_int64(k: int) -> int:
    """Key `k`'s 64 bits as a signed int64 value (what a device key
    holds)."""
    return _signed(int(k))


def device_key(k: int, device) -> torch.Tensor:
    """Key `k` as a 0-dim int64 tensor on `device`."""
    return torch.full((), key_int64(k), dtype=torch.int64, device=device)


def host_key(k) -> int:
    """A device key's value as a host key (a host sync)."""
    return int(k) & _MASK if isinstance(k, torch.Tensor) else int(k)


def fold_in(k, data):
    """A new key from key `k` and the integer `data`: host ints give a
    host int; a device key or a device `data` gives a device key."""
    if not isinstance(k, torch.Tensor) and not isinstance(data, torch.Tensor):
        return _mix(int(k) ^ _mix(int(data) & _MASK))
    md = (_mix_t(data.to(torch.int64)) if isinstance(data, torch.Tensor)
          else _signed(_mix(int(data) & _MASK)))
    if not isinstance(k, torch.Tensor):
        k = _signed(int(k))
    return _mix_t(k ^ md)


# the hash of bernoulli_mask: murmur3's 32-bit finalizer constants
_C1, _C2 = _signed(0x85EBCA6B, 32), _signed(0xC2B2AE35, 32)


def _xorshift_(x: torch.Tensor, s: int) -> torch.Tensor:
    """x ^= x >>> s on int32, in place (the shift masked to a logical
    one)."""
    return x.bitwise_xor_((x >> s).bitwise_and_((1 << (32 - s)) - 1))


def _halves(k):
    """The key's low and high 32 bits as int32 (ints or 0-dim tensors)."""
    if isinstance(k, torch.Tensor):
        return k.to(torch.int32), (k >> 32).to(torch.int32)
    k = int(k) & _MASK
    return _signed(k, 32), _signed(k >> 32, 32)


def bernoulli_mask(k, shape, keep: float, device) -> torch.Tensor:
    """Bool mask of `shape` on `device`, True with probability `keep`
    (0 < keep < 1), from key `k` (a host int or a device key): element e
    (row-major) is kept when h(e) < keep * 2**32 - 2**31, with
    h(e) = m(m((e ^ lo) ^ (e ^ lo) >>> 16) * C1 + hi) as below, lo and hi
    the key's halves and all arithmetic wrapping int32."""
    n = 1
    for d in shape:
        n *= int(d)
    if n >= 2 ** 31:
        raise ValueError(f"bernoulli_mask: {n} elements, at most 2**31 - 1")
    lo, hi = _halves(k)
    x = torch.arange(n, dtype=torch.int32, device=device)
    x.bitwise_xor_(lo)
    _xorshift_(x, 16).mul_(_C1).add_(hi)
    _xorshift_(x, 13).mul_(_C2)
    _xorshift_(x, 16)
    thresh = int(round(keep * 2.0 ** 32)) - 2 ** 31
    return (x < thresh).reshape(tuple(shape))
