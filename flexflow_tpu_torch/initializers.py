"""Weight initializers (counterpart: flexflow_tpu/initializers.py).

An initializer is a function (generator, spec, device) -> tensor drawing
from an explicit `torch.Generator`. The defaults are keyed off the weight
name as in the JAX package (`default_initializer`): Glorot uniform for
kernels, zeros for biases, ones for gamma. `ConstantInitializer`,
`UniformInitializer` and `NormInitializer` are the JAX package's other
three, for `kernel_initializer=` overrides. A torch generator gives other
numbers than JAX's threefry from the same seed, so parity tests load the
JAX engine's params instead (convert.py).

A fork-join's weights are named `b{i}.{sub}.{w}` or `stk.{sub}.{w}`: the
default initializer keys off the last part, and a stacked weight is drawn
slice by slice (fan-in and fan-out of the slice), each slice by its
branch's override when it has one, as JAX's `build_init_fn` does.
"""

from __future__ import annotations

import math

import torch

from flexflow_tpu_torch.core.tensor import TensorSpec


class Initializer:
    def __call__(self, gen: torch.Generator, spec: TensorSpec,
                 device) -> torch.Tensor:
        raise NotImplementedError


class GlorotUniformInitializer(Initializer):
    def __call__(self, gen, spec, device):
        shape = spec.shape
        if len(shape) >= 2:
            receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
            fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
            if len(shape) == 2:  # dense kernels are (in, out)
                fan_in, fan_out = shape[0], shape[1]
        else:
            fan_in = fan_out = shape[0]
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)
        return (u * (2 * limit) - limit).to(device=device,
                                            dtype=spec.dtype.torch_dtype)


class ZeroInitializer(Initializer):
    def __call__(self, gen, spec, device):
        return torch.zeros(spec.shape, dtype=spec.dtype.torch_dtype,
                           device=device)


class OneInitializer(Initializer):
    def __call__(self, gen, spec, device):
        return torch.ones(spec.shape, dtype=spec.dtype.torch_dtype,
                          device=device)


class ConstantInitializer(Initializer):
    def __init__(self, value: float):
        self.value = value

    def __call__(self, gen, spec, device):
        return torch.full(spec.shape, self.value,
                          dtype=spec.dtype.torch_dtype, device=device)


class UniformInitializer(Initializer):
    """U(min_value, max_value). `seed` is accepted for the JAX signature;
    the draw comes from the compile's generator, as every weight's does."""

    def __init__(self, seed: int = 0, min_value: float = -0.05,
                 max_value: float = 0.05):
        self.min_value = min_value
        self.max_value = max_value

    def __call__(self, gen, spec, device):
        u = torch.rand(spec.shape, generator=gen, device=gen.device,
                       dtype=torch.float32)
        u = u * (self.max_value - self.min_value) + self.min_value
        return u.to(device=device, dtype=spec.dtype.torch_dtype)


class NormInitializer(Initializer):
    """N(mean, stddev^2); `seed` as in UniformInitializer."""

    def __init__(self, seed: int = 0, mean: float = 0.0, stddev: float = 1.0):
        self.mean = mean
        self.stddev = stddev

    def __call__(self, gen, spec, device):
        n = torch.randn(spec.shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (self.mean + self.stddev * n).to(
            device=device, dtype=spec.dtype.torch_dtype)


def default_initializer(wname: str) -> Initializer:
    if wname in ("bias", "beta", "bq", "bk", "bv", "bo") or wname.startswith("bias"):
        return ZeroInitializer()
    if wname == "gamma":
        return OneInitializer()
    return GlorotUniformInitializer()


def _init_weight(layer, wname: str, spec: TensorSpec, overrides, gen,
                 device) -> torch.Tensor:
    default = default_initializer(wname.rsplit(".", 1)[-1])
    if not wname.startswith("stk."):
        return (overrides.get((layer.name, wname)) or default)(
            gen, spec, device)
    sspec = TensorSpec(spec.shape[1:], spec.dtype)
    return torch.stack([
        (overrides.get((layer.name, f"b{b}.{wname[4:]}")) or default)(
            gen, sspec, device) for b in range(spec.shape[0])])


def init_params(layers, overrides, seed: int, device):
    """`{layer: {weight: tensor}}` for `layers` (those with weights), drawn
    in order from one `torch.Generator` seeded with `seed` on `device`,
    each weight by its override or its default initializer."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return {layer.name: {
        w: _init_weight(layer, w, spec, overrides, gen, device)
        for w, spec in sorted(layer.weight_specs.items())}
        for layer in layers if layer.weight_specs}
