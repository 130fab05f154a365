"""Weight initializers (counterpart: flexflow_tpu/initializers.py).

An initializer is a function (generator, spec, device) -> tensor drawing
from an explicit `torch.Generator`. The defaults are keyed off the weight
name as in the JAX package (`default_initializer`): Glorot uniform for
kernels, zeros for biases, ones for gamma. A torch generator gives other
numbers than JAX's threefry from the same seed, so parity tests load the
JAX engine's params instead (convert.py).
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


def default_initializer(wname: str) -> Initializer:
    if wname in ("bias", "beta", "bq", "bk", "bv", "bo") or wname.startswith("bias"):
        return ZeroInitializer()
    if wname == "gamma":
        return OneInitializer()
    return GlorotUniformInitializer()


def init_params(layers, overrides, seed: int, device):
    """`{layer: {weight: tensor}}` for `layers` (those with weights), drawn
    in order from one `torch.Generator` seeded with `seed` on `device`,
    each weight by its override or its default initializer."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return {layer.name: {
        w: (overrides.get((layer.name, w)) or default_initializer(w))(
            gen, spec, device)
        for w, spec in sorted(layer.weight_specs.items())}
        for layer in layers if layer.weight_specs}
