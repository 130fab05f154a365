"""Symbolic tensors of the frontend graph (counterpart: flexflow_tpu/core/tensor.py).

A `Tensor` is a handle into the layer graph: its spec (shape and dtype)
and the producing layer. Arrays only exist when a lowering
runs the graph (compiler/lowering.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from flexflow_tpu_torch.dtype import DataType


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Static shape + dtype."""

    shape: Tuple[int, ...]
    dtype: DataType = DataType.FLOAT

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))
        if any(d <= 0 for d in self.shape):
            raise ValueError(f"non-positive dim in shape {self.shape}")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def num_elements(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    @property
    def size_bytes(self) -> int:
        return self.num_elements * self.dtype.itemsize

    def with_shape(self, shape) -> "TensorSpec":
        return TensorSpec(tuple(shape), self.dtype)

    def with_dtype(self, dtype: DataType) -> "TensorSpec":
        return TensorSpec(self.shape, dtype)

    def __repr__(self):
        return f"{self.dtype.value}{list(self.shape)}"


class Tensor:
    """Symbolic value in the layer graph. `owner` is the producing Layer
    (None for graph inputs from FFModel.create_tensor), `owner_idx` its
    output slot."""

    _next_guid = [1000]

    def __init__(self, spec: TensorSpec, owner=None, owner_idx: int = 0,
                 name: Optional[str] = None):
        self.spec = spec
        self.owner = owner
        self.owner_idx = owner_idx
        self.guid = Tensor._next_guid[0]
        Tensor._next_guid[0] += 1
        self.name = name or f"tensor_{self.guid}"

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.spec.shape

    @property
    def dtype(self) -> DataType:
        return self.spec.dtype

    @property
    def ndim(self) -> int:
        return self.spec.ndim

    def __repr__(self):
        return f"Tensor({self.name}: {self.spec})"
