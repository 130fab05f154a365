"""Data types (counterpart: flexflow_tpu/dtype.py).

The enum values are the same strings as in the JAX package, so a graph's
tensor specs compare equal across the two packages; `torch_dtype` is what
the lowerings allocate with.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class DataType(enum.Enum):
    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    HALF = "float16"
    BF16 = "bfloat16"
    FLOAT = "float32"
    DOUBLE = "float64"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH[self]

    @property
    def np_dtype(self):
        """The numpy type of a host array of this dtype. numpy has no
        bfloat16: BF16's host arrays are float32, as the port's host copies
        of bf16 tensors are (convert.py)."""
        return _NP[self]

    @property
    def itemsize(self) -> int:
        return _TORCH[self].itemsize

    @staticmethod
    def from_any(x) -> "DataType":
        if isinstance(x, DataType):
            return x
        if isinstance(x, torch.dtype):
            for dt, tdt in _TORCH.items():
                if tdt == x:
                    return dt
            raise ValueError(f"unknown dtype {x!r}")
        s = str(x)
        for dt in DataType:
            if dt.value == s:
                return dt
        raise ValueError(f"unknown dtype {x!r}")


_TORCH = {
    DataType.BOOL: torch.bool,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.HALF: torch.float16,
    DataType.BF16: torch.bfloat16,
    DataType.FLOAT: torch.float32,
    DataType.DOUBLE: torch.float64,
}


_NP = {
    DataType.BOOL: np.bool_,
    DataType.INT32: np.int32,
    DataType.INT64: np.int64,
    DataType.HALF: np.float16,
    DataType.BF16: np.float32,
    DataType.FLOAT: np.float32,
    DataType.DOUBLE: np.float64,
}


def torch_dtype(name) -> torch.dtype:
    """"bfloat16"/"float32"/... (or a DataType / torch.dtype) -> torch dtype."""
    if name in ("f32",):
        return torch.float32
    if name in ("bf16",):
        return torch.bfloat16
    return DataType.from_any(name).torch_dtype
