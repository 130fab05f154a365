"""ParallelTensor — the parallel view of a tensor
(counterpart: flexflow_tpu/parallel/ptensor.py).

Derived, not stored: (TensorSpec, DimSharding list, machine) determine
each dim's degree, the shard shape and the per-device bytes. The measured
cost path (search/measure.py) runs an op at these shard-local shapes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.parallel.sharding import DimSharding


@dataclasses.dataclass(frozen=True)
class ParallelDim:
    size: int
    degree: int = 1
    axes: Tuple[str, ...] = ()

    @property
    def shard_size(self) -> int:
        return self.size // self.degree


@dataclasses.dataclass(frozen=True)
class ParallelTensor:
    spec: TensorSpec
    dims: Tuple[ParallelDim, ...]
    replica_axes: Tuple[str, ...] = ()  # mesh axes the tensor is replicated over

    @staticmethod
    def build(spec: TensorSpec, dim_shardings: List[DimSharding],
              machine: MachineSpec) -> "ParallelTensor":
        pdims = []
        used = set()
        for i, size in enumerate(spec.shape):
            ds = dim_shardings[i] if i < len(dim_shardings) else None
            axes = () if ds is None else ((ds,) if isinstance(ds, str)
                                          else tuple(ds))
            degree = 1
            for a in axes:
                degree *= machine.mesh_axes.get(a, 1)
                used.add(a)
            if size % max(degree, 1) != 0:
                axes, degree = (), 1  # illegal sharding degenerates to replicated
            pdims.append(ParallelDim(size, max(degree, 1), axes))
        replicas = tuple(a for a in machine.mesh_axes if a not in used)
        return ParallelTensor(spec, tuple(pdims), replicas)

    @property
    def total_degree(self) -> int:
        d = 1
        for pd in self.dims:
            d *= pd.degree
        return d

    @property
    def shard_shape(self) -> Tuple[int, ...]:
        return tuple(pd.shard_size for pd in self.dims)

    @property
    def shard_bytes(self) -> int:
        n = 1
        for s in self.shard_shape:
            n *= s
        return n * self.spec.dtype.itemsize

    def __repr__(self):
        parts = [f"{pd.size}/{pd.degree}"
                 + (f"@{'+'.join(pd.axes)}" if pd.axes else "")
                 for pd in self.dims]
        return f"PT[{' ,'.join(parts)}]"
