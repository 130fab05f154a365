"""Strategies as data (counterpart: flexflow_tpu/parallel/sharding.py).

A `DimSharding` assigns a tensor dim zero or more mesh axes (None, "axis"
or a tuple of axes); an `OpSharding` gives the DimShardings of one op's
outputs and weights, plus free-form attributes; a `Strategy` maps layers
to OpShardings and carries the mesh axes, the graph inputs' shardings,
the pipeline block and the per-layer remat map. The JSON format is the
JAX package's (`--import` / `--export`), so a strategy file written by
either package loads in the other.

Over a mesh (a `DeviceMesh`, parallel/machine.py `build_mesh`) a dim
list becomes DTensor placements (`placements`): a mesh axis that shards
tensor dim d is `Shard(d)`, every other axis `Replicate()`; a dim that
two axes shard ("a", "b") is split by a first, then by b, which DTensor
expresses only when a comes before b in the mesh. `dims_of` reads the
dims back. `constrainable` is the one divisibility rule of the lowering,
the weights' layouts and the search (JAX `lowering.py:30-42`): a layout
applies only when every sharded dim divides by its axes' degree. The
`remat` map ({layer name: "full" | "dots"}) reaches the lowering
(compiler/lowering.py).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple, Union

# One dim's assignment: None (replicated), "axis", or a tuple of axes.
DimSharding = Union[None, str, Tuple[str, ...]]


def _norm_dim(d) -> DimSharding:
    if d is None or d == []:
        return None
    if isinstance(d, str):
        return d
    t = tuple(d)
    return t[0] if len(t) == 1 else t


def used_axes(dims: Sequence[DimSharding]) -> List[str]:
    """The mesh axes a dim list shards over, in dim order."""
    out: List[str] = []
    for d in dims:
        if d is None:
            continue
        out.extend([d] if isinstance(d, str) else list(d))
    return out


def _axes(d: DimSharding) -> Tuple[str, ...]:
    if d is None:
        return ()
    return (d,) if isinstance(d, str) else tuple(d)


def constrainable(dims: Sequence[DimSharding], shape,
                  mesh_axes: Dict[str, int]) -> bool:
    """Whether `dims` can lay out a tensor of `shape` on a mesh of
    `mesh_axes` ({name: degree}): every axis named exists and every
    sharded dim divides by the product of its axes' degrees."""
    for i, d in enumerate(dims):
        if d is None:
            continue
        degree = 1
        for a in _axes(d):
            if a not in mesh_axes:
                return False
            degree *= mesh_axes[a]
        if i >= len(shape) or shape[i] % degree != 0:
            return False
    return True


def pins_nothing(dims: Sequence[DimSharding]) -> bool:
    return all(d is None for d in dims)


def placements(dims: Sequence[DimSharding], mesh) -> Optional[list]:
    """The DTensor placements of `dims` on `mesh` (one per mesh dim), or
    None when DTensor cannot express them: an axis on two dims, or a dim
    whose axes are not in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, d in enumerate(dims):
        axes = _axes(d)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            return None
        for j in pos:
            if not isinstance(out[j], Replicate):
                return None
            out[j] = Shard(i)
    return out


def mesh_placements(dims: Sequence[DimSharding], shape, mesh) -> list:
    """The placements of a tensor of `shape` laid out by `dims` on `mesh`:
    replicated where `constrainable` refuses the layout or DTensor cannot
    say it (JAX's `_weight_sharding` and `input_sharding` rule)."""
    from torch.distributed.tensor import Replicate

    axes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    pl = placements(dims, mesh) if constrainable(dims, shape, axes) else None
    return pl if pl is not None else [Replicate()] * mesh.ndim


def dims_of(pl: Sequence, mesh, ndim: int) -> List[DimSharding]:
    """The dim list of DTensor placements `pl` (Partial reads as
    replicated: the sum it stands for is not laid out yet)."""
    from torch.distributed.tensor import Shard

    names = list(mesh.mesh_dim_names)
    per: List[List[str]] = [[] for _ in range(ndim)]
    for j, p in enumerate(pl):
        if isinstance(p, Shard):
            per[p.dim % ndim].append(names[j])
    return [_norm_dim(a) for a in per]


def kernel_layout(x, dims_ok: Sequence[int]) -> list:
    """The placements a hand-written kernel runs a DTensor `x` at: `x`'s
    own shards of the dims in `dims_ok` (dims whose blocks the kernel
    computes apart), Replicate on every other mesh dim. A shard of
    another dim is gathered, and a pending sum resolved, first: as GSPMD
    gathers the operands of a `pallas_call` around it."""
    from torch.distributed.tensor import Replicate, Shard

    ok = {d % x.ndim for d in dims_ok}
    return [p if isinstance(p, Shard) and p.dim % x.ndim in ok
            else Replicate() for p in x.placements]


@dataclasses.dataclass
class OpSharding:
    """Per-op placement: output and weight dim shardings, plus free-form
    placement attributes."""

    outputs: List[List[DimSharding]] = dataclasses.field(default_factory=list)
    weights: Dict[str, List[DimSharding]] = dataclasses.field(default_factory=dict)
    attrs: Dict[str, str] = dataclasses.field(default_factory=dict)

    def output_dims(self, idx: int = 0) -> List[DimSharding]:
        return list(self.outputs[idx]) if idx < len(self.outputs) else []

    def weight_dims(self, name: str) -> List[DimSharding]:
        return list(self.weights.get(name, []))

    def to_json(self):
        d = {"outputs": self.outputs, "weights": self.weights}
        if self.attrs:
            d["attrs"] = self.attrs
        return d

    @staticmethod
    def from_json(d) -> "OpSharding":
        return OpSharding(
            outputs=[[_norm_dim(x) for x in o] for o in d.get("outputs", [])],
            weights={k: [_norm_dim(x) for x in v]
                     for k, v in d.get("weights", {}).items()},
            attrs=dict(d.get("attrs", {})),
        )

    def __str__(self):
        """The dot export's annotation: each output's dims, then each
        weight's ("." replicated, "a+b" two axes), as JAX prints them."""
        def fmt(dims):
            return "[" + ",".join(
                "." if d is None else (d if isinstance(d, str) else "+".join(d))
                for d in dims) + "]"

        o = " ".join(fmt(x) for x in self.outputs)
        w = " ".join(f"{k}{fmt(v)}" for k, v in self.weights.items())
        return (o + (" | " + w if w else "")).strip()


@dataclasses.dataclass
class Strategy:
    """A full parallelization strategy, with the per-layer remat policy
    (None, or {layer_name: "dots" | "full"}; absent layers keep "none")."""

    op_shardings: Dict[str, OpSharding] = dataclasses.field(default_factory=dict)
    input_shardings: Dict[str, List[DimSharding]] = dataclasses.field(default_factory=dict)
    mesh_axes: Dict[str, int] = dataclasses.field(default_factory=dict)
    name: str = "strategy"
    pipeline: Optional[Dict] = None
    remat: Optional[Dict[str, str]] = None

    def input_dims(self, tensor_name: str) -> List[DimSharding]:
        return list(self.input_shardings.get(tensor_name, []))

    def sharding_for(self, layer_name: str) -> OpSharding:
        return self.op_shardings.get(layer_name, OpSharding())

    def to_json(self) -> dict:
        d = {
            "name": self.name,
            "mesh_axes": self.mesh_axes,
            "inputs": self.input_shardings,
            "ops": {k: v.to_json() for k, v in self.op_shardings.items()},
        }
        if self.pipeline:
            d["pipeline"] = self.pipeline
        if self.remat:
            d["remat"] = self.remat
        return d

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @staticmethod
    def from_json(d: dict) -> "Strategy":
        return Strategy(
            op_shardings={k: OpSharding.from_json(v)
                          for k, v in d.get("ops", {}).items()},
            input_shardings={k: [_norm_dim(x) for x in v]
                             for k, v in d.get("inputs", {}).items()},
            mesh_axes=dict(d.get("mesh_axes", {})),
            name=d.get("name", "strategy"),
            pipeline=d.get("pipeline"),
            remat=d.get("remat"),
        )

    @staticmethod
    def load(path: str) -> "Strategy":
        with open(path) as f:
            return Strategy.from_json(json.load(f))
