"""Strategies as data (counterpart: flexflow_tpu/parallel/sharding.py).

A `DimSharding` assigns a tensor dim zero or more mesh axes (None, "axis"
or a tuple of axes); an `OpSharding` gives the DimShardings of one op's
outputs and weights, plus free-form attributes; a `Strategy` maps layers
to OpShardings and carries the mesh axes, the graph inputs' shardings,
the pipeline block and the per-layer remat map. The JSON format is the
JAX package's (`--import` / `--export`), so a strategy file written by
either package loads in the other.

The port runs on one device: the op and input shardings are carried and
saved, and none is applied, as a one-device mesh applies none in JAX.
The `remat` map ({layer name: "full" | "dots"}) reaches the lowering
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


@dataclasses.dataclass
class OpSharding:
    """Per-op placement: output and weight dim shardings, plus free-form
    placement attributes."""

    outputs: List[List[DimSharding]] = dataclasses.field(default_factory=list)
    weights: Dict[str, List[DimSharding]] = dataclasses.field(default_factory=dict)
    attrs: Dict[str, str] = dataclasses.field(default_factory=dict)

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
