"""Machine description: logical mesh + hardware coefficients
(counterpart: flexflow_tpu/parallel/machine.py).

The search (search/) prices strategies against a `MachineSpec`: per-device
compute and memory rates plus a bandwidth per mesh axis. The JSON keys are
the JAX package's, so one machine file reads in both packages. Several
field names come from the TPU; on a GPU they mean:

- `flops` — the dense bf16 tensor-core peak of one GPU;
- `hbm_bw`, `hbm_bytes` — its HBM rate and size;
- `ici_bw` — the per-axis link rate inside a node: NVLink through the
  NVSwitch, in ONE direction (the cost model sends (k-1) shards one way
  around a ring at this rate);
- `dcn_axes`, `dcn_bw` — axes that cross nodes, and the per-GPU network
  rate they ride;
- `mxu_flop_overhead` — peak over the rate a real GEMM sustains (the
  cost model divides the peak by it);
- `mxu_min_dim` — the narrowest per-shard GEMM width that still keeps the
  tensor cores near their widest-width rate: a shard narrower than this is
  charged in proportion;
- `axis_type` — "switch" (full-bisection fabric: NVSwitch, the network),
  "ring" or "line" (a line halves a ring collective's rate);
- `overlap_frac` — the share of a layer's compute that its collectives can
  hide behind;
- `host_bw` — the host-to-device copy rate (no cost term reads it yet).

`CHIP_PRESETS` holds the numbers for the machines the search may be asked
about without their being present: "h100" (an H100 SXM 80 GB node) and
"cpu-sim" (the JAX package's CPU stand-in, kept as it is there so the two
packages' searches compare on the CPU). `detect()` reads the device the
program runs on, one device per rank of the process group; a CUDA card it
has no preset for raises rather than borrowing another chip's numbers.
`build_mesh` lays the machine's axes over the ranks as a named
`DeviceMesh` (JAX `machine.py:170-179`).

A pipelined compile (parallel/pipeline.py) splits the world into stages:
`stage_device_groups` gives each stage its contiguous range of ranks,
stage-major (JAX `pipeline.py:74-84`, where the groups are devices of one
process), and `build_pipeline_mesh` lays a 2-D `DeviceMesh` ("pipe", the
stage machine's axes) over them: this rank's stage is its "pipe"
coordinate, and its stage sub-mesh the slice over the stage axes.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Tuple

import torch

from flexflow_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ChipPreset:
    flops: float          # dense bf16 peak, FLOP/s
    hbm_bw: float         # bytes/s
    hbm_bytes: float
    link_bw: float        # per intra-node axis, bytes/s one way
    dcn_bw: float         # per device across nodes, bytes/s
    host_bw: float        # host -> device copies, bytes/s
    mxu_flop_overhead: float
    mxu_min_dim: int
    topology: Optional[str] = None  # axis_type of intra-node axes


CHIP_PRESETS: Dict[str, ChipPreset] = {
    # H100 SXM5 80 GB in an 8-GPU NVSwitch node (DGX H100):
    #   flops 989e12 — dense bf16 tensor-core peak (datasheet);
    #   hbm_bw 3.35e12, hbm_bytes 80e9 — datasheet (detect() reads the
    #     card's own total_memory and times its host copies);
    #   link_bw 450e9 — NVLink 4: 900 GB/s per GPU in both directions
    #     together (datasheet), one direction taken; not measured (one card);
    #   dcn_bw 50e9 — one 400 Gb/s NDR port per GPU (DGX H100); not measured;
    #   host_bw 64e9 — PCIe Gen5 x16 (datasheet); nothing in the search
    #     reads it yet (chip_smoke.py phase 7a times a pinned copy beside it);
    #   mxu_flop_overhead 1.63 and mxu_min_dim 2048 — measured on an
    #     NVIDIA H100 80GB HBM3 at 700.00 W by chip_smoke.py phase 7b, in
    #     the run PERF.md names C1: 989 over the median 606.8 TFLOP/s of
    #     GPT-2 medium's four projection GEMMs at batch 8 x seq 1024
    #     (bf16), and the narrowest per-shard width 4096/dm of mlp_up that
    #     keeps 90% of the widest's TFLOP/s (2048: 95.1%; 1024: 83.0%).
    "h100": ChipPreset(989e12, 3.35e12, 80e9, 450e9, 50e9, 64e9,
                       1.63, 2048, "switch"),
    # the JAX package's CPU stand-in, unchanged (its dcn_bw, host_bw,
    # mxu_flop_overhead and mxu_min_dim are the JAX MachineSpec defaults)
    "cpu-sim": ChipPreset(1e11, 50e9, 8e9, 1e9, 25e9, 16e9, 1.4, 128),
}


def _preset(chip: str) -> ChipPreset:
    if chip not in CHIP_PRESETS:
        raise ValueError(
            f"no preset for chip {chip!r} (presets: {sorted(CHIP_PRESETS)}): "
            "give flops, hbm_bw, hbm_bytes, dcn_bw, mxu_flop_overhead, "
            "mxu_min_dim, host_bw and every axis's ici_bw explicitly")
    return CHIP_PRESETS[chip]


@dataclasses.dataclass
class MachineSpec:
    """The machine the search optimizes for (it may be larger than the real
    one: --search-num-nodes / --search-num-workers). A numeric field left
    at 0 takes the chip preset's value."""

    mesh_axes: Dict[str, int] = dataclasses.field(default_factory=dict)  # ordered
    chip: str = "h100"
    flops: float = 0.0
    hbm_bw: float = 0.0
    hbm_bytes: float = 0.0
    ici_bw: Dict[str, float] = dataclasses.field(default_factory=dict)  # per axis
    dcn_axes: Tuple[str, ...] = ()
    dcn_bw: float = 0.0
    mxu_flop_overhead: float = 0.0
    mxu_min_dim: int = 0
    axis_type: Dict[str, str] = dataclasses.field(default_factory=dict)
    # not measured on a GPU yet (it needs two): the JAX package's value
    overlap_frac: float = 0.7
    host_bw: float = 0.0

    def __post_init__(self):
        need = (not self.flops or not self.hbm_bw or not self.hbm_bytes
                or not self.host_bw or not self.dcn_bw
                or not self.mxu_flop_overhead or not self.mxu_min_dim
                or any(ax not in self.ici_bw for ax in self.mesh_axes))
        if not need:
            return
        p = _preset(self.chip)
        self.flops = self.flops or p.flops
        self.hbm_bw = self.hbm_bw or p.hbm_bw
        self.hbm_bytes = self.hbm_bytes or p.hbm_bytes
        self.host_bw = self.host_bw or p.host_bw
        self.dcn_bw = self.dcn_bw or p.dcn_bw
        self.mxu_flop_overhead = self.mxu_flop_overhead or p.mxu_flop_overhead
        self.mxu_min_dim = self.mxu_min_dim or p.mxu_min_dim
        for ax in self.mesh_axes:
            if ax not in self.ici_bw:
                self.ici_bw[ax] = (self.dcn_bw if ax in self.dcn_axes
                                   else p.link_bw)
            if p.topology and ax not in self.dcn_axes:
                self.axis_type.setdefault(ax, p.topology)

    @property
    def num_devices(self) -> int:
        return math.prod(self.mesh_axes.values()) if self.mesh_axes else 1

    def axis_bw(self, axis: str) -> float:
        if axis in self.ici_bw:
            return self.ici_bw[axis]
        return _preset(self.chip).link_bw

    def axis_topology(self, axis: str) -> str:
        if axis in self.axis_type:
            return self.axis_type[axis]
        return "switch" if axis in self.dcn_axes else "ring"

    def axis_bw_eff(self, axis: str) -> float:
        """Effective bandwidth for ring-style collectives on this axis: a
        line (no wraparound) loses the wrap link, halving throughput;
        rings and switched fabrics use the full figure."""
        bw = self.axis_bw(axis)
        return bw * 0.5 if self.axis_topology(axis) == "line" else bw

    # -------------------------------------------------------------- io
    def to_json(self) -> dict:
        return {
            "mesh_axes": self.mesh_axes,
            "chip": self.chip,
            "flops": self.flops,
            "hbm_bw": self.hbm_bw,
            "hbm_bytes": self.hbm_bytes,
            "ici_bw": self.ici_bw,
            "dcn_axes": list(self.dcn_axes),
            "dcn_bw": self.dcn_bw,
            "mxu_flop_overhead": self.mxu_flop_overhead,
            "mxu_min_dim": self.mxu_min_dim,
            "axis_type": self.axis_type,
            "overlap_frac": self.overlap_frac,
            "host_bw": self.host_bw,
        }

    @staticmethod
    def from_json(d: dict) -> "MachineSpec":
        return MachineSpec(
            mesh_axes=dict(d["mesh_axes"]),
            chip=d.get("chip", "h100"),
            flops=d.get("flops", 0.0),
            hbm_bw=d.get("hbm_bw", 0.0),
            hbm_bytes=d.get("hbm_bytes", 0.0),
            ici_bw=dict(d.get("ici_bw", {})),
            dcn_axes=tuple(d.get("dcn_axes", ())),
            dcn_bw=d.get("dcn_bw", 0.0),
            mxu_flop_overhead=d.get("mxu_flop_overhead", 0.0),
            mxu_min_dim=d.get("mxu_min_dim", 0),
            axis_type=dict(d.get("axis_type", {})),
            overlap_frac=d.get("overlap_frac", 0.7),
            host_bw=d.get("host_bw", 0.0),
        )

    @staticmethod
    def from_file(path: str) -> "MachineSpec":
        with open(path) as f:
            return MachineSpec.from_json(json.load(f))

    @staticmethod
    def detect(mesh_axes: Optional[Dict[str, int]] = None,
               dcn_axes: Tuple[str, ...] = (), device=None) -> "MachineSpec":
        """The machine of the device the program runs on (`device=None`
        means "cuda", as at the entry points): a CPU is "cpu-sim"; a CUDA
        card whose name holds "H100" is "h100" with the card's own memory
        size; any other card raises (give `machine_model_file` for it).
        The default mesh is one "data" axis over the world: one device
        per rank of the process group, {"data": 1} when none is
        started."""
        dev = resolve_device(device)
        if dev.type == "cpu":
            chip, extra = "cpu-sim", {}
        elif dev.type == "cuda":
            name = torch.cuda.get_device_name(dev)
            if "H100" not in name:
                raise ValueError(
                    f"no machine preset for the card {name!r}: give its "
                    "numbers in a machine file (machine_model_file)")
            idx = dev.index if dev.index is not None \
                else torch.cuda.current_device()
            chip = "h100"
            extra = {"hbm_bytes": float(
                torch.cuda.get_device_properties(idx).total_memory)}
        else:
            raise ValueError(f"no machine preset for device type {dev.type!r}")
        if not mesh_axes:
            from flexflow_tpu_torch.runtime.distributed import world_size

            mesh_axes = {"data": world_size()}
        return MachineSpec(mesh_axes=dict(mesh_axes), chip=chip,
                           dcn_axes=tuple(dcn_axes), **extra)


def build_mesh(spec: MachineSpec, device=None, own_groups: bool = False):
    """The machine's mesh over the ranks of the started process group: a
    `DeviceMesh` of `device`'s type (default: the entry points' device)
    named by the axes. It must cover the world, one device a rank; a mesh
    larger than the world raises JAX's message. `own_groups`: its groups
    are made for it alone (`runtime.distributed.own_groups_mesh`; a
    serving engine's, so two replicas never share one)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from flexflow_tpu_torch.runtime.distributed import world_size

    shape = tuple(spec.mesh_axes.values())
    names = tuple(spec.mesh_axes.keys())
    n = math.prod(shape)
    have = world_size()
    if n > have:
        raise ValueError(f"mesh {spec.mesh_axes} needs {n} devices, have "
                         f"{have}")
    if n < have:
        raise ValueError(f"mesh {spec.mesh_axes} covers {n} devices of the "
                         f"world's {have}: one device a rank, the mesh "
                         "spans them all")
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {spec.mesh_axes}: no process group (call "
            "flexflow_tpu_torch.runtime.distributed.init_distributed, or "
            "run under torchrun)")
    if own_groups:
        from flexflow_tpu_torch.runtime.distributed import own_groups_mesh

        return own_groups_mesh(resolve_device(device).type, shape, names)
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=names)


def stage_device_groups(num_stages: int, per_stage: int) -> List[List[int]]:
    """Contiguous disjoint groups of ranks, stage-major: stage s owns ranks
    [s * per_stage, (s + 1) * per_stage) (JAX `pipeline.py:74-84`: a
    stage's collectives stay on neighbours, the boundary hop between
    neighbours). Raises JAX's message when the world is smaller."""
    from flexflow_tpu_torch.runtime.distributed import world_size

    need, have = num_stages * per_stage, world_size()
    if need > have:
        raise ValueError(f"{num_stages} stages x {per_stage} devices "
                         f"need {need} devices, have {have}")
    if need < have:
        raise ValueError(f"{num_stages} stages x {per_stage} devices cover "
                         f"{need} of the world's {have}: one device a "
                         "rank, the stages span them all")
    return [list(range(s * per_stage, (s + 1) * per_stage))
            for s in range(num_stages)]


def build_pipeline_mesh(stage: MachineSpec, num_stages: int, device=None):
    """(stage index, stage sub-mesh) of this rank for `num_stages` stages
    on the stage machine `stage`: a 2-D `DeviceMesh` ("pipe", stage axes)
    over the world, sliced to this rank's stage. A stage of one device
    runs the one-device program: its sub-mesh is None and no mesh is
    built (a one-device mesh applies no sharding in JAX either)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    per = stage.num_devices
    stage_device_groups(num_stages, per)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if per == 1:
        return rank // per, None
    names = tuple(stage.mesh_axes)
    mesh = init_device_mesh(resolve_device(device).type,
                            (num_stages,) + tuple(stage.mesh_axes.values()),
                            mesh_dim_names=("pipe",) + names)
    return rank // per, mesh[names if len(names) > 1 else names[0]]
