"""Jupyter kernel integration (counterpart: flexflow_tpu/jupyter/).

Reference analog: `jupyter_notebook/` (install.py, flexflow_jupyter.json,
flexflow_kernel_nocr.py), whose custom kernel configures the Legion
runtime with machine flags before user code runs. The port needs no
process takeover, so the kernel is a plain ipykernel spec whose launch
environment carries the configuration: the launch flags in
`FF_LAUNCH_ARGS`, which `FFConfig.parse_args()` reads on a real command
line (argv None, never an explicit argv) as the launcher does, and the
platform in `FLEXFLOW_PLATFORM` ("gpu" or "cpu"), which the same
`parse_args()` and the launcher make the default device.

`python -m flexflow_tpu_torch.jupyter.install --config cfg.json` installs
the kernelspec; `load_config` maps the reference's flexflow_jupyter.json
vocabulary onto those flags, as the JAX package's does, with one
departure: the JAX package turns a `virtual_devices` field into an XLA
host device count (and pins the CPU platform for it); that has no meaning
for torch, so the port drops the field with the Legion knobs, and the
spec carries neither `XLA_FLAGS` nor the CPU pin that came with it.
Flags for more than one device (`--nodes`, `--mesh`,
`--workers-per-node`) are written as given, and `parse_args` takes them.

A notebook is one process; the port runs a mesh as one process a device
(runtime/distributed.py). `run_over_mesh(fn, cfg)` runs a cell's function
`fn(cfg)` on every rank of `cfg.mesh_shape`, in processes it starts
(`torch.multiprocessing`) and stops, and returns rank 0's value to the
notebook: gloo on the CPU; on cards one rank a card over NCCL, or, with
fewer cards than ranks, gloo with the ranks sharing the cards (NCCL
refuses two ranks on one card). The function travels by reference when
its module imports, else by its source (a function a notebook cell
defines: IPython keeps each cell's source, so `inspect.getsource` reads
it); it runs in a namespace of its own, so it imports what it uses.

`notebook_path()` is the port's quickstart notebook: the JAX package's
examples/notebooks/quickstart.ipynb, in two parts, one device (cells
tagged `one-device`) and JAX's mesh cells run over ranks by
`run_over_mesh` (tagged `mesh`).
"""

from __future__ import annotations

import importlib
import inspect
import json
import math
import os
import queue
import shlex
import socket
import sys
import textwrap
import traceback
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

# reference flexflow_jupyter.json fields -> launcher flags
_FIELD_TO_FLAG = {
    "nodes": "--nodes",
    "batch_size": "-b",
    "epochs": "-e",
    "budget": "--budget",
    "mesh": "--mesh",
}
# Legion machine knobs with no meaning for the port, and virtual_devices
# (an XLA host device count in the JAX package)
_DROPPED_FIELDS = ("cpus", "openmp", "ompthreads", "utility", "sysmem",
                   "fbmem", "zcmem", "regmem", "not_control_replicable",
                   "launcher", "other_options", "virtual_devices")


def _value(cfg: dict, field: str):
    v = cfg.get(field)
    if isinstance(v, dict):  # reference style: {"cmd": ..., "value": ...}
        v = v.get("value")
    return v


def load_config(path: str) -> Tuple[str, List[str], Dict[str, str]]:
    """Parse a kernel config (the reference's flexflow_jupyter.json
    vocabulary, or plain values) -> (display_name, launcher argv, extra
    environment)."""
    with open(path) as f:
        cfg = json.load(f)
    name = cfg.get("name", "FlexFlow torch")
    argv: List[str] = []
    for field, flag in _FIELD_TO_FLAG.items():
        v = _value(cfg, field)
        if v is not None:
            argv += [flag, str(v)]
    # workers a node: ranks_per_node x gpus a rank
    ranks, gpus = _value(cfg, "ranks_per_node"), _value(cfg, "gpus")
    if ranks is not None or gpus is not None:
        argv += ["--workers-per-node",
                 str(int(ranks or 1) * int(gpus or 1))]
    dropped = [f for f in _DROPPED_FIELDS if _value(cfg, f) is not None]
    if dropped:
        warnings.warn(f"kernel config fields with no meaning for the port "
                      f"dropped: {dropped} (Legion machine knobs, and the "
                      f"JAX package's XLA device count)")
    env = dict(cfg.get("env", {}))
    platform = _value(cfg, "platform")
    if platform:
        env["FLEXFLOW_PLATFORM"] = str(platform)
    return name, argv, env


def kernelspec(display_name: str, ff_argv: List[str],
               extra_env: Optional[Dict[str, str]] = None) -> dict:
    """The kernel.json body: a plain ipykernel launch whose environment
    carries the launcher flags (shlex-joined, as parse_args splits them)."""
    return {
        "argv": [sys.executable, "-m", "ipykernel_launcher",
                 "-f", "{connection_file}"],
        "display_name": display_name,
        "language": "python",
        "env": {"FF_LAUNCH_ARGS": shlex.join(ff_argv), **(extra_env or {})},
    }


def notebook_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "quickstart.ipynb")


def notebook_cells(path: Optional[str] = None,
                   tag: Optional[str] = None) -> List[str]:
    """The source of each code cell of a notebook, in order (with `tag`,
    those whose metadata carries it: "one-device" or "mesh" in the
    quickstart)."""
    with open(path or notebook_path()) as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code" and (
                tag is None or tag in c.get("metadata", {}).get("tags", ()))]


# ------------------------------------------------------------ over a mesh
def _function_ref(fn: Callable) -> Tuple[str, str, str]:
    """("ref", module, qualname) when `fn` imports from its module, else
    ("source", its dedented source, its name)."""
    mod = getattr(fn, "__module__", None)
    if mod and mod != "__main__" and "<" not in fn.__qualname__:
        try:
            if getattr(importlib.import_module(mod), fn.__qualname__,
                       None) is fn:
                return "ref", mod, fn.__qualname__
        except ImportError:
            pass
    return "source", textwrap.dedent(inspect.getsource(fn)), fn.__name__


def _function(ref: Tuple[str, str, str]) -> Callable:
    kind, a, b = ref
    if kind == "ref":
        return getattr(importlib.import_module(a), b)
    ns: Dict[str, Any] = {"__name__": "__ff_cell__"}
    exec(compile(a, f"<cell function {b}>", "exec"), ns)
    return ns[b]


def _rank_main(rank: int, world: int, port: int, platform: str,
               backend: str, ref, cfg, args, out) -> None:
    """A rank: its device and group, then the function; rank 0 puts its
    value on `out`, any rank its traceback (and a crash's Python stack on
    its stderr)."""
    import faulthandler

    faulthandler.enable()
    try:
        import torch

        from flexflow_tpu_torch import device
        from flexflow_tpu_torch.runtime.distributed import init_distributed

        device.set_default_device(platform)
        cards = []
        if platform != "cpu":
            cards = [rank % torch.cuda.device_count()]
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        init_distributed(f"localhost:{port}", world, rank,
                         local_device_ids=cards or None, backend=backend)
        val = _function(ref)(cfg, *args)
        if rank == 0:
            out.put(("ok", rank, val))
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        out.put(("error", rank, traceback.format_exc()))
        raise


def run_over_mesh(fn: Callable, cfg, *args):
    """`fn(cfg, *args)` on every rank of `cfg.mesh_shape` (the module
    docstring): rank 0's value. Raises RuntimeError with a rank's
    traceback when one fails, or when a rank dies or all end with no
    result; every rank process is ended before it returns."""
    import torch
    import torch.multiprocessing as mp

    from flexflow_tpu_torch import device

    world = math.prod((cfg.mesh_shape or {}).values()) or 1
    # the entry points' device: the GPU unless the caller asked for the
    # CPU (raises here when there is no card)
    platform = "cpu" if device.resolve_device(None).type == "cpu" else "gpu"
    backend = ("nccl" if platform == "gpu"
               and torch.cuda.device_count() >= world else "gloo")
    ref = _function_ref(fn)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, platform, backend, ref, cfg,
                               args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        while True:
            try:
                kind, rank, val = out.get(timeout=1.0)
            except queue.Empty:
                # a rank that died (a crash) leaves the others waiting in
                # a collective: fail at once
                if out.empty() and any(p.exitcode not in (None, 0)
                                       for p in procs) or all(
                        not p.is_alive() for p in procs) and out.empty():
                    raise RuntimeError(
                        "run_over_mesh: the ranks ended with exit codes "
                        f"{[p.exitcode for p in procs]} and no result")
                continue
            if kind == "error":
                raise RuntimeError(f"run_over_mesh: rank {rank} of {world} "
                                   f"failed:\n{val}")
            break
        for p in procs:
            p.join(60)
        return val
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
