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
`--workers-per-node`) are written as given; the port's `parse_args`
refuses them until multi-device execution is ported.

`notebook_path()` is the port's quickstart notebook, a one-device copy of
the JAX package's examples/notebooks/quickstart.ipynb.
"""

from __future__ import annotations

import json
import os
import shlex
import sys
import warnings
from typing import Dict, List, Optional, Tuple

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


def notebook_cells(path: Optional[str] = None) -> List[str]:
    """The source of each code cell of a notebook, in order."""
    with open(path or notebook_path()) as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]
