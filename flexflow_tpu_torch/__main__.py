"""The launcher (counterpart: flexflow_tpu/__main__.py):

    python -m flexflow_tpu_torch [flags] script.py [script args]

The flags before the script path are the FFConfig command line, after
those of `FF_LAUNCH_ARGS` (the command line wins); the script reads the
parsed config from `flexflow_tpu_torch.get_launch_config()` and gets the
tokens after its path as its own argv. `FLEXFLOW_PLATFORM` (cpu, gpu or
cuda) is an explicit request for a device: `device=None` means it in the
script's compiles. Without it the script runs on the GPU.

A command line that names a mesh (`--mesh`, `--nodes` > 1) or a process
started by torchrun (`WORLD_SIZE` in its environment) starts the process
group first (runtime/distributed.py `init_distributed`, from torchrun's
environment): one process a GPU, world = nodes x workers-per-node, e.g.

    torchrun --nproc-per-node 4 -m flexflow_tpu_torch --mesh data=4 train.py

A single process with `--mesh data=1` and no torchrun runs the same
distributed path at world 1, its rendezvous on a free localhost port.
"""

from __future__ import annotations

import os
import runpy
import shlex
import sys

from flexflow_tpu_torch.config import FFConfig


def split_argv(argv, value_flags=None):
    """(script, launcher args, script args): the script is the first token
    that is neither a flag nor the value of a flag that takes one (so
    `--machine-model-file m.json train.py` picks train.py). `value_flags`
    defaults to `FFConfig.launcher_value_flags()`. The script is None when
    no such token is there."""
    if value_flags is None:
        value_flags = FFConfig.launcher_value_flags()
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-"):
            return a, argv[:i], argv[i + 1:]
        if "=" not in a and a in value_flags:
            i += 1  # the flag's value
        i += 1
    return None, argv, []


def start_group(cfg) -> None:
    """The process group of a launch: torchrun's environment, else one
    process on a free localhost port. `--nodes` x `--workers-per-node`,
    when given, must be the world."""
    import socket

    from flexflow_tpu_torch.runtime.distributed import (init_distributed,
                                                        world_size)

    if "WORLD_SIZE" in os.environ:
        init_distributed()
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        init_distributed(f"localhost:{port}", 1, 0)
    if cfg.num_nodes > 1 and cfg.workers_per_node and \
            cfg.num_nodes * cfg.workers_per_node != world_size():
        raise ValueError(
            f"--nodes {cfg.num_nodes} x --workers-per-node "
            f"{cfg.workers_per_node} != the world's {world_size()} ranks")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    script, launcher_args, script_args = split_argv(argv)
    if script is None:
        print("usage: python -m flexflow_tpu_torch [flags] script.py "
              "[script args]\nflags: the FFConfig command line (-b, --lr, "
              "-e, ...)", file=sys.stderr)
        return 2
    import flexflow_tpu_torch
    from flexflow_tpu_torch import device

    env_args = shlex.split(os.environ.get("FF_LAUNCH_ARGS", ""))
    cfg = flexflow_tpu_torch._launch_config = FFConfig.parse_args(
        env_args + launcher_args)
    if os.environ.get("FLEXFLOW_PLATFORM"):
        device.set_default_device(os.environ["FLEXFLOW_PLATFORM"])
    if cfg.mesh_shape or cfg.num_nodes > 1 or "WORLD_SIZE" in os.environ:
        start_group(cfg)
    sys.argv = [script] + script_args
    runpy.run_path(script, run_name="__main__")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
