"""The launcher (counterpart: flexflow_tpu/__main__.py):

    python -m flexflow_tpu_torch [flags] script.py [script args]

The flags before the script path are the FFConfig command line, after
those of `FF_LAUNCH_ARGS` (the command line wins); the script reads the
parsed config from `flexflow_tpu_torch.get_launch_config()` and gets the
tokens after its path as its own argv. `FLEXFLOW_PLATFORM` (cpu, gpu or
cuda) is an explicit request for a device: `device=None` means it in the
script's compiles. Without it the script runs on the GPU.
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
    flexflow_tpu_torch._launch_config = FFConfig.parse_args(
        env_args + launcher_args)
    if os.environ.get("FLEXFLOW_PLATFORM"):
        device.set_default_device(os.environ["FLEXFLOW_PLATFORM"])
    sys.argv = [script] + script_args
    runpy.run_path(script, run_name="__main__")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
