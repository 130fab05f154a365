"""Kernelspec installer (counterpart: flexflow_tpu/jupyter/install.py):

    python -m flexflow_tpu_torch.jupyter.install [--config cfg.json]
        [--prefix DIR] [--ff-args "-b 64 --budget 8"] [--system]

Reference analog: `jupyter_notebook/install.py`. The spec is a plain
ipykernel launch carrying the launcher flags in its environment (see
flexflow_tpu_torch/jupyter/__init__.py), written through jupyter_client's
KernelSpecManager when it is installed, else straight into the kernels
directory (`--prefix` wins over both), so it installs without jupyter.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import sys
from typing import Optional

from flexflow_tpu_torch.jupyter import kernelspec, load_config


def install(config: Optional[str] = None,
            kernel_name: str = "flexflow_tpu_torch",
            display_name: Optional[str] = None, user: bool = True,
            prefix: Optional[str] = None, ff_args: Optional[str] = None,
            mute: bool = False) -> str:
    """Write the kernelspec; returns its directory."""
    name, argv, env = (load_config(config) if config
                       else ("FlexFlow torch", [], {}))
    if ff_args:
        argv += shlex.split(ff_args)
    spec = kernelspec(display_name or name, argv, env)
    if prefix:
        base = os.path.join(prefix, "share", "jupyter", "kernels")
    else:
        try:
            from jupyter_client.kernelspec import KernelSpecManager

            base = (KernelSpecManager().user_kernel_dir if user else
                    os.path.join(sys.prefix, "share", "jupyter", "kernels"))
        except ImportError:
            base = (os.path.join(os.path.expanduser("~"), ".local", "share",
                                 "jupyter", "kernels") if user else
                    os.path.join(sys.prefix, "share", "jupyter", "kernels"))
    kdir = os.path.join(base, kernel_name)
    os.makedirs(kdir, exist_ok=True)
    with open(os.path.join(kdir, "kernel.json"), "w") as f:
        json.dump(spec, f, indent=2, sort_keys=True)
    if not mute:
        print(f"installed kernelspec {kernel_name!r} -> {kdir}")
        print(f"  display_name: {spec['display_name']}")
        print(f"  FF_LAUNCH_ARGS: {spec['env'].get('FF_LAUNCH_ARGS', '')!r}")
    return kdir


def main(argv=None):
    p = argparse.ArgumentParser("flexflow_tpu_torch.jupyter.install")
    p.add_argument("--config", default=None,
                   help="kernel config JSON (the reference's "
                        "flexflow_jupyter.json vocabulary)")
    p.add_argument("--kernel-name", default="flexflow_tpu_torch")
    p.add_argument("--display-name", default=None)
    p.add_argument("--prefix", default=None)
    p.add_argument("--system", action="store_true",
                   help="install system-wide instead of per user")
    p.add_argument("--ff-args", default=None,
                   help='extra launcher flags, e.g. "-b 64 --budget 8"')
    args = p.parse_args(argv)
    install(config=args.config, kernel_name=args.kernel_name,
            display_name=args.display_name, user=not args.system,
            prefix=args.prefix, ff_args=args.ff_args)


if __name__ == "__main__":
    main()
