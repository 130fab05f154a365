"""Build the C API library and the C example (counterpart:
tools/build_capi.py):

    python -m flexflow_tpu_torch.capi.build [--run-example] [--platform cpu]

One translation unit (flexflow_c.cc) embeds CPython: it is compiled by
the host C++ compiler against `sysconfig`'s include dir and linked to
libpython (`-lpython3.X`, its LIBDIR on the rpath) into
`build/flexflow_tpu_torch/capi_<hash>/libflexflow_tpu_torch_c.so`, keyed
by a hash of the sources, the flags and the Python, so a changed source
builds anew. `--run-example` compiles examples/c/mlp_train.c (read, not
changed) against it into the same directory and runs it with the repo
and this interpreter's sys.path on PYTHONPATH (the embedded interpreter
then imports what this one does), on the GPU unless `--platform cpu`.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path
from typing import Dict, Optional

from flexflow_tpu_torch.kernels._build import BUILD_DIR

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
SOURCES = (HERE / "flexflow_c.cc", HERE / "flexflow_c.h")
EXAMPLE = ROOT / "examples" / "c" / "mlp_train.c"
LIB_NAME = "flexflow_tpu_torch_c"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def _python_link() -> tuple:
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    return inc, libdir, ver


def build_dir() -> Path:
    h = hashlib.sha256()
    for p in SOURCES:
        h.update(p.read_bytes())
    h.update(" ".join(CXX_FLAGS + list(_python_link())).encode())
    return BUILD_DIR / f"capi_{h.hexdigest()[:16]}"


def _run(cmd, what: str) -> None:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"{what} failed (rc {out.returncode}): "
                           f"{' '.join(cmd)}\n{out.stdout}{out.stderr}")


def _compiler(var: str, default: str) -> str:
    cc = os.environ.get(var) or shutil.which(default)
    if not cc:
        raise RuntimeError(f"no {default} on PATH (or set {var})")
    return cc


def build_lib() -> Path:
    """The library, built first if needed."""
    d = build_dir()
    lib = d / f"lib{LIB_NAME}.so"
    if lib.exists():
        return lib
    d.mkdir(parents=True, exist_ok=True)
    inc, libdir, ver = _python_link()
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    _run([_compiler("CXX", "c++"), *CXX_FLAGS, str(SOURCES[0]), f"-I{inc}",
          f"-L{libdir}", f"-l{ver}", f"-Wl,-rpath,{libdir}", "-o",
          str(tmp)], "building the C API library")
    os.replace(tmp, lib)
    return lib


def build_example() -> Path:
    """examples/c/mlp_train.c compiled and linked against the library."""
    lib = build_lib()
    exe = lib.parent / "mlp_train"
    tmp = exe.with_suffix(f".{os.getpid()}.tmp")
    _run([_compiler("CC", "cc"), "-O2", str(EXAMPLE), f"-I{HERE}",
          f"-L{lib.parent}", f"-l{LIB_NAME}", f"-Wl,-rpath,{lib.parent}",
          "-o", str(tmp)], "building the C example")
    os.replace(tmp, exe)
    return exe


def example_env(platform: Optional[str] = None,
                extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = dict(os.environ)
    paths = [str(ROOT)] + [p for p in sys.path if p and os.path.isdir(p)]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    if platform:
        env["FLEXFLOW_PLATFORM"] = platform
    env.update(extra or {})
    return env


def run_example(platform: Optional[str] = None, batch: int = 32,
                extra_env: Optional[Dict[str, str]] = None,
                timeout: float = 600) -> str:
    """Build and run the example (`-b batch`); returns its stdout, or
    raises with its output when it exits nonzero."""
    exe = build_example()
    out = subprocess.run([str(exe), "-b", str(batch)],
                         env=example_env(platform, extra_env),
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"the C example failed (rc {out.returncode}):\n"
                           f"{out.stdout}\n{out.stderr[-3000:]}")
    return out.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("flexflow_tpu_torch.capi.build")
    ap.add_argument("--run-example", action="store_true")
    ap.add_argument("--platform", default=None,
                    help="FLEXFLOW_PLATFORM for the example (default: the "
                         "GPU)")
    args = ap.parse_args(argv)
    print("built", build_lib())
    if args.run_example:
        print(run_example(args.platform), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
