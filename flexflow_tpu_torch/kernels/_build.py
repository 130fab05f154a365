"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` into a shared library with a plain C
interface and loaded with `ctypes`. The build happens at first use, into
`build/flexflow_tpu_torch/` under the checkout, keyed by a hash of the
source, the shared headers (csrc/*.cuh) and the flags, so a fresh
checkout builds itself and a changed source or header rebuilds.
`nvcc -Xptxas -v` output (registers, shared memory, spills) is kept
beside each library as `<lib>.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "flexflow_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v"] + ARCH_FLAGS

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                           "the CUDA kernels are built from csrc/ at first use")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start one nvcc for `name` unless its library is already built;
    returns (process or None, output path)."""
    out = library_path(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    proc._ff_tmp, proc._ff_log = tmp, log  # type: ignore[attr-defined]
    return proc, out


def _finish_build(name: str, proc, out: Path) -> None:
    if proc is None:
        return
    rc = proc.wait()
    proc._ff_log.close()
    if rc != 0:
        msg = out.with_suffix(".log").read_text()[-4000:]
        raise RuntimeError(f"nvcc failed building {name} (rc {rc}):\n{msg}")
    os.replace(proc._ff_tmp, out)


def build_all(names: Iterable[str]) -> List[Path]:
    """Build every named kernel library at once: one nvcc per source, all
    started together. Returns the library paths."""
    names = list(names)
    started = [(n, *_start_build(n)) for n in names]
    for n, proc, out in started:
        _finish_build(n, proc, out)
    return [out for _n, _p, out in started]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (path,) = build_all([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def build_log(name: str) -> str:
    p = library_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""
