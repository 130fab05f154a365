"""The native host core (counterpart: flexflow_tpu/native/): native.cc's
batch gather and topological order, loaded with ctypes (which releases the
GIL for the call).

native.cc is compiled by the host C++ compiler (`$CXX`, else `c++`) at
first use into `build/flexflow_tpu_torch/` under the checkout, keyed by a
hash of the source and the flags, as the CUDA kernels are
(kernels/_build.py); nothing is built at import. A failed build raises
with the compiler's output: nothing falls back quietly. The Python paths
(numpy's fancy index, core/graph.py's topological order) are the
reference the tests hold these to.

Unlike the JAX package, neither the loader nor `core.graph.topo_order`
calls in here: on the H100 machine's host the native gather ran slower
than numpy's index, and the native order saves under a millisecond a
compile (chip_smoke.py 16d times both; PERF.md). `gathers` and
`topo_orders` count the native calls.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from flexflow_tpu_torch.kernels._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "native.cc"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

gathers = 0
topo_orders = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (set CXX or put c++ on "
                           "PATH): the native core is built from native.cc "
                           "at first use")
    return cxx


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libff_native_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (one build a process;
    concurrent processes each write a pid-unique file and rename it)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            out = subprocess.run([compiler(), *CXX_FLAGS, "-o", str(tmp),
                                  str(SOURCE)], capture_output=True,
                                 text=True, timeout=300)
            if out.returncode != 0:
                raise RuntimeError(
                    f"building the native core failed (rc "
                    f"{out.returncode}):\n{out.stdout}{out.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.ff_batch_gather.restype = ctypes.c_int
        lib.ff_batch_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, i64p,
            ctypes.c_int64, ctypes.c_int64]
        lib.ff_topo_order.restype = ctypes.c_int
        lib.ff_topo_order.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p,
                                      i64p, i64p]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here (a host C++ compiler is
    needed). Asking is not a fallback: `batch_gather` and `topo_order`
    still raise when it does not."""
    try:
        load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def gather_applies(arr: np.ndarray) -> bool:
    """Whether `batch_gather` takes `arr`: a C-contiguous array of one or
    more dims and a plain dtype (copying a strided dataset each batch
    would cost more than numpy's index)."""
    return (arr.ndim >= 1 and arr.dtype != object
            and arr.flags.c_contiguous)


def batch_gather(arr: np.ndarray, idx) -> np.ndarray:
    """arr[idx] over the leading dim (the loader's batch assembly) for an
    array `gather_applies` takes and a 1-D index; bitwise numpy's fancy
    index. Raises IndexError on an index out of range."""
    global gathers
    if not gather_applies(arr):
        raise ValueError("batch_gather takes a C-contiguous array of a "
                         f"plain dtype (got {arr.dtype}, "
                         f"contiguous={arr.flags.c_contiguous})")
    idx64 = np.ascontiguousarray(np.asarray(idx, dtype=np.int64))
    if idx64.ndim != 1:
        raise ValueError(f"batch_gather takes a 1-D index (got {idx64.ndim}-D)")
    lib = load()
    out = np.empty((idx64.shape[0],) + arr.shape[1:], dtype=arr.dtype)
    row_bytes = int(arr.dtype.itemsize * np.prod(arr.shape[1:], dtype=np.int64))
    if idx64.size and ((idx64 < 0).any() or (idx64 >= arr.shape[0]).any()):
        raise IndexError("batch_gather index out of range")
    if row_bytes and idx64.size:
        rc = lib.ff_batch_gather(
            arr.ctypes.data, arr.shape[0], out.ctypes.data,
            idx64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            idx64.shape[0], row_bytes)
        if rc != 0:
            raise IndexError("batch_gather index out of range")
    gathers += 1
    return out


def topo_order_indices(n_nodes: int,
                       edges: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Kahn's order over (src, dst) index pairs, as core/graph.py's
    topo_order walks it: node indices. Raises ValueError on a cycle."""
    global topo_orders
    lib = load()
    e = np.asarray(list(edges), dtype=np.int64).reshape(-1, 2)
    src = np.ascontiguousarray(e[:, 0])
    dst = np.ascontiguousarray(e[:, 1])
    out = np.empty((n_nodes,), np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.ff_topo_order(n_nodes, src.shape[0], src.ctypes.data_as(i64p),
                           dst.ctypes.data_as(i64p), out.ctypes.data_as(i64p))
    if rc != 0:
        raise ValueError("cycle detected in layer graph")
    topo_orders += 1
    return out


def topo_order(layers: Sequence) -> list:
    """core/graph.py's topo_order of `layers`, walked by ff_topo_order
    over the layers' input-owner edges."""
    layers = list(layers)
    index = {l: i for i, l in enumerate(layers)}
    edges = [(index[t.owner], li)
             for li, l in enumerate(layers) for t in l.inputs
             if t.owner is not None and t.owner in index]
    return [layers[i] for i in topo_order_indices(len(layers), edges)]
