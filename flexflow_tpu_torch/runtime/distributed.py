"""Multi-process runtime (counterpart: flexflow_tpu/runtime/distributed.py).

One process per GPU, as torch runs it: every rank runs the same program
over a `torch.distributed` process group, and the compile's mesh is a
named `DeviceMesh` over the ranks (parallel/machine.py `build_mesh`).
The JAX package puts many devices in one process instead; what it calls
`jax.process_count()` is the world size here, and a rank holds one
device.

- `init_distributed(...)` starts the process group under the
  `distributed/init` fault and retry site, as JAX's
  `jax.distributed.initialize` does. The backend follows the device the
  entry points run on (NCCL for CUDA, gloo for the CPU) unless the caller
  names one; nothing switches either by itself. With no arguments it
  reads torchrun's `RANK`, `WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT`.
  On a CUDA host it makes `LOCAL_RANK` (or `local_device_ids[0]`) the
  rank's device before the group starts.
- `host_local_batch` and `global_batch_from_full` make the DTensor of a
  batch from this rank's rows, or from the full array every rank holds
  (`local_rows` cuts them): the rows of this rank's coordinate on each
  sharded mesh axis.
- `axis_group`, `axis_index` and `axis_size` name one mesh dim's process
  group, this rank's coordinate on it and its size (JAX's
  `lax.axis_index` and the axis of a collective).
- `ring_shift` is JAX's `ppermute` around a ring, the hop every ring
  program calls (kernels/ring_attention.py, kernels/collective_matmul.py):
  the tensors go, packed into one byte buffer, to the next rank on the
  axis and come from the previous one, as one `all_to_all_single` whose
  only nonzero splits are those two. On NCCL that is one send and one
  receive in a group (zero counts are skipped); gloo carries it on CUDA
  tensors too. It is issued with `async_op=True`, so a ring posts its
  next hop before it computes the current chunk and waits on the handle
  only when the chunk is needed: the transfer overlaps the compute, on
  NCCL's stream or gloo's worker. One code path for every backend; at
  axis size 1 it is the identity and issues nothing.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch


def default_backend(device=None) -> str:
    """NCCL for a CUDA device, gloo for the CPU (`device=None` is the
    entry points' default device)."""
    from flexflow_tpu_torch.device import resolve_device

    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     retry_policy=None, backend: Optional[str] = None) -> None:
    """Start this rank's process group: `coordinator_address` ("host:port"),
    `num_processes` and `process_id` name the rendezvous, the world size
    and the rank; each left out is read from torchrun's environment
    (MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK). Call once per process,
    before compiling over a mesh."""
    import torch.distributed as dist

    from flexflow_tpu_torch.runtime.resilience import run_resilient

    if dist.is_initialized():
        raise RuntimeError("init_distributed: the process group is already "
                           "started")
    env = os.environ
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env['MASTER_PORT']}"
                               if "MASTER_PORT" in env else None)
    if coordinator_address is None:
        raise ValueError("init_distributed: no coordinator_address and no "
                         "MASTER_PORT in the environment (run under "
                         "torchrun, or name host:port)")
    world = int(env.get("WORLD_SIZE", 1) if num_processes is None
                else num_processes)
    rank = int(env.get("RANK", 0) if process_id is None else process_id)
    backend = backend or default_backend()
    if torch.cuda.is_available():
        local = (int(local_device_ids[0]) if local_device_ids
                 else int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)

    def start():
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=rank)

    run_resilient("distributed/init", start, retry_policy)


def world_size() -> int:
    """The ranks of the process group (1 when none is started)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def is_multiprocess() -> bool:
    return world_size() > 1


def backend_name() -> Optional[str]:
    """The started group's backend ("nccl", "gloo"), or None."""
    import torch.distributed as dist

    return str(dist.get_backend()) if dist.is_initialized() else None


def local_rows(arr, mesh, placements):
    """This rank's block of the full array `arr` (numpy or tensor) under
    `placements` on `mesh`: for each Shard(d) mesh dim, the chunk of dim d
    at this rank's coordinate (in mesh-dim order, as DTensor lays shards
    out). The degrees divide the dims (the `constrainable` rule)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    out = arr
    for mdim, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(mdim)
            size = out.shape[p.dim] // n
            idx = [slice(None)] * out.ndim
            idx[p.dim] = slice(coord[mdim] * size, (coord[mdim] + 1) * size)
            out = out[tuple(idx)]
    return out


def host_local_batch(local, mesh, placements):
    """The DTensor whose block on this rank is `local` (this rank's rows,
    numpy or tensor, copied to the mesh's device when it is not there);
    the blocks of all ranks are even."""
    from torch.distributed.tensor import DTensor

    t = local if isinstance(local, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(local))
    t = t.to(mesh_device(mesh)).contiguous()
    return DTensor.from_local(t, mesh, list(placements), run_check=False)


def global_batch_from_full(arr, mesh, placements):
    """The DTensor of the full array `arr` that every rank holds: each
    rank keeps its own block (`local_rows`), nothing is sent."""
    return host_local_batch(local_rows(arr, mesh, placements), mesh,
                            placements)


def axis_group(mesh, axis: str):
    """The process group of mesh dim `axis`: the ranks that differ from
    this one only in their coordinate on it, in coordinate order."""
    return mesh.get_group(axis)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on mesh dim `axis` (`lax.axis_index`)."""
    return mesh.get_local_rank(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(axis))


# bytes each packed tensor starts on: the hand-written kernels read the
# tensors unpacked from a received buffer with 16-byte aligned rows
_PACK_ALIGN = 16


def _packed_layout(tensors):
    """Each tensor's byte offset in the packed buffer, and its length."""
    offs, n = [], 0
    for t in tensors:
        offs.append(n)
        n += -(-t.numel() * t.element_size() // _PACK_ALIGN) * _PACK_ALIGN
    return offs, n


class RingHop:
    """The handle of one `ring_shift`: `wait()` gives the received
    tensors, each in the shape and dtype of the one sent (contiguous)."""

    def __init__(self, work, buf, metas, offs, send=None):
        # the send buffer lives until the hop is waited on
        self._work, self._buf, self._send = work, buf, send
        self._metas, self._offs = metas, offs

    def wait(self):
        if self._work is None:
            return self._buf
        self._work.wait()
        self._send = None
        out = []
        for (shape, dtype, nbytes), off in zip(self._metas, self._offs):
            out.append(self._buf[off:off + nbytes].view(dtype).view(shape))
        return out


def ring_shift(tensors, mesh, axis: str, shift: int = 1) -> RingHop:
    """Send `tensors` to the rank `shift` ahead on mesh dim `axis` and
    receive those of the rank `shift` behind, as one asynchronous
    `all_to_all_single` of one packed byte buffer (the module docstring).
    Every rank of the axis calls it with tensors of the same shapes and
    dtypes. Returns a `RingHop`; a failed hop raises at `wait()`."""
    import torch.distributed as dist

    tensors = list(tensors)
    p = axis_size(mesh, axis)
    if p == 1:
        return RingHop(None, tensors, None, None)
    idx = axis_index(mesh, axis)
    offs, nbytes = _packed_layout(tensors)
    dev = tensors[0].device
    send = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    for t, off in zip(tensors, offs):
        n = t.numel() * t.element_size()
        send[off:off + n].copy_(t.contiguous().view(-1).view(torch.uint8))
    recv = torch.empty_like(send)
    in_splits, out_splits = [0] * p, [0] * p
    in_splits[(idx + shift) % p] = nbytes
    out_splits[(idx - shift) % p] = nbytes
    work = dist.all_to_all_single(recv, send, out_splits, in_splits,
                                  group=axis_group(mesh, axis),
                                  async_op=True)
    metas = [(tuple(t.shape), t.dtype, t.numel() * t.element_size())
             for t in tensors]
    return RingHop(work, recv, metas, offs, send)


def mesh_device(mesh) -> torch.device:
    """The device this rank's blocks live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
