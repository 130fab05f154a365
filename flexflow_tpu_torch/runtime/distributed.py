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
- `StageLink` is a pipeline's boundary hop (parallel/pipeline.py): rank
  (s, i) sends its stage's boundary activation to rank (s + 1, i) and
  receives its gradient back. Each boundary pair has one process group
  a direction. NCCL matches point-to-point ops in the order they are
  posted on one communicator and runs them on one stream, so with one
  group for both directions 1F1B's steady state (stage s sending
  act(m + 1) while stage s + 1 sends grad(m)) would deadlock; with two,
  each direction's sends and receives are in microbatch order on both
  sides. Receives are
  posted ahead (`irecv`) and sends waited on at the end of the update,
  the same design on every backend. The route is the backend's, fixed in
  the code: NCCL carries CUDA tensors and gloo CPU tensors as they are;
  gloo with CUDA tensors (two ranks sharing one card, where gloo refuses
  `isend`/`irecv` on CUDA tensors) goes through pinned host buffers.
"""

from __future__ import annotations

import math
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


def rank() -> int:
    """This process's rank (0 when no group is started)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


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


_HOST_GROUP: list = []


def host_group():
    """A group over the world that carries host (CPU) tensors: the world's
    own under gloo, else a gloo group made once. The first call is
    collective: every rank makes it, in the same order."""
    import torch.distributed as dist

    if not _HOST_GROUP:
        _HOST_GROUP.append(dist.group.WORLD if dist.get_backend() == "gloo"
                           else dist.new_group(backend="gloo"))
    return _HOST_GROUP[0]


def new_host_group():
    """A gloo group over the world of its own (a collective: every rank
    makes it, in the same order). A serving replica's lockstep reads go
    on one, so two replicas' threads on a rank never pair one replica's
    broadcast with the other's on another rank."""
    import torch.distributed as dist

    return dist.new_group(backend="gloo")


def own_groups_mesh(device_type: str, shape, names):
    """A `DeviceMesh` of the world's ranks laid out in `shape` (row major)
    with dim `names`, over process groups of its own: for each mesh dim,
    one `dist.new_group` a line of ranks along it, made by every rank in
    the same order (a collective). What runs over it never meets another
    mesh's collectives on a group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    layout = torch.arange(math.prod(shape), dtype=torch.int).reshape(
        tuple(shape))
    me = dist.get_rank()
    groups = []
    for j in range(layout.ndim):
        lines = layout.movedim(j, -1).reshape(-1, layout.shape[j]).tolist()
        mine = None
        for line in lines:
            g = dist.new_group(line)
            if me in line:
                mine = g
        groups.append(mine)
    return DeviceMesh.from_group(
        groups if len(groups) > 1 else groups[0], device_type,
        mesh=layout if len(groups) > 1 else None,
        mesh_dim_names=tuple(names))


def rank0_values(values, group=None) -> list:
    """Rank 0's `values` (numbers; every rank passes as many) on every
    rank: one broadcast of one host float64 tensor (a collective) on
    `group` (default `host_group()`)."""
    import torch.distributed as dist

    buf = torch.tensor([float(v) for v in values], dtype=torch.float64)
    dist.broadcast(buf, 0, group=group if group is not None
                   else host_group())
    return buf.tolist()


def rank0_clock(group=None) -> float:
    """Rank 0's `time.perf_counter()` on every rank: one broadcast of one
    host float64 (a collective, on `group`, default `host_group()`).
    Decisions that read a clock take it, so every rank makes them alike
    (the serving scheduler's lockstep)."""
    import time

    return rank0_values([time.perf_counter()], group)[0]


def rank0_object(obj, group=None):
    """Rank 0's `obj` (picklable) on every rank (a collective, on `group`,
    default `host_group()`): a decision rank 0 made from its clock or its
    file system."""
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, 0, group=group if group is not None
                               else host_group())
    return box[0]


_PENDING_OPS = {"sum": "SUM", "avg": "SUM", "max": "MAX", "min": "MIN"}


def relayout(x, pl):
    """The DTensor `x` in placements `pl`, moved by c10d's collectives on
    each rank's block: a pending reduction all-reduced (a sum, a max or a
    min; an average as the sum over the dim's size), a shard gathered
    (`all_gather_into_tensor`; mesh dims from the last, as nested shards
    unwind), then the shards `pl` asks for cut from what each rank holds,
    with nothing sent. DTensor's own redistribute takes the functional
    collectives, whose all-gather gloo does not carry on CUDA tensors
    (it segfaults on the card's torch); c10d's are what the serving
    engine moves its weights and logits with, and the trainer its loss's
    logits and the full values it reads back. Shards divide evenly (the
    `constrainable` rule)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, cur = x.device_mesh, list(x.placements)
    pl = list(pl)
    if cur == pl:
        return x
    local = x.to_local()
    for j in reversed(range(mesh.ndim)):
        a = cur[j]
        if a == pl[j] or a.is_replicate():
            continue
        group = mesh.get_group(j)
        if a.is_partial():
            op = getattr(a, "reduce_op", "sum")
            local = local.contiguous()
            dist.all_reduce(local, op=getattr(dist.ReduceOp,
                                              _PENDING_OPS[op]),
                            group=group)
            if op == "avg":
                local = local / mesh.size(j)
        else:
            n = mesh.size(j)
            flat = torch.empty((n * local.numel(),), dtype=local.dtype,
                               device=local.device)
            dist.all_gather_into_tensor(flat, local.contiguous().view(-1),
                                        group=group)
            local = torch.cat(flat.view(n, *local.shape).unbind(0),
                              dim=a.dim)
        cur[j] = Replicate()
    for j, b in enumerate(pl):
        if isinstance(b, Shard) and cur[j] != b:
            local = local.chunk(mesh.size(j), dim=b.dim)[
                mesh.get_local_rank(j)]
            cur[j] = b
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False)


class _Relayout(torch.autograd.Function):
    """`relayout` with its gradient: the gradient moved back into the
    input's placements by `relayout` too (a slice where the forward
    gathered), a pending input's dims taken replicated, as DTensor's own
    redistribute takes them."""

    @staticmethod
    def forward(ctx, x, pl):
        from torch.distributed.tensor import Replicate

        ctx.placements = [Replicate() if p.is_partial() else p
                          for p in x.placements]
        return relayout(x, pl)

    @staticmethod
    def backward(ctx, g):
        return relayout(g, ctx.placements), None


def relayout_grad(x, pl):
    """`relayout` that autograd differentiates (the trainer's moves)."""
    return _Relayout.apply(x, list(pl))


def full_local(x):
    """A DTensor's full value on every rank as a plain tensor, gathered by
    `relayout` (a collective: every rank calls it); a plain tensor as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    return relayout(x, [Replicate()] * x.device_mesh.ndim).to_local()


def mesh_device(mesh) -> torch.device:
    """The device this rank's blocks live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int32, torch.int64)


class StageLink:
    """The boundary hops of this rank of an S-stage pipeline of
    `per_stage` ranks a stage (the module docstring). `send_act` /
    `recv_act` move a microbatch's boundary activation forward,
    `send_grad` / `recv_grad` its gradient back; each direction delivers
    in microbatch order within an update (`begin_update`, `end_update`).
    The first activation on a boundary is preceded by a header (its dtype
    and this rank's block shape), which is also the gradient's. Every rank
    constructs it, in the same order: its groups are made over the
    world."""

    AHEAD = 2  # activation receives posted past the one waited on

    def __init__(self, num_stages: int, per_stage: int, device,
                 retry_policy=None):
        import torch.distributed as dist

        rank = dist.get_rank()
        self.stage, self.index = divmod(rank, per_stage)
        self.device = torch.device(device)
        self.retry_policy = retry_policy
        self._peer, self._group = {}, {}
        for b in range(num_stages - 1):
            for i in range(per_stage):
                pair = [b * per_stage + i, (b + 1) * per_stage + i]
                for d in ("act", "grad"):
                    g = dist.new_group(pair)
                    if rank in pair:
                        self._group[d, b] = g
                        self._peer[d, b] = pair[1] if rank == pair[0] \
                            else pair[0]
        # the route, by backend: gloo carries no CUDA tensor point to
        # point, so gloo with CUDA tensors goes through pinned host buffers
        self._host = (backend_name() == "gloo"
                      and self.device.type == "cuda")
        self._wire = (self.device if self.device.type == "cuda"
                      and not self._host else torch.device("cpu"))
        self._meta = {}     # boundary -> (dtype, this rank's block shape)
        self._posted = {}   # (direction, boundary) -> {m: (work, buf)}
        self._next = {}     # (direction, boundary) -> next m to post
        self._sends = []    # (work, buf) posted this update
        self._micro = 0

    def begin_update(self, num_micro: int) -> None:
        self._micro = num_micro
        self._next.clear()

    def end_update(self) -> None:
        """Wait on the update's sends (their buffers live until then)."""
        for work, _ in self._sends:
            work.wait()
        self._sends.clear()
        left = {k: sorted(v) for k, v in self._posted.items() if v}
        if left:
            raise RuntimeError(f"pipeline link: receives {left} posted past "
                               "the update")

    def _isend(self, d: str, b: int, buf: torch.Tensor):
        import torch.distributed as dist

        return dist.isend(buf, self._peer[d, b], group=self._group[d, b])

    def _send(self, d: str, b: int, t: torch.Tensor) -> None:
        """One hop under the `pipe/boundary_hop` fault and retry site: the
        fault is checked before the send is posted, so a retry posts it
        once."""
        from flexflow_tpu_torch.runtime.resilience import run_resilient

        t = t.detach().contiguous()
        if self._host:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
        else:
            buf = t
        work = run_resilient("pipe/boundary_hop",
                             lambda: self._isend(d, b, buf),
                             self.retry_policy)
        self._sends.append((work, buf))

    def send_act(self, t: torch.Tensor, m: int,
                 want_grad: bool = True) -> None:
        """Microbatch m's boundary activation to the next stage; the
        receive of its gradient is posted with it (`want_grad`: inference
        sends none back)."""
        b = self.stage
        if b not in self._meta:
            self._meta[b] = (t.dtype, tuple(t.shape))
            head = [t.ndim, _DTYPES.index(t.dtype), *t.shape]
            head = torch.tensor(head + [0] * (8 - len(head)),
                                dtype=torch.int64, device=self._wire)
            self._sends.append((self._isend("act", b, head), head))
        self._send("act", b, t)
        if want_grad:
            self._post("grad", b, m + 1)

    def send_grad(self, t: torch.Tensor) -> None:
        """The gradient of this stage's boundary input to the stage
        before (in the order its activations came)."""
        self._send("grad", self.stage - 1, t)

    def _post(self, d: str, b: int, end: int) -> None:
        """Post direction d's receives on boundary b up to microbatch
        `end` (exclusive, at most the update's count)."""
        import torch.distributed as dist

        posted = self._posted.setdefault((d, b), {})
        dtype, shape = self._meta[b]
        for m in range(self._next.get((d, b), 0), min(end, self._micro)):
            buf = torch.empty(shape, dtype=dtype, device=self._wire,
                              pin_memory=self._host)
            posted[m] = (dist.irecv(buf, self._peer[d, b],
                                    group=self._group[d, b]), buf)
            self._next[d, b] = m + 1

    def _take(self, d: str, b: int, m: int) -> torch.Tensor:
        work, buf = self._posted[d, b].pop(m)
        work.wait()
        return buf.to(self.device, non_blocking=True) if self._host else buf

    def recv_act(self, m: int) -> torch.Tensor:
        """Microbatch m's boundary activation from the stage before."""
        import torch.distributed as dist

        b = self.stage - 1
        if b not in self._meta:
            head = torch.zeros(8, dtype=torch.int64, device=self._wire)
            dist.recv(head, self._peer["act", b], group=self._group["act", b])
            head = head.cpu().tolist()
            self._meta[b] = (_DTYPES[head[1]], tuple(head[2:2 + head[0]]))
        self._post("act", b, m + 1 + self.AHEAD)
        return self._take("act", b, m)

    def recv_grad(self, m: int) -> torch.Tensor:
        """Microbatch m's gradient of this stage's boundary output."""
        return self._take("grad", self.stage, m)
