"""Collective matmul: the all-gather of a row-sharded activation
overlapped with its matmul (counterpart:
flexflow_tpu/kernels/collective_matmul.py).

x (m, k) has its rows sharded on a mesh axis of P ranks, w (k, n) its
columns; y = x @ w comes out with all its rows and this rank's columns,
as the all-gather followed by the matmul gives it. Instead of gathering,
x's row chunks walk the ring (`runtime/distributed.ring_shift`, P - 1
hops): each rank posts the next hop, multiplies the chunk it holds by its
resident columns, writes that block of y, and waits on the hop only when
it needs the next chunk. The chunk product is a plain large matmul, which
JAX computes outside any Pallas kernel, so `torch.matmul` stays.

JAX leaves the backward to autodiff through `ppermute`; here it is
written out (`CollectiveMatmul`): dW is a second walk of x's chunks
(dW = Σ_c x_cᵀ dY[rows c]), and dX is a reduce ring, each partial dX
chunk (dY[rows c] wᵀ over this rank's columns) travelling with the ring
and summed until it reaches the chunk's home (P - 1 hops). Each partial
product comes out in f32 (`_mm_f32`, JAX's `preferred_element_type=
jnp.float32`), the sums run in f32 and each gradient is rounded to its
input's dtype once, at the end, as one matmul over the gathered x
rounds it.
`launches` counts calls on CUDA tensors.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.runtime.distributed import (axis_index, axis_size,
                                                    ring_shift)

launches = 0  # collective matmuls run on CUDA tensors


def _mesh_axes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) \
        if mesh is not None and mesh.mesh_dim_names else {}


def collective_matmul_supported(mesh, axis: str, m: int, n: int) -> bool:
    """JAX's gate: the axis is on the mesh, has more than one rank, and
    divides both m and n."""
    axes = _mesh_axes(mesh)
    if axis not in axes:
        return False
    p = axes[axis]
    return p > 1 and m % p == 0 and n % p == 0


def _ring_fwd(x, w, mesh, axis: str):
    """This rank's body (JAX `_ring_matmul`): x (m/P, k) its row chunk,
    w (k, n/P) its columns -> y (m, n/P)."""
    p, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    mp = x.shape[0]
    y = torch.empty((mp * p, w.shape[1]),
                    dtype=torch.promote_types(x.dtype, w.dtype),
                    device=x.device)
    cur = x
    for i in range(p):
        hop = ring_shift([cur], mesh, axis) if i < p - 1 else None
        src = (idx - i) % p  # whose rows this rank holds now
        torch.matmul(cur, w, out=y[src * mp:(src + 1) * mp])
        if hop is not None:
            (cur,) = hop.wait()
    return y


def _mm_f32(a, b):
    """a @ b with f32 products and an f32 result: on CUDA one GEMM of the
    inputs' dtype that accumulates and writes f32 (torch.mm's
    `out_dtype`); on the CPU, which has no such GEMM, the f32 upcast,
    which computes the same products (a bf16 product is exact in f32)."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _ring_bwd(x, w, dy, mesh, axis: str):
    """(dx, dw) of `_ring_fwd`: dw by a second walk of x's chunks, dx by
    the reduce ring (module docstring)."""
    p, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    mp = x.shape[0]

    def rows(c):
        return dy[c * mp:(c + 1) * mp]

    dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    cur = x
    for i in range(p):
        hop = ring_shift([cur], mesh, axis) if i < p - 1 else None
        dw += _mm_f32(cur.transpose(0, 1), rows((idx - i) % p))
        if hop is not None:
            (cur,) = hop.wait()
    # the partial dX of chunk c starts at rank c + 1 and goes round to c
    wt = w.transpose(0, 1)
    acc = _mm_f32(rows((idx - 1) % p), wt)
    for s in range(1, p):
        hop = ring_shift([acc], mesh, axis)
        part = _mm_f32(rows((idx - 1 - s) % p), wt)
        (acc,) = hop.wait()
        acc = acc + part
    return acc.to(x.dtype), dw.to(w.dtype)


class CollectiveMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mesh, axis):
        global launches
        if x.device.type == "cuda":
            launches += 1
        ctx.save_for_backward(x, w)
        ctx.ring = (mesh, axis)
        return _ring_fwd(x, w, mesh, axis)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _ring_bwd(x, w, dy.contiguous(), *ctx.ring)
        return dx, dw, None, None


def collective_matmul(x, w, mesh, axis: str):
    """y = x @ w with the all-gather of x overlapped into the ring.

    x (m, k) and w (k, n) as DTensors (any layout: x is brought to rows
    on `axis`, w to columns on it) or as this rank's blocks (x's rows, w's
    columns); returns y (m, n) with its columns on `axis` (a DTensor, or
    this rank's block). Raises ValueError on shapes or meshes the ring
    does not cover (callers precheck with `collective_matmul_supported`).
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dt = isinstance(x, DTensor)
    if dt:
        mesh = x.device_mesh
    axes = _mesh_axes(mesh)
    p = axes.get(axis, 1)
    m = x.shape[0] * (1 if dt else p)
    n = w.shape[1] * (1 if dt else p)
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"collective_matmul: bad shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if not collective_matmul_supported(mesh, axis, m, n):
        raise ValueError(
            f"collective_matmul: mesh axis {axis!r} (mesh {axes}) can't "
            f"ring {(m, x.shape[1])} @ {(w.shape[0], n)}")
    if not dt:
        return CollectiveMatmul.apply(x, w, mesh, axis)
    names = list(mesh.mesh_dim_names)
    xpl = [Shard(0) if a == axis else Replicate() for a in names]
    wpl = [Shard(1) if a == axis else Replicate() for a in names]
    y = CollectiveMatmul.apply(x.redistribute(mesh, xpl).to_local(),
                               w.redistribute(mesh, wpl).to_local(),
                               mesh, axis)
    return DTensor.from_local(y, mesh, wpl, run_check=False)
