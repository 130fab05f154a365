"""Ring attention: sequence-parallel attention over a mesh axis
(counterpart: flexflow_tpu/kernels/ring_attention.py).

q, k and v are sharded over the sequence on one mesh axis of P ranks. Each
rank attends its q chunk to the k/v chunk it holds while k and v rotate
around the ring (`runtime/distributed.ring_shift`, one packed buffer a
hop, posted before the chunk is computed and waited on after): after P
steps every q chunk has seen every k/v chunk. A rank's live memory is
O(s/P · d); no (s/P, s/P) block outlives its step.

The chunk steps are the hand-written flash kernels
(kernels/flash_attention.py), as the JAX package's comment assigns them
(`flash_attention.py:30-33`):
- forward (`chunk_fwd`): the chunk on the diagonal (k/v index = own
  index) is flash #1 causal; chunks behind it are #1 without the mask;
  chunks ahead of it are wholly masked and skipped, but their hop still
  happens (the rotation is the synchronization). Each step gives (o, lse),
  merged by lse in f32 (`merge`, JAX's online accumulation); with one
  chunk (P = 1) there is no merge, so a ring of one is flash, bit for bit.
- backward (`chunk_bwd`): flash #2 (dQ) and #3 (dK/dV) with the global
  lse and the global delta = Σ dO·O, causal on the diagonal and plain
  behind it; the f32 dK/dV accumulators rotate with their chunks, P hops
  in all, so each chunk's gradient comes home.
`RingAttention` saves only (q, k, v, out, lse), as JAX's custom VJP does:
no probability block.

On the CPU the chunk steps run the kernels' plain versions (tensors on
the CPU); on CUDA the kernels, or they raise. A chunk the kernels refuse
raises: the ring never gathers the sequence. `ring_plain_fwd` and
`ring_plain_bwd` are the plain version of the whole program, JAX's einsum
chunk step (`_chunk_attn`, `_masked_probs`) in lockstep over P chunks,
for the CPU tests and the card's check; `ring_lockstep_fwd` and
`ring_lockstep_bwd` run the per-step functions for P simulated ranks in
one process, the hop a rotation of a list. `launches` counts ring
programs run on CUDA tensors.

Over a mesh `ring_attention` (b, h, s, d) and `ring_attention_qkv`
(b, s, h, d) take DTensors: each runs on this rank's sequence shard on
`axis`, its batch rows on `batch_axes` (JAX's) and its own heads; the
output keeps that layout. Plain tensors are this rank's shards of a
mesh's ring.

Precision: as JAX's ring (`ring_attention.py:91-93`, `:123-126`), the
accumulators are f32 and the result is rounded once. #1 gives each
chunk's o, and #2/#3 each step's dQ/dK/dV, in f32 straight from their
accumulators (`out_dtype=torch.float32`, the kernels' f32 store); the
ring merges and sums them in f32 and rounds the output and the gradients
to the inputs' dtype once, at the end. The plain version rounds the same
way. A ring of one calls #1-#3 as flash does, bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.runtime.distributed import (axis_index, axis_size,
                                                    ring_shift)

launches = 0  # ring programs run on CUDA tensors


# ------------------------------------------------------- the chunk steps
def chunk_fwd(q, k, v, qi: int, ki: int, causal: bool, scale: float):
    """q chunk `qi` against k/v chunk `ki`, (b, h, s_loc, d) each:
    (o f32, unrounded, lse (b, h, s_loc, 1) f32), or None for a chunk
    wholly masked (causal, ki ahead of qi)."""
    if causal and ki > qi:
        return None
    return fa._fwd(q, k, v, causal and ki == qi, scale,
                   out_dtype=torch.float32)


def merge(acc, part):
    """Two partial attentions of the same rows, (o f32, lse) each, as
    one: o weighted by exp(lse - lse_new), in f32."""
    o_a, l_a = acc
    o_b, l_b = part
    lse = torch.logaddexp(l_a, l_b)
    return o_a * torch.exp(l_a - lse) + o_b * torch.exp(l_b - lse), lse


def chunk_bwd(q, k, v, do, lse, delta, qi: int, ki: int, causal: bool,
              scale: float):
    """(dq, dk, dv) of one step from the global lse and delta, in f32
    unrounded, or None for a wholly masked chunk."""
    if causal and ki > qi:
        return None
    c = causal and ki == qi
    dev = q.device.type
    f32 = torch.float32
    if dev == "cpu":
        return (fa._dq_plain(q, k, v, do, lse, delta, c, scale, f32),
                *fa._dkv_plain(q, k, v, do, lse, delta, c, scale, f32))
    if dev != "cuda":
        raise ValueError(f"ring attention runs on cuda or cpu, not {dev}")
    if not fa.flash_supported(q.shape[2], k.shape[2], q.shape[3], q.dtype,
                              c, q.shape[0] * q.shape[1]):
        raise ValueError(f"flash kernels do not cover the ring chunk q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    return (fa._dq_cuda(q, k, v, do, lse, delta, c, scale, f32),
            *fa._dkv_cuda(q, k, v, do, lse, delta, c, scale, f32))


# ---------------------------------------------------- the per-rank loops
def ring_fwd_local(q, k, v, mesh, axis: str, causal: bool, scale: float):
    """This rank's forward (JAX `_ring_fwd_local`): (out, lse)."""
    p, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    if p == 1:
        return fa._fwd(q, k, v, causal, scale)
    kv, acc = [k, v], None
    for j in range(p):
        hop = ring_shift(kv, mesh, axis) if j < p - 1 else None
        part = chunk_fwd(q, kv[0], kv[1], idx, (idx - j) % p, causal, scale)
        if part is not None:
            acc = part if acc is None else merge(acc, part)
        if hop is not None:
            kv = hop.wait()
    o, lse = acc
    return o.to(q.dtype), lse.contiguous()


def ring_bwd_local(q, k, v, o, lse, do, mesh, axis: str, causal: bool,
                   scale: float):
    """This rank's backward (JAX `_ring_bwd_local`): (dq, dk, dv). k/v
    hop ahead of the step that needs them; the dK/dV accumulators hop
    after each step and are waited on after the next step's kernels."""
    if do.stride(-1) != 1:
        do = do.contiguous()  # the kernels read rows of dO as contiguous
    p, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    if p == 1:
        return fa._bwd(q, k, v, o, lse, do, causal, scale)
    delta = fa._delta(o, do).contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = [k, v]
    dkv = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
           for t in (k, v)]
    pending = None
    for j in range(p):
        hop = ring_shift(kv, mesh, axis) if j < p - 1 else None
        g = chunk_bwd(q, kv[0], kv[1], do, lse, delta, idx, (idx - j) % p,
                      causal, scale)
        if pending is not None:
            dkv = pending.wait()
        if g is not None:
            dq += g[0]
            dkv[0] += g[1]
            dkv[1] += g[2]
        pending = ring_shift(dkv, mesh, axis)
        if hop is not None:
            kv = hop.wait()
    dk, dv = pending.wait()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttention(torch.autograd.Function):
    """The ring's forward and its hand-written backward; saves (q, k, v,
    out, lse) only."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale):
        global launches
        o, lse = ring_fwd_local(q, k, v, mesh, axis, causal, scale)
        if q.device.type == "cuda":
            launches += 1
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ring = (mesh, axis, causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ring_bwd_local(q, k, v, o, lse, do, *ctx.ring)
        return dq, dk, dv, None, None, None, None


# ------------------------------------------------------------ public API
def _ring_layout(q, seq_dim: int, axis: str, batch_axes: Sequence[str]):
    """The placements the ring runs a DTensor at (JAX's specs): the
    sequence shard on `axis`, the batch (dim 0) sharded over each of
    `batch_axes` that is on the mesh, is not `axis` and divides it, q's
    own shards of the heads, Replicate on every other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    names = list(mesh.mesh_dim_names)
    batch = [a for a in batch_axes if a in names and a != axis
             and q.shape[0] % axis_size(mesh, a) == 0]
    heads = 1 if seq_dim == 2 else 2
    return [Shard(seq_dim) if n == axis else Shard(0) if n in batch else
            (p if isinstance(p, Shard) and p.dim % q.ndim == heads
             else Replicate())
            for n, p in zip(names, q.placements)]


def _run(q, k, v, mesh, axis, causal, scale, seq_dim, batch_axes):
    """The ring on (b, h, s, d) (seq_dim 2) or (b, s, h, d) (seq_dim 1)
    tensors: DTensors through their layout, plain tensors as this rank's
    shards."""
    from torch.distributed.tensor import DTensor

    if q.ndim != 4 or k.shape != q.shape or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"ring attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if isinstance(q, DTensor):
        mesh = q.device_mesh
        names = list(mesh.mesh_dim_names)
        if axis not in names:
            raise ValueError(f"mesh has no axis {axis!r} (axes: {names})")
        if q.shape[seq_dim] % axis_size(mesh, axis):
            raise ValueError(f"seq {q.shape[seq_dim]} not divisible by ring "
                             f"axis {axis}={axis_size(mesh, axis)}")
        pl = _ring_layout(q, seq_dim, axis, batch_axes)
        ql, kl, vl = [t.redistribute(mesh, pl).to_local() for t in (q, k, v)]
        out = _run(ql, kl, vl, mesh, axis, causal, scale, seq_dim, ())
        return DTensor.from_local(out, mesh, pl, run_check=False)
    if seq_dim == 1:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    out = RingAttention.apply(q, k, v, mesh, axis, bool(causal), float(scale))
    return out.transpose(1, 2) if seq_dim == 1 else out


def ring_attention(q, k, v, mesh, axis: str, causal: bool = False,
                   scale: Optional[float] = None,
                   batch_axes: Sequence[str] = ("data",)):
    """q/k/v (b, h, s, d): DTensors (global; s divides by the axis size),
    run with the batch sharded over `batch_axes` as JAX's, or this rank's
    shards. Returns (b, h, s, d) sequence-sharded like the inputs,
    differentiable through the ring's backward."""
    return _run(q, k, v, mesh, axis, causal, scale, 2, batch_axes)


def ring_attention_qkv(q, k, v, mesh, axis: str, causal: bool = False,
                       scale: Optional[float] = None,
                       batch_axes: Sequence[str] = ("data",)):
    """Head-minor layout entry (b, s, h, d), used by ops/attention_ops."""
    return _run(q, k, v, mesh, axis, causal, scale, 1, batch_axes)


# ------------------------------------------- lockstep: P ranks, one process
def ring_lockstep_fwd(qs, ks, vs, causal: bool, scale: float):
    """The per-step functions for len(qs) simulated ranks in one process,
    the hop a rotation of the list: ([out], [lse]) a rank."""
    p = len(qs)
    if p == 1:
        o, lse = fa._fwd(qs[0], ks[0], vs[0], causal, scale)
        return [o], [lse]
    kv = list(zip(ks, vs))
    acc = [None] * p
    for j in range(p):
        for i in range(p):
            part = chunk_fwd(qs[i], kv[i][0], kv[i][1], i, (i - j) % p,
                             causal, scale)
            if part is not None:
                acc[i] = part if acc[i] is None else merge(acc[i], part)
        kv = [kv[(i - 1) % p] for i in range(p)]
    return ([a[0].to(qs[0].dtype) for a in acc],
            [a[1].contiguous() for a in acc])


def ring_lockstep_bwd(qs, ks, vs, outs, lses, dos, causal: bool,
                      scale: float):
    """The backward of `ring_lockstep_fwd`: ([dq], [dk], [dv]) a rank."""
    p = len(qs)
    deltas = [fa._delta(o, d).contiguous() for o, d in zip(outs, dos)]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in qs]
    kv = list(zip(ks, vs))
    dkv = [[torch.zeros(k.shape, dtype=torch.float32, device=k.device)
            for _ in range(2)] for k in ks]
    for j in range(p):
        for i in range(p):
            g = chunk_bwd(qs[i], kv[i][0], kv[i][1], dos[i], lses[i],
                          deltas[i], i, (i - j) % p, causal, scale)
            if g is not None:
                dq[i] += g[0]
                dkv[i][0] += g[1]
                dkv[i][1] += g[2]
        kv = [kv[(i - 1) % p] for i in range(p)]
        dkv = [dkv[(i - 1) % p] for i in range(p)]
    return ([d.to(q.dtype) for d, q in zip(dq, qs)],
            [d[0].to(k.dtype) for d, k in zip(dkv, ks)],
            [d[1].to(v.dtype) for d, v in zip(dkv, vs)])


# ------------------------------------------------- the plain version
def _band(row0: int, col0: int, sq: int, sk: int, device):
    row = row0 + torch.arange(sq, device=device)[:, None]
    col = col0 + torch.arange(sk, device=device)[None, :]
    return row >= col


def chunk_attn_plain(q, k, v, row0: int, col0: int, scale: float,
                     causal: bool):
    """JAX's `_chunk_attn`: (m, m_safe, l, pv) in f32 for q against one
    k/v chunk with global offsets."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_band(row0, col0, s.shape[2], s.shape[3],
                                 s.device), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    pr = torch.exp(s - m_safe)
    pr = torch.where(torch.isfinite(s), pr, torch.zeros_like(pr))
    l = pr.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bhkd->bhqd", pr.to(v.dtype).float(), v.float())
    return m, m_safe, l, pv


def masked_probs_plain(q, k, lse, row0: int, col0: int, scale: float,
                       causal: bool):
    """JAX's `_masked_probs`: one chunk's p = exp(q·kᵀ·scale − lse)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_band(row0, col0, s.shape[2], s.shape[3],
                                 s.device), float("-inf"))
    pr = torch.exp(s - lse)
    return torch.where(torch.isfinite(s), pr, torch.zeros_like(pr))


def ring_plain_fwd(q, k, v, p: int, causal: bool, scale: float):
    """JAX's ring forward over the whole (b, h, s, d) in P chunks, in
    lockstep: (out, lse (b, h, s, 1) f32)."""
    s_loc = q.shape[2] // p
    qs, ks, vs = (t.split(s_loc, dim=2) for t in (q, k, v))
    outs, lses = [], []
    ninf = float("-inf")
    for i in range(p):
        shape = q.shape[:2] + (s_loc, 1)
        m = torch.full(shape, ninf, device=q.device)
        l = torch.zeros(shape, device=q.device)
        acc = torch.zeros(q.shape[:2] + (s_loc, q.shape[3]), device=q.device)
        for j in range(p):
            ki = (i - j) % p
            cm, cm_safe, cl, cpv = chunk_attn_plain(
                qs[i], ks[ki], vs[ki], i * s_loc, ki * s_loc, scale, causal)
            m_new = torch.maximum(m, cm)
            m_new_safe = torch.where(torch.isfinite(m_new), m_new,
                                     torch.zeros_like(m_new))
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new_safe),
                                torch.zeros_like(m))
            beta = torch.where(torch.isfinite(cm),
                               torch.exp(cm_safe - m_new_safe),
                               torch.zeros_like(cm))
            l = l * alpha + cl * beta
            acc = acc * alpha + cpv * beta
            m = m_new
        outs.append(acc / l.clamp_min(1e-30))
        m_fin = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        lses.append(m_fin + torch.log(l.clamp_min(1e-30)))
    return torch.cat(outs, dim=2).to(q.dtype), torch.cat(lses, dim=2)


def ring_plain_bwd(q, k, v, out, lse, do, p: int, causal: bool,
                   scale: float):
    """JAX's ring backward over the whole tensors in P chunks: (dq, dk,
    dv) in the inputs' dtypes."""
    s_loc = q.shape[2] // p
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    qs, ks, vs, dos, lss, dls = (t.split(s_loc, dim=2)
                                 for t in (q, k, v, do, lse, delta))
    dq = [torch.zeros(c.shape, device=q.device) for c in qs]
    dk = [torch.zeros(c.shape, device=q.device) for c in ks]
    dv = [torch.zeros(c.shape, device=q.device) for c in vs]
    for i in range(p):
        for j in range(p):
            ki = (i - j) % p
            pr = masked_probs_plain(qs[i], ks[ki], lss[i], i * s_loc,
                                    ki * s_loc, scale, causal)
            pc = pr.to(do.dtype).float()
            dv[ki] += torch.einsum("bhqk,bhqd->bhkd", pc, dos[i].float())
            dp = torch.einsum("bhqd,bhkd->bhqk", dos[i].float(),
                              vs[ki].float())
            ds = (pr * (dp - dls[i]) * scale).to(q.dtype).float()
            dq[i] += torch.einsum("bhqk,bhkd->bhqd", ds, ks[ki].float())
            dk[ki] += torch.einsum("bhqk,bhqd->bhkd", ds, qs[i].float())
    return (torch.cat(dq, 2).to(q.dtype), torch.cat(dk, 2).to(k.dtype),
            torch.cat(dv, 2).to(v.dtype))
