"""Fused optimizer update: hand-written CUDA Adam and SGD kernels and
their plain versions (counterpart: flexflow_tpu/kernels/fused_optim.py).

Replaces the Pallas TPU kernels `_adam_leaf` -> `_adam_kernel` (Adam's
moments and update in one pass over (g, mu, nu, p), all arithmetic in f32,
moments stored in the optimizer's state dtype, f32 or bf16, decoupled
weight decay after the Adam term, `scale(-lr)` last) and `_sgd_leaf` ->
`_sgd_kernel` (momentum or nesterov trace, stored f32) and
`_sgd_plain_kernel` (no trace). The CUDA source is `csrc/fused_optim.cu`;
it writes `p + (-lr u)` straight into p, the same f32 arithmetic as the
TPU kernels followed by `optax.apply_updates`, so the plain versions here
take the same two steps and round every product and sum where the kernel
does: kernel and plain version agree bit for bit.

What bounds them on an H100: bytes. Each f32 param moves 28 bytes under
Adam (g, mu, nu, p read; mu, nu, p written), 20 under SGD with a trace
and 12 without: 3.40, 2.43 and 1.46 ms for GPT-2 medium's ~406 M params
at 3.35 TB/s. The TPU code launches one kernel per padded leaf (389 a
step for GPT-2 medium); the port launches ONE over every param, from a
device table of per-chunk pointers into the params and moments or trace,
which the wrapper builds once and reuses while those pointers stay the
same (they are updated in place; a replaced param, e.g. by `set_weight`,
changes its pointer and rebuilds the table). Autograd hands back new
gradient tensors every step, so the gradients' base pointers go to the
kernel apart, one int64 per leaf copied each step. Adam and SGD keep
their tables apart, per plan. Adam's scalars come from the device: the
count is a device int32 that the step increments, and the kernel reads
the (2,) f32 bias corrections computed from it
(`optimizers.device_bias_corrections`), the same route eagerly and in a
graph.

Inside a CUDA graph capture (compiler/compile.py `make_multi_step`) a
step may copy nothing from the host: the params' table must already be
built (a rebuild raises), and the gradients, which come from the graph's
pool at addresses fixed for every replay, take their pointers from
device buffers that the capture's owner allocated BEFORE the capture
(`begin_capture`) and `fill_captured()` writes once it has ended. A
buffer allocated inside the capture could reuse the memory of a tensor
the capture freed earlier, and the replay would overwrite the pointers
with that tensor's values.

Over a mesh the compile hands the update each rank's blocks as plain
tensors (compiler/compile.py `_mesh_update`): the rank's local params
and moments (under ZeRO its block of each param and its moment shard)
and the synced gradients' blocks, so it stays one launch over the rank's
leaves, and its tables point at blocks that persist from step to step.

`plan_for` recognises the port's optimizers as the JAX one does.
`launches` counts Adam launches, `launches_sgd` SGD launches with a trace
(#9) and `launches_sgd_plain` those without (#8); `table_builds` counts
the tables built.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from flexflow_tpu_torch.kernels._build import load_library
from flexflow_tpu_torch.optimizers import (AdamOptimizer, SGDOptimizer,
                                           device_bias_corrections,
                                           step_count)

CHUNK = 32768   # elements of one table entry (one block)
_MOMENT_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0            # Adam (#7 `_adam_kernel`)
launches_sgd = 0        # SGD with a momentum trace (#9 `_sgd_kernel`)
launches_sgd_plain = 0  # SGD without one (#8 `_sgd_plain_kernel`)
table_builds = 0        # pointer tables built on the host (Adam and SGD)


def plan_for(optimizer) -> Optional[Dict[str, Any]]:
    """Recognise the optimizer's update math, or None."""
    if type(optimizer) is AdamOptimizer:
        return {"kind": "adam", "lr": float(optimizer.alpha),
                "b1": float(optimizer.beta1), "b2": float(optimizer.beta2),
                "eps": float(optimizer.epsilon),
                "wd": float(optimizer.weight_decay),
                "state_dtype": optimizer.moment_dtype()}
    if type(optimizer) is SGDOptimizer:
        return {"kind": "sgd", "lr": float(optimizer.lr),
                "momentum": float(optimizer.momentum),
                "nesterov": bool(optimizer.nesterov),
                "wd": float(optimizer.weight_decay)}
    return None


# --------------------------------------------------------------------- Adam
@torch.no_grad()
def _adam_plain(plan, gs: List[torch.Tensor], mus, nus, ps,
                sc: torch.Tensor):
    """The kernel's function in plain PyTorch, leaf by leaf, each product
    and sum rounded on its own as the kernel rounds them; `sc` holds the
    f32 bias corrections (bc1, bc2) as the kernel reads them."""
    b1, b2, lr, wd = plan["b1"], plan["b2"], plan["lr"], plan["wd"]
    # 0-dim tensors: a true division, as the kernel's
    t1, t2 = sc[0], sc[1]
    for g, mu, nu, p in zip(gs, mus, nus, ps):
        g = g.float()
        mu_n = b1 * mu.float() + (1 - b1) * g
        nu_n = b2 * nu.float() + ((1 - b2) * g) * g
        u = (mu_n / t1) / (torch.sqrt(nu_n / t2) + plan["eps"])
        if wd:
            u = u + wd * p
        p.add_(-lr * u)
        mu.copy_(mu_n)
        nu.copy_(nu_n)


def adam_scalars(plan, count: int, device) -> torch.Tensor:
    """The (2,) f32 bias corrections of update `count` on `device`, as a
    step computes them: the `sc` argument of `_adam_cuda`/`_adam_plain`
    when they are called directly."""
    c = torch.tensor(int(count), dtype=torch.int32).to(device)
    return device_bias_corrections(plan["b1"], plan["b2"], c,
                                   plan.setdefault("_bases", {}))


def _adam_fn():
    fn = load_library("fused_optim").ff_adam
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int] + [ctypes.c_float] * 7
                       + [ctypes.c_void_p] * 2)
    return fn


def _to_device(host: np.ndarray, device) -> torch.Tensor:
    # pinned + non-blocking: the host does not wait; the pinned block is
    # not reused before the copy has run
    return torch.from_numpy(np.ascontiguousarray(host)).pin_memory().to(
        device, non_blocking=True)


def _chunk_table(columns, device) -> torch.Tensor:
    """(n_chunks, len(columns) + 3) int64 on the device: per CHUNK-element
    slice of each leaf, the leaf's index and the slice's element offset,
    the slice's address in every column (`columns` is a list of leaf lists
    in the same leaf order) and its length. Empty leaves have no entry."""
    rows = []
    for i, leaves in enumerate(zip(*columns)):
        n = leaves[-1].numel()
        if n == 0:
            continue
        starts = np.arange(0, n, CHUNK, dtype=np.int64)
        rows.append(np.stack([np.full_like(starts, i), starts]
                             + [t.data_ptr() + t.element_size() * starts
                                for t in leaves]
                             + [np.minimum(CHUNK, n - starts)], axis=1))
    return _to_device(np.concatenate(rows), device)


def _cached_table(plan, slot: str, columns, device) -> torch.Tensor:
    """The plan's table in `slot` over the arrays that persist from step
    to step (params and moments or trace, updated in place), rebuilt when
    any of their pointers or sizes changed."""
    global table_builds
    key = tuple(tuple(t.data_ptr() for t in leaves) + (leaves[-1].numel(),)
                for leaves in zip(*columns))
    cached = plan.get(slot)
    if cached is None or cached[0] != key:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "fused optimizer: its pointer table would be rebuilt inside "
                "a CUDA graph capture (a param or moment moved); run a "
                "step before capturing")
        cached = plan[slot] = (key, _chunk_table(columns, device))
        table_builds += 1
    return cached[1]


def begin_capture(plan, updates: int, leaves: int, device) -> None:
    """Before a graph capture of `updates` fused updates over `leaves`
    params: their gradient-pointer buffers, allocated outside the graph's
    pool."""
    plan["_capture_free"] = [torch.empty(leaves, dtype=torch.int64,
                                         device=device)
                             for _ in range(updates)]
    plan["_captured"] = []


def fill_captured(plan) -> List[torch.Tensor]:
    """After the capture: write each captured update's gradient pointers
    into its buffer; returns the buffers, which the graph's owner keeps
    alive."""
    bufs = []
    for buf, ptrs in plan.pop("_captured", []):
        buf.copy_(torch.from_numpy(ptrs))
        bufs.append(buf)
    plan.pop("_capture_free", None)
    return bufs


def _grad_ptrs(plan, gs, device) -> torch.Tensor:
    """The gradients' base pointers, one int64 per leaf, on the device:
    autograd returns new gradient tensors every step, so these go to the
    kernel apart from the cached table. Inside a capture the next buffer
    of `begin_capture` is filled after it ends."""
    ptrs = np.array([g.data_ptr() for g in gs], dtype=np.int64)
    if torch.cuda.is_current_stream_capturing():
        free = plan.get("_capture_free")
        if not free or free[0].numel() != len(gs):
            raise RuntimeError(
                "fused optimizer inside a CUDA graph capture without its "
                "gradient-pointer buffers (begin_capture): capture the "
                "train step through make_multi_step")
        buf = free.pop(0)
        plan["_captured"].append((buf, ptrs))
        return buf
    return _to_device(ptrs, device)


def _adam_cuda(plan, gs, mus, nus, ps, sc: torch.Tensor):
    global launches
    md = plan["state_dtype"]
    dev = ps[0].device
    for g, mu, nu, p in zip(gs, mus, nus, ps):
        if not (p.dtype == g.dtype == torch.float32 and mu.dtype == nu.dtype == md
                and p.is_contiguous() and g.is_contiguous()
                and mu.is_contiguous() and nu.is_contiguous()
                and p.numel() == g.numel() == mu.numel() == nu.numel()
                and p.device == g.device == mu.device == nu.device == dev):
            raise ValueError(
                f"fused Adam kernel covers contiguous f32 params and grads "
                f"with {md} moments on one device; got p {p.dtype} "
                f"{tuple(p.shape)}, g {g.dtype} {tuple(g.shape)}, moments "
                f"{mu.dtype}/{nu.dtype}; fused_optimizer='off' runs the "
                "unfused update")
    if not (sc.shape == (2,) and sc.dtype == torch.float32
            and sc.device == dev and sc.is_contiguous()):
        raise ValueError(f"fused Adam kernel reads (2,) f32 bias corrections "
                         f"on {dev}; got {sc.dtype} {tuple(sc.shape)} on "
                         f"{sc.device}")
    table = _cached_table(plan, "_adam_table", (mus, nus, ps), dev)
    gptrs = _grad_ptrs(plan, gs, dev)
    b1, b2 = plan["b1"], plan["b2"]
    err = _adam_fn()(table.data_ptr(), gptrs.data_ptr(), table.shape[0],
                     _MOMENT_CODE[md],
                     plan["lr"], b1, 1 - b1, b2, 1 - b2, plan["eps"],
                     plan["wd"], sc.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused Adam kernel launch failed: CUDA error {err}")
    launches += 1


# ---------------------------------------------------------------------- SGD
@torch.no_grad()
def _sgd_plain(plan, gs, traces, ps):
    """`_sgd_kernel` (traces given) or `_sgd_plain_kernel` in plain
    PyTorch, each product and sum rounded on its own as the kernel rounds
    them."""
    m, wd, lr = plan["momentum"], plan["wd"], plan["lr"]
    for i, (g, p) in enumerate(zip(gs, ps)):
        g = g.float()
        if wd:
            g = g + wd * p
        if traces is not None:
            t = traces[i]
            t_new = g + m * t
            g = g + m * t_new if plan["nesterov"] else t_new
            t.copy_(t_new)
        p.add_(-lr * g)


def _sgd_fn():
    fn = load_library("fused_optim").ff_sgd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    return fn


def _sgd_cuda(plan, gs, traces, ps):
    """One launch of `_sgd_kernel` (traces given) or `_sgd_plain_kernel`
    over every leaf."""
    global launches_sgd, launches_sgd_plain
    dev = ps[0].device
    ts = traces if traces is not None else [None] * len(ps)
    for g, t, p in zip(gs, ts, ps):
        arrays = (g, p) if t is None else (g, t, p)
        if not all(a.dtype == torch.float32 and a.is_contiguous()
                   and a.device == dev and a.numel() == p.numel()
                   for a in arrays):
            raise ValueError(
                f"fused SGD kernel covers contiguous f32 params, grads and "
                f"traces on one device; got p {p.dtype} {tuple(p.shape)}, g "
                f"{g.dtype} {tuple(g.shape)}, trace "
                f"{None if t is None else (t.dtype, tuple(t.shape))}; "
                "fused_optimizer='off' runs the unfused update")
    columns = (ps,) if traces is None else (traces, ps)
    table = _cached_table(plan, "_sgd_table", columns, dev)
    gptrs = _grad_ptrs(plan, gs, dev)
    err = _sgd_fn()(table.data_ptr(), gptrs.data_ptr(), table.shape[0],
                    int(traces is not None),
                    int(plan["nesterov"]), plan["lr"], plan["momentum"],
                    plan["wd"], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused SGD kernel launch failed: CUDA error {err}")
    if traces is None:
        launches_sgd_plain += 1
    else:
        launches_sgd += 1


# ------------------------------------------------------------------- update
def _leaves(tree, order):
    return [tree[l][w] for l, w in order]


def fused_update(plan: Dict[str, Any], grads, state: Dict[str, Any],
                 params) -> Dict[str, Any]:
    """The optimizer step over `{layer: {weight: tensor}}` trees: params,
    moments and Adam's device count are written in place; returns the
    state. CPU tensors take the plain versions, CUDA tensors the
    kernels."""
    order = [(l, w) for l, ws in params.items() for w in ws]
    ps, gs = _leaves(params, order), _leaves(grads, order)
    dev = ps[0].device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"fused optimizer runs on cuda or cpu, not {dev}")
    if plan["kind"] == "adam":
        count = step_count(state, ps[0].device).add_(1)
        sc = device_bias_corrections(plan["b1"], plan["b2"], count,
                                     plan.setdefault("_bases", {}))
        fn = _adam_plain if dev == "cpu" else _adam_cuda
        fn(plan, gs, _leaves(state["mu"], order), _leaves(state["nu"], order),
           ps, sc)
        return state
    if plan["kind"] == "sgd":
        traces = (_leaves(state["trace"], order) if plan["momentum"]
                  else None)
        (_sgd_plain if dev == "cpu" else _sgd_cuda)(plan, gs, traces, ps)
        return state
    raise ValueError(f"unknown fused optimizer plan {plan['kind']!r}")
