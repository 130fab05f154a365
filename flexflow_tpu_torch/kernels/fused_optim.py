"""Fused optimizer update: a hand-written CUDA Adam kernel and its plain
version (counterpart: flexflow_tpu/kernels/fused_optim.py).

Replaces the Pallas TPU kernel `_adam_leaf` -> `_adam_kernel`: Adam's
moments and update in one pass over (g, mu, nu, p), all arithmetic in f32,
moments stored in the optimizer's state dtype (f32 or bf16), decoupled
weight decay after the Adam term, `scale(-lr)` last. The CUDA source is
`csrc/fused_optim.cu`; it writes `p + (-lr u)` straight into p, the same
f32 arithmetic as the TPU kernel followed by `optax.apply_updates`, so the
plain version here takes the same two steps.

What bounds it on an H100: bytes. Each f32 param moves 28 bytes (g, mu,
nu, p read; mu, nu, p written): 3.40 ms for GPT-2 medium's 406 M params at
3.35 TB/s. The TPU code launches one kernel per padded leaf (389 a step
for GPT-2 medium); the port launches ONE over every param, from a device
table of per-chunk pointers that the wrapper builds once and reuses while
the pointers stay the same (params and moments are updated in place; a
replaced param, e.g. by `set_weight`, changes its pointer and rebuilds the
table).

`plan_for` recognises the port's optimizers as the JAX one does. The SGD
kernels (#8 `_sgd_plain_kernel`, #9 `_sgd_kernel`) are not ported yet: an
SGD plan runs its plain version on CPU tensors and raises on CUDA tensors.
`launches` counts Adam kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from flexflow_tpu_torch.kernels._build import load_library
from flexflow_tpu_torch.optimizers import (AdamOptimizer, SGDOptimizer,
                                           bias_corrections)

CHUNK = 32768   # elements of one table entry (one block)
_MOMENT_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


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
def _adam_plain(plan, gs: List[torch.Tensor], mus, nus, ps, count: int):
    """The kernel's function in plain PyTorch, leaf by leaf, each product
    and sum rounded on its own as the kernel rounds them."""
    bc1, bc2 = bias_corrections(plan["b1"], plan["b2"], count)
    b1, b2, lr, wd = plan["b1"], plan["b2"], plan["lr"], plan["wd"]
    for g, mu, nu, p in zip(gs, mus, nus, ps):
        # 0-dim device tensors: a true division, as the kernel's
        t1 = torch.tensor(bc1, dtype=torch.float32, device=p.device)
        t2 = torch.tensor(bc2, dtype=torch.float32, device=p.device)
        g = g.float()
        mu_n = b1 * mu.float() + (1 - b1) * g
        nu_n = b2 * nu.float() + ((1 - b2) * g) * g
        u = (mu_n / t1) / (torch.sqrt(nu_n / t2) + plan["eps"])
        if wd:
            u = u + wd * p
        p.add_(-lr * u)
        mu.copy_(mu_n)
        nu.copy_(nu_n)


def _adam_fn():
    fn = load_library("fused_optim").ff_adam
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_float] * 9 + [ctypes.c_void_p])
    return fn


def _chunk_table(gs, mus, nus, ps, device) -> torch.Tensor:
    """(n_chunks, 5) int64 on the device: per CHUNK-element slice of each
    leaf, its g, mu, nu and p addresses and its length."""
    msize = mus[0].element_size()
    rows = []
    for g, mu, nu, p in zip(gs, mus, nus, ps):
        n = p.numel()
        if n == 0:
            continue
        starts = np.arange(0, n, CHUNK, dtype=np.int64)
        rows.append(np.stack([g.data_ptr() + 4 * starts,
                              mu.data_ptr() + msize * starts,
                              nu.data_ptr() + msize * starts,
                              p.data_ptr() + 4 * starts,
                              np.minimum(CHUNK, n - starts)], axis=1))
    host = torch.from_numpy(np.ascontiguousarray(np.concatenate(rows)))
    # pinned + non-blocking: the host does not wait; the pinned block is
    # not reused before the copy has run
    return host.pin_memory().to(device, non_blocking=True)


def _adam_cuda(plan, gs, mus, nus, ps, count: int):
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
    key = tuple((g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.data_ptr(),
                 p.numel()) for g, mu, nu, p in zip(gs, mus, nus, ps))
    cached = plan.get("_table")
    if cached is None or cached[0] != key:
        cached = plan["_table"] = (key, _chunk_table(gs, mus, nus, ps, dev))
    table = cached[1]
    bc1, bc2 = bias_corrections(plan["b1"], plan["b2"], count)
    b1, b2 = plan["b1"], plan["b2"]
    err = _adam_fn()(table.data_ptr(), table.shape[0], _MOMENT_CODE[md],
                     plan["lr"], b1, 1 - b1, b2, 1 - b2, plan["eps"],
                     plan["wd"], bc1, bc2,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused Adam kernel launch failed: CUDA error {err}")
    launches += 1


# ---------------------------------------------------------------------- SGD
@torch.no_grad()
def _sgd_plain(plan, gs, traces, ps):
    """`_sgd_kernel` (traces given) or `_sgd_plain_kernel` in plain
    PyTorch."""
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


# ------------------------------------------------------------------- update
def _leaves(tree, order):
    return [tree[l][w] for l, w in order]


def fused_update(plan: Dict[str, Any], grads, state: Dict[str, Any],
                 params) -> Dict[str, Any]:
    """The optimizer step over `{layer: {weight: tensor}}` trees: params
    and moments are written in place; returns the new state. CPU tensors
    take the plain versions; CUDA tensors the Adam kernel, and an SGD plan
    raises there (its kernels are not ported)."""
    order = [(l, w) for l, ws in params.items() for w in ws]
    ps, gs = _leaves(params, order), _leaves(grads, order)
    dev = ps[0].device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"fused optimizer runs on cuda or cpu, not {dev}")
    if plan["kind"] == "adam":
        count = state["count"] + 1
        fn = _adam_plain if dev == "cpu" else _adam_cuda
        fn(plan, gs, _leaves(state["mu"], order), _leaves(state["nu"], order),
           ps, count)
        return dict(state, count=count)
    if plan["kind"] == "sgd":
        if dev == "cuda":
            raise NotImplementedError(
                "the fused SGD kernels (TPU kernels #8 _sgd_plain_kernel and "
                "#9 _sgd_kernel) are not ported to CUDA yet; pass "
                "fused_optimizer='off' to run SGD's unfused update")
        traces = (_leaves(state["trace"], order) if plan["momentum"]
                  else None)
        _sgd_plain(plan, gs, traces, ps)
        return state
    raise ValueError(f"unknown fused optimizer plan {plan['kind']!r}")
