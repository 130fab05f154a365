"""Optimizers: SGD and Adam (counterpart: flexflow_tpu/optimizers.py).

The JAX package builds optax chains; the port carries the same update
math itself, in plain PyTorch, and applies it to the params in place:

- SGD: `add_decayed_weights(wd)` (g + wd p), then the momentum trace
  (t' = g + m t; the update is t', or g + m t' with nesterov), then
  `scale(-lr)`;
- Adam: the moments mu' = (1 - b1) g + b1 mu and nu' = (1 - b2) g^2 + b2 nu,
  bias correction by `1 - b**count` computed in f32, u = mu_hat /
  (sqrt(nu_hat) + eps), then decoupled weight decay u + wd p AFTER the Adam
  term, then `scale(-lr)` last. With `state_dtype="bfloat16"` the moments
  are stored in bf16 (rounded to nearest even) and all arithmetic stays
  f32, as `_scale_by_adam_lowp` does.

`torch.optim` is not used: its AdamW decays the weights before the step.
This is the unfused update (`fused_optimizer="off"`); the fused path
(kernels/fused_optim.py) computes the same function in one kernel.

Trees are `{layer: {weight: tensor}}`. An optimizer state is a dict:
Adam `{"count": int, "mu": tree, "nu": tree}`, SGD with momentum
`{"trace": tree}`, plain SGD `{}`. `update` writes the params and the
moments in place and returns the new state.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


def zeros_like_tree(params: Tree, dtype=None) -> Tree:
    return {l: {w: torch.zeros_like(t, dtype=dtype or t.dtype)
                for w, t in ws.items()} for l, ws in params.items()}


def bias_corrections(b1: float, b2: float, count: int):
    """(1 - b1**count, 1 - b2**count) in f32, as optax computes them."""
    c = np.float32(count)
    one = np.float32(1.0)
    return (float(one - np.float32(b1) ** c), float(one - np.float32(b2) ** c))


class Optimizer:
    def init_state(self, params: Tree) -> Dict[str, Any]:
        raise NotImplementedError

    def update(self, grads: Tree, state: Dict[str, Any],
               params: Tree) -> Dict[str, Any]:
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    def __init__(self, ffmodel=None, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def init_state(self, params: Tree) -> Dict[str, Any]:
        return {"trace": zeros_like_tree(params)} if self.momentum else {}

    @torch.no_grad()
    def update(self, grads, state, params):
        m, wd = self.momentum, self.weight_decay
        for l, ws in params.items():
            for w, p in ws.items():
                g = grads[l][w].float()
                if wd:
                    g = g + wd * p
                if m:
                    t = state["trace"][l][w]
                    t_new = g + m * t
                    g = g + m * t_new if self.nesterov else t_new
                    t.copy_(t_new)
                p.add_(g * -self.lr)
        return state


class AdamOptimizer(Optimizer):
    """state_dtype: the dtype the moments are STORED in ("float32", or
    "bfloat16" to halve optimizer-state memory and traffic; the update
    math stays f32)."""

    _STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def __init__(self, ffmodel=None, alpha: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 0.0,
                 epsilon: float = 1e-8, state_dtype: str = "float32"):
        self.alpha = alpha
        self.beta1 = beta1
        self.beta2 = beta2
        self.weight_decay = weight_decay
        self.epsilon = epsilon
        self.state_dtype = state_dtype

    def moment_dtype(self) -> torch.dtype:
        sd = self.state_dtype or "float32"
        if sd not in self._STATE_DTYPES:
            raise ValueError(f"state_dtype={self.state_dtype!r} not supported "
                             f"(choose from {tuple(self._STATE_DTYPES)})")
        return self._STATE_DTYPES[sd]

    def init_state(self, params: Tree) -> Dict[str, Any]:
        md = self.moment_dtype()
        return {"count": 0, "mu": zeros_like_tree(params, md),
                "nu": zeros_like_tree(params, md)}

    @torch.no_grad()
    def update(self, grads, state, params):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        count = state["count"] + 1
        bc1, bc2 = bias_corrections(b1, b2, count)
        for l, ws in params.items():
            for w, p in ws.items():
                g = grads[l][w].float()
                mu_s, nu_s = state["mu"][l][w], state["nu"][l][w]
                mu = (1 - b1) * g + b1 * mu_s.float()
                nu = (1 - b2) * (g * g) + b2 * nu_s.float()
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                if self.weight_decay:
                    u = u + self.weight_decay * p
                p.add_(u * -self.alpha)
                mu_s.copy_(mu)
                nu_s.copy_(nu)
        return dict(state, count=count)
