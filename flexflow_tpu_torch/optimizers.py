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
Adam `{"count": tensor, "mu": tree, "nu": tree}`, SGD with momentum
`{"trace": tree}`, plain SGD `{}`. `update` writes the params, the
moments and Adam's count in place and returns the state.

Adam's count lives on the device (a 0-dim int32, JAX's type) and the
bias corrections 1 - b**count are computed there in f32
(`device_bias_corrections`): the host reads nothing and copies nothing
in a step, so a CUDA graph of K steps replays each step's own
corrections. `bias_corrections` is the host's numpy reference of the
same f32 values.
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


def step_count(state: Dict[str, Any], device) -> torch.Tensor:
    """Adam's count as a 0-dim int32 on `device`, put there once (a state
    carried from elsewhere may hold an int)."""
    c = state["count"]
    if not isinstance(c, torch.Tensor) or c.device != torch.device(device):
        c = torch.tensor(int(c), dtype=torch.int32, device=device)
        state["count"] = c
    return c


def device_bias_corrections(b1: float, b2: float, count: torch.Tensor,
                            cache: Dict[Any, torch.Tensor]) -> torch.Tensor:
    """(1 - b1**count, 1 - b2**count) as a (2,) f32 on the count's device:
    f32 pow of the f32 betas, then an f32 subtraction, as
    `bias_corrections`. `cache` keeps the betas' device tensor (made once,
    outside any graph capture)."""
    bases = cache.get(count.device)
    if bases is None:
        bases = cache[count.device] = torch.tensor(
            [b1, b2], dtype=torch.float32).to(count.device)
    return 1 - torch.pow(bases, count.float())


class Optimizer:
    def init_state(self, params: Tree) -> Dict[str, Any]:
        raise NotImplementedError

    def moment_count(self) -> int:
        """Per-param moment tensors the state carries (the checkpoint
        fingerprint's optimizer schema, and the search's memory model)."""
        return 2

    def moment_itemsize(self) -> int:
        """Bytes per element of a stored moment (the search's memory
        model, search/cost_model.py OptMemSpec)."""
        return 4

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

    def moment_count(self) -> int:
        return 1 if self.momentum else 0  # the momentum trace

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
        self._bases: Dict[Any, torch.Tensor] = {}  # device_bias_corrections

    def moment_dtype(self) -> torch.dtype:
        sd = self.state_dtype or "float32"
        if sd not in self._STATE_DTYPES:
            raise ValueError(f"state_dtype={self.state_dtype!r} not supported "
                             f"(choose from {tuple(self._STATE_DTYPES)})")
        return self._STATE_DTYPES[sd]

    def moment_itemsize(self) -> int:
        return self.moment_dtype().itemsize

    def init_state(self, params: Tree) -> Dict[str, Any]:
        md = self.moment_dtype()
        dev = next((t.device for ws in params.values() for t in ws.values()),
                   torch.device("cpu"))
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": zeros_like_tree(params, md),
                "nu": zeros_like_tree(params, md)}

    @torch.no_grad()
    def update(self, grads, state, params):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        dev = next(t.device for ws in params.values() for t in ws.values())
        count = step_count(state, dev).add_(1)
        sc = device_bias_corrections(b1, b2, count, self._bases)
        bc1, bc2 = sc[0], sc[1]
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
        return state
