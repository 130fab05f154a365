"""Carry JAX trees over to the port, and the port's trees back to numpy.

`params_from_jax(tree)` takes the JAX engine's params as numpy arrays,
`{layer: {weight: np.ndarray}}` (e.g. `jax.device_get(engine.params)`),
and returns the same tree as torch tensors on a given device and dtype.
The layouts are already the same in both packages (dense `kernel` is
`(in, out)`, `wq..wo` are `(in, embed)`), so nothing is transposed.

`opt_state_from_jax(opt_state)` takes a JAX optimizer state (after
`jax.device_get`) and returns the port's: the optax `ScaleByAdamState`
(count, mu, nu) becomes `{"count", "mu", "nu"}`, a `TraceState` becomes
`{"trace"}`, and a state with neither (plain SGD) becomes `{}`. It reads
the optax nodes by their fields, so it needs neither optax nor JAX.

`state_from_jax(state)` carries the non-trainable state across (the
batch-norm running stats, `{layer}/mean` and `{layer}/var`).

`params_to_numpy(tree)` is the way back: float32 numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _to_torch(arr, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        t = t.to(dtype or torch.float32)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]],
                    device="cpu", dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """numpy tree -> torch tree. Floating weights become `dtype` when given
    (float32 otherwise, since numpy has no bfloat16); other arrays keep
    their type."""
    return {layer: {name: _to_torch(arr, device, dtype)
                    for name, arr in weights.items()}
            for layer, weights in tree.items()}


def state_from_jax(state: Mapping[str, Any], device="cpu"
                   ) -> Dict[str, torch.Tensor]:
    """The JAX CompiledModel's non-trainable state (after
    `jax.device_get`), a flat `{key: array}` such as the batch-norm
    running stats `{layer}/mean` and `{layer}/var`, as the port's
    `CompiledModel.state`: f32 tensors on `device` (other arrays keep
    their type)."""
    return {k: _to_torch(v, device, None) for k, v in state.items()}


def _find(state, fields):
    """Depth-first search of an optax chain state (nested tuples of
    namedtuples) for the node that has all `fields`."""
    if all(hasattr(state, f) for f in fields):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find(s, fields)
            if found is not None:
                return found
    return None


def _moment_tree(tree, device):
    """A moment tree keeps its stored dtype: bf16 moments stay bf16."""
    return {layer: {name: _to_torch(
        arr, device,
        torch.bfloat16 if np.asarray(arr).dtype.name == "bfloat16"
        else torch.float32) for name, arr in weights.items()}
        for layer, weights in tree.items()}


def opt_state_from_jax(opt_state, device="cpu") -> Dict[str, Any]:
    """JAX optimizer state -> the port's optimizer state."""
    adam = _find(opt_state, ("count", "mu", "nu"))
    if adam is not None:
        return {"count": int(np.asarray(adam.count)),
                "mu": _moment_tree(adam.mu, device),
                "nu": _moment_tree(adam.nu, device)}
    trace = _find(opt_state, ("trace",))
    if trace is not None:
        return {"trace": _moment_tree(trace.trace, device)}
    return {}


def params_to_numpy(tree) -> Dict[str, Dict[str, np.ndarray]]:
    """torch tree -> float32 numpy tree (on the host)."""
    return {layer: {name: t.detach().float().cpu().numpy()
                    for name, t in weights.items()}
            for layer, weights in tree.items()}
