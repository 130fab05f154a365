"""Carry a JAX param tree over to the port.

`params_from_jax(tree)` takes the JAX engine's params as numpy arrays,
`{layer: {weight: np.ndarray}}` (e.g. `jax.device_get(engine.params)`),
and returns the same tree as torch tensors on a given device and dtype.
The layouts are already the same in both packages (dense `kernel` is
`(in, out)`, `wq..wo` are `(in, embed)`), so nothing is transposed.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]],
                    device="cpu", dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """numpy tree -> torch tree. Floating weights become `dtype` when given
    (float32 otherwise, since numpy has no bfloat16); other arrays keep
    their type."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for layer, weights in tree.items():
        d = {}
        for name, arr in weights.items():
            a = np.asarray(arr)
            if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
                t = torch.from_numpy(np.array(a, dtype=np.float32))
                t = t.to(dtype or torch.float32)
            else:
                t = torch.from_numpy(np.array(a))
            d[name] = t.to(device)
        out[layer] = d
    return out
