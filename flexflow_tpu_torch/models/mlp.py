"""MLP (counterpart: flexflow_tpu/models/mlp.py): relu dense layers of
the `hidden` widths and a `classes`-wide output."""

from __future__ import annotations

from typing import Sequence

from flexflow_tpu_torch.core.model import FFModel


def build_mlp(model: FFModel, batch: int, in_dim: int,
              hidden: Sequence[int] = (512, 512), classes: int = 10):
    x = model.create_tensor([batch, in_dim], name="x")
    h = x
    for i, hdim in enumerate(hidden):
        h = model.dense(h, hdim, activation="relu", name=f"mlp_h{i}")
    out = model.dense(h, classes, name="mlp_out")
    return x, out
