"""Mixture-of-experts MLP (counterpart: flexflow_tpu/models/moe.py): a
relu dense layer, the composite `moe` block (top-k gating over
`num_exp` experts, capacity factor `alpha`) and a classifier head."""

from __future__ import annotations

from flexflow_tpu_torch.core.model import FFModel


def build_moe_mlp(model: FFModel, batch: int = 64, in_dim: int = 784,
                  num_exp: int = 64, num_select: int = 2,
                  hidden: int = 64, classes: int = 10, alpha: float = 2.0):
    x = model.create_tensor([batch, in_dim], name="x")
    t = model.dense(x, hidden, activation="relu", name="pre")
    t = model.moe(t, num_exp=num_exp, num_select=num_select,
                  expert_hidden_size=hidden, alpha=alpha, name="moe")
    out = model.dense(t, classes, name="head")
    return x, out
