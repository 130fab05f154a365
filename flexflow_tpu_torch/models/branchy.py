"""The branch ensemble (counterpart: flexflow_tpu/models/branchy.py):
fork-join modules with congruent branches (the same sub-layer structure,
each with its own activation), the workload where joint inter- and
intra-op search beats op-level templates. `expert_template_pins` gives the
two templates it is compared with."""

from __future__ import annotations

from flexflow_tpu_torch.core.model import FFModel

ACTS = ("relu", "gelu", "tanh", "sigmoid")


def build_branchy(model: FFModel, batch: int = 1024, width: int = 512,
                  hidden: int = 8192, modules: int = 4, k: int = 4):
    """trunk -> [modules x (k-branch fork_join + proj)] -> head."""

    def branch(act):
        def b(bm, x):
            h = bm.dense(x, hidden, activation=act, name="mid")
            return bm.dense(h, width, name="out")
        return b

    x = model.create_tensor([batch, width], name="x")
    t = model.dense(x, width, activation="relu", name="trunk")
    for j in range(modules):
        t = model.fork_join(t, [branch(a) for a in ACTS[:k]], join="add",
                            name=f"fj{j}")
        t = model.dense(t, width, activation="relu", name=f"proj{j}")
    logits = model.dense(t, 10, name="head")
    return x, logits


def expert_template_pins(model: FFModel, template: str):
    """The two expert-template families an intra-op practitioner writes:
    "intra_op" = the STRONGEST op-level-only plan (everything searched,
    fork-joins pinned to replicated execution — no inter-op concept);
    "dp" = pure data parallelism."""
    if template == "intra_op":
        return {l.name: "dp" for l in model.layers if l.name.startswith("fj")}
    if template == "dp":
        return {l.name: "dp" for l in model.layers}
    raise ValueError(f"unknown template {template!r}")
