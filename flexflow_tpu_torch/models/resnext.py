"""ResNeXt-50 32x4d (counterpart: flexflow_tpu/models/resnext.py), the
OSDI'22 workload whose grouped 3x3 conv (cardinality 32) exercises the
search's conv candidates.

The JAX build's quirks are kept: blocks have no residual unless
`has_residual=True` (the reference's stack is plain feedforward), the
projected shortcut carries a relu, and shape-preserving blocks take the
identity shortcut when residuals are on.
"""

from __future__ import annotations

from flexflow_tpu_torch.core.model import FFModel


def resnext_block(model: FFModel, t, stride: int, out_c: int, groups: int,
                  name: str, has_residual: bool = False):
    """1x1 (relu) -> 3x3 grouped (relu) -> 1x1 to 2*out_c; optional
    projected residual."""
    inp = t
    u = model.conv2d(t, out_c, 1, 1, 1, 1, 0, 0, activation="relu",
                     name=f"{name}_c1")
    u = model.conv2d(u, out_c, 3, 3, stride, stride, 1, 1, activation="relu",
                     groups=groups, name=f"{name}_c2")
    u = model.conv2d(u, 2 * out_c, 1, 1, 1, 1, 0, 0, name=f"{name}_c3")
    if has_residual:
        if stride > 1 or inp.shape[1] != 2 * out_c:
            inp = model.conv2d(inp, 2 * out_c, 1, 1, stride, stride, 0, 0,
                               activation="relu", name=f"{name}_proj")
        u = model.relu(model.add(inp, u, name=f"{name}_addres"),
                       name=f"{name}_relu")
    return u


def build_resnext50(model: FFModel, batch: int = 64, in_hw: int = 224,
                    classes: int = 1000, groups: int = 32, width: int = 128,
                    has_residual: bool = False):
    """3/4/6/3 blocks at width 128/256/512/1024, stride 2 entering each
    stage after the first; `width` and `in_hw` scale down for CPU tests."""
    x = model.create_tensor([batch, 3, in_hw, in_hw], name="image")
    t = model.conv2d(x, 64, 7, 7, 2, 2, 3, 3, activation="relu", name="stem")
    t = model.pool2d(t, 3, 3, 2, 2, 1, 1, name="stem_pool")
    stages = [(width, 3, 1), (2 * width, 4, 2), (4 * width, 6, 2),
              (8 * width, 3, 2)]
    for si, (c, blocks, stride) in enumerate(stages):
        for bi in range(blocks):
            t = resnext_block(model, t, stride if bi == 0 else 1, c, groups,
                              f"s{si}b{bi}", has_residual=has_residual)
    t = model.relu(t, name="final_relu")
    t = model.mean(t, axes=[2, 3], name="gap")
    t = model.flat(t, name="flat")
    logits = model.dense(t, classes, name="fc")
    return x, logits
