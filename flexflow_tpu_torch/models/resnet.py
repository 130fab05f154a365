"""ResNet-50 (counterpart: flexflow_tpu/models/resnet.py): BASELINE.md's
config #2, bottleneck blocks of conv + batch norm, NCHW.
"""

from __future__ import annotations

from flexflow_tpu_torch.core.model import FFModel


def build_resnet_block(model: FFModel, t, out_c: int, stride: int, name: str,
                       project: bool):
    """Bottleneck: 1x1 -> 3x3 -> 1x1 (x4), residual add + relu."""
    shortcut = t
    u = model.conv2d(t, out_c, 1, 1, 1, 1, 0, 0, name=f"{name}_c1",
                     use_bias=False)
    u = model.batch_norm(u, relu=True, name=f"{name}_bn1")
    u = model.conv2d(u, out_c, 3, 3, stride, stride, 1, 1, name=f"{name}_c2",
                     use_bias=False)
    u = model.batch_norm(u, relu=True, name=f"{name}_bn2")
    u = model.conv2d(u, 4 * out_c, 1, 1, 1, 1, 0, 0, name=f"{name}_c3",
                     use_bias=False)
    u = model.batch_norm(u, relu=False, name=f"{name}_bn3")
    if project:
        shortcut = model.conv2d(shortcut, 4 * out_c, 1, 1, stride, stride, 0,
                                0, name=f"{name}_proj", use_bias=False)
        shortcut = model.batch_norm(shortcut, relu=False, name=f"{name}_bnp")
    return model.relu(model.add(u, shortcut, name=f"{name}_add"))


def build_resnet50(model: FFModel, batch: int = 64, in_hw: int = 224,
                   classes: int = 1000):
    x = model.create_tensor([batch, 3, in_hw, in_hw], name="image")
    t = model.conv2d(x, 64, 7, 7, 2, 2, 3, 3, name="stem", use_bias=False)
    t = model.batch_norm(t, relu=True, name="stem_bn")
    t = model.pool2d(t, 3, 3, 2, 2, 1, 1, name="stem_pool")
    stages = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
    for si, (c, blocks, stride) in enumerate(stages):
        for bi in range(blocks):
            t = build_resnet_block(model, t, c, stride if bi == 0 else 1,
                                   f"s{si}b{bi}", project=(bi == 0))
    # global average pool over H, W
    t = model.mean(t, axes=[2, 3], name="gap")
    out = model.dense(t, classes, name="fc")
    return x, out
