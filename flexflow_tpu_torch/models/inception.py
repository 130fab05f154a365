"""Inception-v3 (counterpart: flexflow_tpu/models/inception.py): the
multi-branch concat workload, its stem, three `inception_a` blocks and one
`inception_b`, every conv followed by a batch norm with relu."""

from __future__ import annotations

from flexflow_tpu_torch.core.model import FFModel


def _conv_bn(model, t, c, kh, kw, sh=1, sw=1, ph=0, pw=0, name=""):
    t = model.conv2d(t, c, kh, kw, sh, sw, ph, pw, use_bias=False, name=f"{name}_conv")
    return model.batch_norm(t, relu=True, name=f"{name}_bn")


def inception_a(model, t, pool_c, name):
    b1 = _conv_bn(model, t, 64, 1, 1, name=f"{name}_b1")
    b2 = _conv_bn(model, t, 48, 1, 1, name=f"{name}_b2a")
    b2 = _conv_bn(model, b2, 64, 5, 5, 1, 1, 2, 2, name=f"{name}_b2b")
    b3 = _conv_bn(model, t, 64, 1, 1, name=f"{name}_b3a")
    b3 = _conv_bn(model, b3, 96, 3, 3, 1, 1, 1, 1, name=f"{name}_b3b")
    b3 = _conv_bn(model, b3, 96, 3, 3, 1, 1, 1, 1, name=f"{name}_b3c")
    b4 = model.pool2d(t, 3, 3, 1, 1, 1, 1, pool_type="avg", name=f"{name}_b4p")
    b4 = _conv_bn(model, b4, pool_c, 1, 1, name=f"{name}_b4")
    return model.concat([b1, b2, b3, b4], axis=1, name=f"{name}_cat")


def inception_b(model, t, name):
    b1 = _conv_bn(model, t, 384, 3, 3, 2, 2, name=f"{name}_b1")
    b2 = _conv_bn(model, t, 64, 1, 1, name=f"{name}_b2a")
    b2 = _conv_bn(model, b2, 96, 3, 3, 1, 1, 1, 1, name=f"{name}_b2b")
    b2 = _conv_bn(model, b2, 96, 3, 3, 2, 2, name=f"{name}_b2c")
    b3 = model.pool2d(t, 3, 3, 2, 2, name=f"{name}_b3")
    return model.concat([b1, b2, b3], axis=1, name=f"{name}_cat")


def build_inception_v3(model: FFModel, batch: int = 32, classes: int = 1000):
    x = model.create_tensor([batch, 3, 299, 299], name="image")
    t = _conv_bn(model, x, 32, 3, 3, 2, 2, name="stem1")
    t = _conv_bn(model, t, 32, 3, 3, name="stem2")
    t = _conv_bn(model, t, 64, 3, 3, 1, 1, 1, 1, name="stem3")
    t = model.pool2d(t, 3, 3, 2, 2, name="stem_pool1")
    t = _conv_bn(model, t, 80, 1, 1, name="stem4")
    t = _conv_bn(model, t, 192, 3, 3, name="stem5")
    t = model.pool2d(t, 3, 3, 2, 2, name="stem_pool2")
    t = inception_a(model, t, 32, "mixed0")
    t = inception_a(model, t, 64, "mixed1")
    t = inception_a(model, t, 64, "mixed2")
    t = inception_b(model, t, "mixed3")
    t = model.mean(t, axes=[2, 3], name="gap")
    t = model.dropout(t, 0.5)
    out = model.dense(t, classes, name="fc")
    return x, out
