"""AlexNet (counterpart: flexflow_tpu/models/alexnet.py): BASELINE.md's
config #1. `build_alexnet` is the ImageNet network (5 convs, 3 pools, two
4096-wide dense layers with dropout 0.5, 1000 classes at 224x224);
`build_alexnet_cifar10` the bootcamp CIFAR-10 CNN (4 convs, 2 pools, 512,
10 classes at 32x32)."""

from __future__ import annotations

from flexflow_tpu_torch.core.model import FFModel


def build_alexnet(model: FFModel, batch: int = 64, in_hw: int = 224,
                  channels: int = 3, classes: int = 1000):
    x = model.create_tensor([batch, channels, in_hw, in_hw], name="image")
    t = model.conv2d(x, 64, 11, 11, 4, 4, 2, 2, activation="relu", name="conv1")
    t = model.pool2d(t, 3, 3, 2, 2, name="pool1")
    t = model.conv2d(t, 192, 5, 5, 1, 1, 2, 2, activation="relu", name="conv2")
    t = model.pool2d(t, 3, 3, 2, 2, name="pool2")
    t = model.conv2d(t, 384, 3, 3, 1, 1, 1, 1, activation="relu", name="conv3")
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation="relu", name="conv4")
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation="relu", name="conv5")
    t = model.pool2d(t, 3, 3, 2, 2, name="pool5")
    t = model.flat(t)
    t = model.dense(t, 4096, activation="relu", name="fc6")
    t = model.dropout(t, 0.5)
    t = model.dense(t, 4096, activation="relu", name="fc7")
    t = model.dropout(t, 0.5)
    out = model.dense(t, classes, name="fc8")
    return x, out


def build_alexnet_cifar10(model: FFModel, batch: int = 64):
    """The bootcamp CIFAR-10 CNN (reference: bootcamp_demo/keras_cnn_cifar10.py)."""
    x = model.create_tensor([batch, 3, 32, 32], name="image")
    t = model.conv2d(x, 32, 3, 3, 1, 1, 1, 1, activation="relu", name="conv1")
    t = model.conv2d(t, 32, 3, 3, 1, 1, 1, 1, activation="relu", name="conv2")
    t = model.pool2d(t, 2, 2, 2, 2, name="pool1")
    t = model.conv2d(t, 64, 3, 3, 1, 1, 1, 1, activation="relu", name="conv3")
    t = model.conv2d(t, 64, 3, 3, 1, 1, 1, 1, activation="relu", name="conv4")
    t = model.pool2d(t, 2, 2, 2, 2, name="pool2")
    t = model.flat(t)
    t = model.dense(t, 512, activation="relu", name="fc1")
    out = model.dense(t, 10, name="fc2")
    return x, out
