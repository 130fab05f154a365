"""AlexNet / CIFAR-10 via the Keras functional API — BASELINE config #1
(counterpart: examples/keras/func_cifar10_alexnet.py).

Reference analog: examples/python/keras/func_cifar10_alexnet.py (same layer
stack: 5 conv + 3 pool + 2 fc-4096 + softmax head at 229x229 input). Images
are upsampled from 32x32 to 229x229 like the reference (which used PIL; here
a nearest-neighbor numpy upsample, no PIL dependency).

Run:  python -m flexflow_tpu_torch \
          flexflow_tpu_torch/examples/keras/func_cifar10_alexnet.py \
          [--samples N] [--epochs E] [--batch-size B]
on the GPU, or on the CPU with FLEXFLOW_PLATFORM=cpu. On hosts without the
CIFAR-10 npz, deterministic synthetic data is used.
"""

import argparse

import numpy as np

import flexflow_tpu_torch.keras.optimizers as opt
from flexflow_tpu_torch.keras.callbacks import EpochVerifyMetrics, VerifyMetrics
from flexflow_tpu_torch.keras.datasets import cifar10
from flexflow_tpu_torch.keras.layers import (
    Activation,
    Conv2D,
    Dense,
    Flatten,
    Input,
    MaxPooling2D,
)
from flexflow_tpu_torch.keras.models import Model


def build_alexnet(num_classes: int = 10):
    input_tensor = Input(shape=(3, 229, 229), dtype="float32")
    x = Conv2D(filters=64, kernel_size=(11, 11), strides=(4, 4),
               padding=(2, 2), activation="relu")(input_tensor)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2), padding="valid")(x)
    x = Conv2D(filters=192, kernel_size=(5, 5), strides=(1, 1),
               padding=(2, 2), activation="relu")(x)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2), padding="valid")(x)
    x = Conv2D(filters=384, kernel_size=(3, 3), strides=(1, 1),
               padding=(1, 1), activation="relu")(x)
    x = Conv2D(filters=256, kernel_size=(3, 3), strides=(1, 1),
               padding=(1, 1), activation="relu")(x)
    x = Conv2D(filters=256, kernel_size=(3, 3), strides=(1, 1),
               padding=(1, 1), activation="relu")(x)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2), padding="valid")(x)
    x = Flatten()(x)
    x = Dense(4096, activation="relu")(x)
    x = Dense(4096, activation="relu")(x)
    x = Dense(num_classes)(x)
    out = Activation("softmax")(x)
    return Model(input_tensor, out)


def upsample_nearest(x: np.ndarray, size: int) -> np.ndarray:
    """(N, C, 32, 32) uint8 -> (N, C, size, size) float32 nearest-neighbor."""
    n, c, h, w = x.shape
    ih = (np.arange(size) * h // size).astype(np.int32)
    iw = (np.arange(size) * w // size).astype(np.int32)
    return x[:, :, ih[:, None], iw[None, :]].astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    args = ap.parse_args()

    (x_train, y_train), _ = cifar10.load_data(args.samples)
    full_input = upsample_nearest(x_train, 229) / 255.0
    full_label = y_train.astype("int32").reshape(-1)

    model = build_alexnet()
    model.compile(optimizer=opt.SGD(learning_rate=0.01),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy", "sparse_categorical_crossentropy"])
    print(model.summary())
    model.fit(full_input, full_label, batch_size=args.batch_size,
              epochs=args.epochs, callbacks=[EpochVerifyMetrics(0.0)])


if __name__ == "__main__":
    main()
