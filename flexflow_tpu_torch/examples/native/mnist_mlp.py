"""Native-API MLP (counterpart: examples/native/mnist_mlp.py; reference
analog: examples/python/native/mnist_mlp.py) — also the launcher demo:

    python -m flexflow_tpu_torch -b 64 -e 2 \
        flexflow_tpu_torch/examples/native/mnist_mlp.py

The launcher parses the FFConfig flags; the script reads them via
flexflow_tpu_torch.get_launch_config() (the flexflow_top pattern: the
runtime owns argv, the script owns the model). It trains on the GPU;
FLEXFLOW_PLATFORM=cpu runs it on the CPU."""

import numpy as np

from flexflow_tpu_torch import FFModel, SGDOptimizer, get_launch_config
from flexflow_tpu_torch.keras.datasets import mnist


def main():
    cfg = get_launch_config()
    batch = cfg.batch_size
    (x, y), (xt, yt) = mnist.load_data(num_samples=8192)
    x = (x.reshape(x.shape[0], -1).astype(np.float32) / 255.0) - 0.5
    xt = (xt.reshape(xt.shape[0], -1).astype(np.float32) / 255.0) - 0.5
    y = y.reshape(-1).astype(np.int32)
    yt = yt.reshape(-1).astype(np.int32)

    model = FFModel(cfg)
    inp = model.create_tensor([batch, x.shape[1]], name="pixels")
    h = model.dense(inp, 256, activation="relu", name="fc1")
    h = model.dense(h, 128, activation="relu", name="fc2")
    model.dense(h, 10, name="head")
    model.compile(SGDOptimizer(lr=cfg.learning_rate),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    hist = model.fit(x, y, epochs=cfg.epochs, verbose=True)
    ev = model.eval(xt, yt)
    print(f"FINAL loss={hist[-1]['loss']:.4f} "
          f"test_accuracy={ev.get('accuracy', 0.0):.4f}")
    return hist, ev


if __name__ == "__main__":
    main()
