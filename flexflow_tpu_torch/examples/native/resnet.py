"""ResNet-50 on synthetic ImageNet-shaped data (BASELINE config #2;
counterpart: examples/native/resnet.py; reference analog:
examples/python/native/resnet.py). On the GPU; FLEXFLOW_PLATFORM=cpu runs
it on the CPU.

    python -m flexflow_tpu_torch -b 16 -e 1 flexflow_tpu_torch/examples/native/resnet.py
"""

import numpy as np

from flexflow_tpu_torch import FFModel, SGDOptimizer, get_launch_config
from flexflow_tpu_torch.models import build_resnet50


def main():
    cfg = get_launch_config()
    batch = cfg.batch_size
    in_hw = 64  # CPU-friendly default; pass -b and edit for full 224
    model = FFModel(cfg)
    build_resnet50(model, batch=batch, in_hw=in_hw, classes=100)
    model.compile(SGDOptimizer(lr=cfg.learning_rate),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    rng = np.random.default_rng(0)
    n = batch * 4
    x = rng.normal(size=(n, 3, in_hw, in_hw)).astype(np.float32)
    y = rng.integers(0, 100, size=(n,)).astype(np.int32)
    hist = model.fit(x, y, epochs=cfg.epochs, verbose=True)
    print(f"FINAL loss={hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
