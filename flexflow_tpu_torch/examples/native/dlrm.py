"""DLRM with auto-searched embedding sharding (BASELINE config #4;
counterpart: examples/native/dlrm.py; reference analog:
examples/cpp/DLRM/dlrm.cc + shipped strategies). On the GPU;
FLEXFLOW_PLATFORM=cpu runs it on the CPU. A mesh needs one process a GPU
(torchrun), or `--mesh data=1` on one card:

    python -m flexflow_tpu_torch -b 256 --budget 16 --mesh data=2,model=4 \
        flexflow_tpu_torch/examples/native/dlrm.py
"""

import numpy as np

from flexflow_tpu_torch import FFModel, SGDOptimizer, get_launch_config
from flexflow_tpu_torch.models import build_dlrm


def main():
    cfg = get_launch_config()
    batch = cfg.batch_size
    tables = (100_000,) * 8
    model = FFModel(cfg)
    ins, out = build_dlrm(model, batch=batch, embedding_tables=tables,
                          embedding_dim=64)
    cm = model.compile(SGDOptimizer(lr=cfg.learning_rate),
                       loss_type="mean_squared_error", metrics=[],
                       outputs=[out])
    print("strategy:", cm.strategy.name)
    for ti in range(0, len(tables), 4):
        print(f"  emb_{ti}:", cm.strategy.sharding_for(f"emb_{ti}"))
    rng = np.random.default_rng(0)
    n = batch * 4
    dense = rng.normal(size=(n, 13)).astype(np.float32)
    sparse = [rng.integers(0, t, size=(n, 1)).astype(np.int32) for t in tables]
    labels = rng.uniform(size=(n, 1)).astype(np.float32)
    hist = cm.fit([dense] + sparse, labels, epochs=cfg.epochs, verbose=True)
    print(f"FINAL loss={hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
