"""GPT-2-style LM with the Unity search over a hybrid mesh (BASELINE config
#5; counterpart: examples/native/transformer_lm.py; reference analog:
examples/cpp/Transformer/transformer.cc + the OSDI'22 bert.sh harness). On
the GPU; FLEXFLOW_PLATFORM=cpu runs it on the CPU. A mesh needs one process
a GPU (torchrun), or `--mesh data=1` on one card:

    python -m flexflow_tpu_torch -b 8 --budget 32 --mesh data=2,model=4 \
        flexflow_tpu_torch/examples/native/transformer_lm.py
"""

import numpy as np

from flexflow_tpu_torch import AdamOptimizer, FFModel, get_launch_config
from flexflow_tpu_torch.models import GPT2Config, build_gpt2


def main():
    cfg = get_launch_config()
    batch = cfg.batch_size
    gcfg = GPT2Config.tiny(seq=128)
    model = FFModel(cfg)
    build_gpt2(model, gcfg, batch=batch)
    cm = model.compile(AdamOptimizer(alpha=1e-3),
                       loss_type="sparse_categorical_crossentropy",
                       metrics=[])
    print("strategy:", cm.strategy.name)
    rng = np.random.default_rng(0)
    n = batch * 4
    ids = rng.integers(0, gcfg.vocab, size=(n, gcfg.seq)).astype(np.int32)
    pos = np.tile(np.arange(gcfg.seq, dtype=np.int32), (n, 1))
    labels = rng.integers(0, gcfg.vocab, size=(n, gcfg.seq)).astype(np.int32)
    hist = cm.fit([ids, pos], labels, epochs=cfg.epochs, verbose=True)
    print(f"FINAL loss={hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
