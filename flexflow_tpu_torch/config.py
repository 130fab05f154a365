"""Run configuration (counterpart: flexflow_tpu/config.py).

Only the fields the serving and training slices read are here; their
names, defaults and command-line flags match the JAX package's `FFConfig`,
so a command line that configures one package configures the other the
same way.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class FFConfig:
    epochs: int = 1
    batch_size: int = 64
    seq_length: int = 0
    seed: int = 0
    # --fusion: False keeps the hand-written attention kernels off (the
    # plain PyTorch attention runs instead)
    enable_fusion: bool = True
    compute_dtype: str = "float32"  # "bfloat16" enables the mixed policy
    # serving knobs (compile_serving reads them when no explicit arg is given)
    max_decode_len: int = 0
    kv_page_size: int = 16
    max_batch_slots: int = 8
    #   kv_cache_dtype — paged-KV storage dtype: "auto" follows
    #                    compute_dtype, "bf16" forces bf16 pools, "int8"
    #                    stores int8 pools with per-(entry, head) f32 scales
    kv_cache_dtype: str = "auto"
    # training loop (compiler/compile.py): fit reads the loss to the host
    # every sync_every updates (0 = at epoch end only); accum_steps N > 1
    # makes every update one over N microbatches (fit(accum_steps=)
    # overrides it per call)
    sync_every: int = 0
    accum_steps: int = 1
    # fused kernels of the train step: "auto" takes the kernel where the
    # gate admits the shape and fusion is on, "on" forces it (raising where
    # it does not qualify), "off" never fuses.
    #   fused_loss      - fused sparse cross-entropy (kernels/fused_ce.py)
    #   fused_optimizer - fused optimizer update (kernels/fused_optim.py)
    fused_loss: str = "auto"
    fused_optimizer: str = "auto"

    @staticmethod
    def build_parser() -> argparse.ArgumentParser:
        p = argparse.ArgumentParser("flexflow_tpu_torch", allow_abbrev=False)
        p.add_argument("-e", "--epochs", type=int, default=1)
        p.add_argument("-b", "--batch-size", type=int, default=64)
        p.add_argument("--seq-length", type=int, default=0)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--fusion", dest="fusion", action="store_true",
                       default=True)
        p.add_argument("--no-fusion", dest="fusion", action="store_false")
        p.add_argument("--compute-dtype", type=str, default="float32")
        p.add_argument("--max-decode-len", type=int, default=0)
        p.add_argument("--kv-page-size", type=int, default=16)
        p.add_argument("--max-batch-slots", type=int, default=8)
        p.add_argument("--kv-cache-dtype", type=str, default="auto",
                       choices=("auto", "bf16", "int8"))
        p.add_argument("--sync-every", type=int, default=0)
        p.add_argument("--accum-steps", type=int, default=1)
        p.add_argument("--fused-loss", type=str, default="auto",
                       choices=("auto", "on", "off"))
        p.add_argument("--fused-optimizer", type=str, default="auto",
                       choices=("auto", "on", "off"))
        return p

    @staticmethod
    def parse_args(argv: Optional[List[str]] = None) -> "FFConfig":
        args, _ = FFConfig.build_parser().parse_known_args(argv)
        return FFConfig(
            epochs=args.epochs,
            batch_size=args.batch_size,
            seq_length=args.seq_length,
            seed=args.seed,
            enable_fusion=args.fusion,
            compute_dtype=args.compute_dtype,
            max_decode_len=args.max_decode_len,
            kv_page_size=args.kv_page_size,
            max_batch_slots=args.max_batch_slots,
            kv_cache_dtype=args.kv_cache_dtype,
            sync_every=args.sync_every,
            accum_steps=args.accum_steps,
            fused_loss=args.fused_loss,
            fused_optimizer=args.fused_optimizer,
        )
