"""Run configuration (counterpart: flexflow_tpu/config.py).

Only the fields the serving slice reads are here; their names, defaults and
command-line flags match the JAX package's `FFConfig`, so a command line
that configures one package configures the other the same way.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class FFConfig:
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

    @staticmethod
    def build_parser() -> argparse.ArgumentParser:
        p = argparse.ArgumentParser("flexflow_tpu_torch", allow_abbrev=False)
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
        return p

    @staticmethod
    def parse_args(argv: Optional[List[str]] = None) -> "FFConfig":
        args, _ = FFConfig.build_parser().parse_known_args(argv)
        return FFConfig(
            seq_length=args.seq_length,
            seed=args.seed,
            enable_fusion=args.fusion,
            compute_dtype=args.compute_dtype,
            max_decode_len=args.max_decode_len,
            kv_page_size=args.kv_page_size,
            max_batch_slots=args.max_batch_slots,
            kv_cache_dtype=args.kv_cache_dtype,
        )
