"""Hand-written CUDA kernels (sources in ../csrc) and their plain versions.

Each module holds one kernel's wrapper, its plain PyTorch version and its
launch counter (`launches`). The two ring programs (ring_attention.py,
collective_matmul.py) run on those kernels and count their own calls.
Nothing is built or loaded at import time.
"""


def launch_counts():
    """Every kernel wrapper's launch counter, by the kernel's name."""
    from flexflow_tpu_torch.kernels import collective_matmul as cm
    from flexflow_tpu_torch.kernels import dequant_attention as da
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_ce as fc
    from flexflow_tpu_torch.kernels import fused_optim as fo
    from flexflow_tpu_torch.kernels import ring_attention as ra
    return {"flash_attention_fwd": fa.launches,
            "flash_attention_dq": fa.launches_dq,
            "flash_attention_dkv": fa.launches_dkv,
            "dequant_decode_attention": da.launches,
            "fused_adam": fo.launches,
            "fused_ce_fwd": fc.launches_fwd,
            "fused_ce_bwd": fc.launches_bwd,
            "fused_sgd": fo.launches_sgd,
            "fused_sgd_plain": fo.launches_sgd_plain,
            "ring_attention": ra.launches,
            "collective_matmul": cm.launches}
