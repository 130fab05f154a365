"""Hand-written CUDA kernels (sources in ../csrc) and their plain versions.

Each module holds one kernel's wrapper, its plain PyTorch version and its
launch counter (`launches`). Nothing is built or loaded at import time.
"""
