"""Fused sparse cross-entropy: the gate and the plain version
(counterpart: flexflow_tpu/kernels/fused_ce.py).

The JAX package computes the sparse-CE loss blockwise over the vocab with
two Pallas TPU kernels, `_forward` -> `_fwd_kernel` (online logsumexp, per
row loss and lse) and `_backward` -> `_bwd_kernel` (dX = g (softmax -
onehot)), so the step never holds an f32 copy of the [B, S, vocab] logits.
Their CUDA ports are not written yet (the next slice): `fused_cross_entropy`
runs its plain version on CPU tensors and raises on CUDA tensors. The gate
is the JAX one, copied: at GPT-2's vocab of 50257 `_pick_blocks` finds no
vocab block (it needs vocab % 128 == 0), so `use_fused_ce` refuses and the
loss goes through `losses.compute_loss`, as it does in JAX.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.losses import LossType

_ROW_BLOCKS = (256, 128, 64, 32, 16, 8)
_VOCAB_BLOCKS = (2048, 1024, 512, 256, 128)
_VMEM_TILE_BYTES = 512 * 1024
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}


def _pick_blocks(n: int, v: int, itemsize: int):
    """Largest (row, vocab) blocks dividing (n, v) under the tile budget,
    or None when no pairing qualifies."""
    bn = next((b for b in _ROW_BLOCKS if n % b == 0), None)
    if bn is None:
        return None
    bv = next((b for b in _VOCAB_BLOCKS
               if v % b == 0 and bn * b * itemsize <= _VMEM_TILE_BYTES), None)
    if bv is None:
        return None
    return bn, bv


def fused_ce_supported(shape, dtype) -> bool:
    """Whether the fused kernels cover logits of this shape/dtype."""
    if dtype not in _ITEMSIZE or len(shape) < 2:
        return False
    v = int(shape[-1])
    n = 1
    for s in shape[:-1]:
        n *= int(s)
    return n > 0 and v > 0 and _pick_blocks(n, v, _ITEMSIZE[dtype]) is not None


def use_fused_ce(loss_type, logits, mode: str,
                 enable_fusion: bool = True) -> bool:
    """The compile-time gate: cfg.fused_loss x loss type x shape precheck."""
    if mode == "off":
        return False
    if LossType.from_any(loss_type) is not \
            LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
        if mode == "on":
            raise ValueError(
                f"--fused-loss=on requires sparse_categorical_crossentropy "
                f"(got {loss_type})")
        return False
    ok = fused_ce_supported(tuple(logits.shape), logits.dtype)
    if mode == "on":
        if not ok:
            raise ValueError(
                f"--fused-loss=on but logits {tuple(logits.shape)} "
                f"{logits.dtype} don't qualify (need rows % 8 == 0, "
                f"vocab % 128 == 0, f32/bf16)")
        return True
    return ok and enable_fusion


def _plain(x2, y2):
    """Mean over rows of lse(x) - x[label], in f32 from native-dtype
    logits (what `_fwd_kernel` computes; autograd gives `_bwd_kernel`'s
    g/N (softmax - onehot) in the logits' dtype)."""
    xf = x2.float()
    lse = torch.logsumexp(xf, dim=-1)
    picked = xf.gather(-1, y2[:, None]).squeeze(-1)
    return (lse - picked).mean()


def fused_cross_entropy(logits, labels) -> torch.Tensor:
    """Mean sparse cross-entropy over all leading dims of `logits`
    ([..., vocab], f32 or bf16) against integer `labels`."""
    if not fused_ce_supported(tuple(logits.shape), logits.dtype):
        raise ValueError(f"fused_cross_entropy: unsupported logits "
                         f"{tuple(logits.shape)} {logits.dtype}")
    dev = logits.device.type
    if dev == "cuda":
        raise NotImplementedError(
            "the fused cross-entropy kernels (TPU kernels #5 _fwd_kernel and "
            "#6 _bwd_kernel) are not ported to CUDA yet; pass "
            "fused_loss='off' to take the f32 loss of losses.compute_loss")
    if dev != "cpu":
        raise ValueError(f"fused cross-entropy runs on cuda or cpu, not {dev}")
    v = logits.shape[-1]
    return _plain(logits.reshape(-1, v), labels.reshape(-1).long())
