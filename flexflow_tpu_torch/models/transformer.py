"""Transformer encoder stack (counterpart: flexflow_tpu/models/transformer.py).

Attention and a 2-layer relu FFN per block, each followed by a residual
add and a post-LN, as the reference's Transformer example builds it. The
build is the JAX package's, layer for layer, so params transfer by
(layer, weight) name.
"""

from __future__ import annotations

from flexflow_tpu_torch.core.model import FFModel


def transformer_block(model: FFModel, t, d_model: int, heads: int, d_ff: int,
                      name: str, dropout: float = 0.1, causal: bool = False):
    att = model.multihead_attention(t, t, t, d_model, heads, dropout=dropout,
                                    causal=causal, name=f"{name}_mha")
    t = model.layer_norm(model.add(att, t), name=f"{name}_ln1")
    up = model.dense(t, d_ff, activation="relu", name=f"{name}_ffn_up")
    down = model.dense(up, d_model, name=f"{name}_ffn_down")
    return model.layer_norm(model.add(down, t), name=f"{name}_ln2")


def build_transformer(model: FFModel, batch: int = 8, seq: int = 512,
                      d_model: int = 512, heads: int = 8, d_ff: int = 2048,
                      layers: int = 6, classes: int = 0,
                      causal: bool = False, dropout: float = 0.1):
    """Raw (batch, seq, d_model) activations in; classes > 0 appends an LM
    head."""
    x = model.create_tensor([batch, seq, d_model], name="x")
    t = x
    for i in range(layers):
        t = transformer_block(model, t, d_model, heads, d_ff, f"blk{i}",
                              dropout=dropout, causal=causal)
    if classes:
        t = model.dense(t, classes, name="lm_head")
    return x, t
