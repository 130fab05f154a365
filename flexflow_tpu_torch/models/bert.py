"""BERT encoder (counterpart: flexflow_tpu/models/bert.py): BASELINE.md's
config #3, the BERT-base pretraining proxy.

Token and position embeddings, their sum layer-normed, `layers` encoder
blocks (models/transformer.py) and an MLM head over the vocab. `dropout`
is the blocks' attention dropout, 0.1 as the JAX build has it (where it
is `transformer_block`'s default); at 0 the attention takes the flash
kernels, under dropout the einsum path, as in JAX.
"""

from __future__ import annotations

from flexflow_tpu_torch.core.model import FFModel
from flexflow_tpu_torch.dtype import DataType
from flexflow_tpu_torch.models.transformer import transformer_block


def build_bert(model: FFModel, batch: int = 8, seq: int = 512,
               vocab: int = 30522, d_model: int = 768, heads: int = 12,
               layers: int = 12, d_ff: int = 3072, dropout: float = 0.1):
    ids = model.create_tensor([batch, seq], DataType.INT32, name="input_ids")
    pos = model.create_tensor([batch, seq], DataType.INT32,
                              name="position_ids")
    tok = model.embedding(ids, vocab, d_model, name="tok_emb")
    pe = model.embedding(pos, seq, d_model, name="pos_emb")
    t = model.layer_norm(model.add(tok, pe), name="emb_ln")
    for i in range(layers):
        t = transformer_block(model, t, d_model, heads, d_ff, f"enc{i}",
                              dropout=dropout)
    logits = model.dense(t, vocab, name="mlm_head")
    return (ids, pos), logits
