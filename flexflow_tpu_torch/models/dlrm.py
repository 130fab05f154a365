"""DLRM (counterpart: flexflow_tpu/models/dlrm.py): BASELINE.md's config
#4, sum-pooled embedding tables, bottom and top MLPs and the pairwise dot
interaction (the bottom MLP's output and the pooled embeddings stacked,
their batched outer product flattened and concatenated to the bottom
output). The top MLP ends in one sigmoid unit, trained under MSE against
float click labels.
"""

from __future__ import annotations

from typing import Sequence

from flexflow_tpu_torch.core.model import FFModel
from flexflow_tpu_torch.dtype import DataType


def build_dlrm(model: FFModel, batch: int = 64,
               embedding_tables: Sequence[int] = (int(1e5),) * 8,
               embedding_dim: int = 64, dense_dim: int = 13,
               bottom_mlp: Sequence[int] = (512, 256, 64),
               top_mlp: Sequence[int] = (512, 256, 1),
               indices_per_table: int = 1):
    dense = model.create_tensor([batch, dense_dim], name="dense_features")
    sparse_ins, embs = [], []
    for ti, entries in enumerate(embedding_tables):
        ids = model.create_tensor([batch, indices_per_table], DataType.INT32,
                                  name=f"sparse_{ti}")
        sparse_ins.append(ids)
        embs.append(model.embedding(ids, entries, embedding_dim, aggr="sum",
                                    name=f"emb_{ti}"))
    t = dense
    for i, h in enumerate(bottom_mlp):
        t = model.dense(t, h, activation="relu", name=f"bot{i}")
    feats = [t] + embs  # each (batch, embedding_dim)
    n = len(feats)
    stacked = model.concat([model.reshape(f, [batch, 1, embedding_dim])
                            for f in feats], axis=1, name="stack")  # (b, n, d)
    inter = model.batch_matmul(stacked, model.transpose(stacked, [0, 2, 1]),
                               name="interact")  # (b, n, n)
    flat = model.reshape(inter, [batch, n * n], name="inter_flat")
    t = model.concat([t, flat], axis=1, name="combine")
    for i, h in enumerate(top_mlp[:-1]):
        t = model.dense(t, h, activation="relu", name=f"top{i}")
    out = model.dense(t, top_mlp[-1], activation="sigmoid", name="click")
    return [dense] + sparse_ins, out
