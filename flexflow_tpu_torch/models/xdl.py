"""XDL, an ads-CTR model (counterpart: flexflow_tpu/models/xdl.py; an
OSDI'22 Unity benchmark): sum-pooled embedding tables (1M entries x 64 by
default) and a dense feature input, concatenated into a top MLP with a
2-way head."""

from __future__ import annotations

from typing import List, Sequence, Tuple

from flexflow_tpu_torch.core.model import FFModel
from flexflow_tpu_torch.dtype import DataType


def build_xdl(model: FFModel, batch: int = 64,
              embedding_size: Sequence[int] = (1_000_000,) * 4,
              sparse_feature_size: int = 64,
              embedding_bag_size: int = 1,
              dense_dim: int = 64,
              mlp_top: Sequence[int] = (256, 256, 256, 2)) -> Tuple[List, object]:
    inputs = []
    embs = []
    for ti, entries in enumerate(embedding_size):
        ids = model.create_tensor([batch, embedding_bag_size], DataType.INT32,
                                  name=f"xdl_sparse_{ti}")
        inputs.append(ids)
        embs.append(model.embedding(ids, entries, sparse_feature_size,
                                    aggr="sum", name=f"xdl_emb_{ti}"))
    dense = model.create_tensor([batch, dense_dim], name="xdl_dense")
    inputs.append(dense)
    t = model.concat(embs + [dense], axis=-1, name="xdl_concat")
    for li, h in enumerate(mlp_top[:-1]):
        t = model.dense(t, h, activation="relu", name=f"xdl_top_{li}")
    out = model.dense(t, mlp_top[-1], name="xdl_head")
    return inputs, out
