"""Expert strategy templates: hand-written overlays for common patterns
(counterpart: flexflow_tpu/parallel/templates.py).

Megatron tensor parallelism: a column-sharded MLP up projection feeding a
row-sharded down projection, and head-parallel attention; a DLRM-style
table sharded over entries or features (`apply_sharded_embedding`); expert
parallelism over an "expert" axis (`apply_expert_parallel`). They are the
anchors the search is compared with: `megatron_strategy` lays a GPT-2
style graph out the Megatron way over one axis, and
`search.optimize.strategy_cost` prices it on the same cost model the
search ranks by.
"""

from __future__ import annotations

from typing import Sequence

from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.parallel.sharding import Strategy


def apply_tensor_parallel_linear_pair(strategy: Strategy, up_layer, down_layer,
                                      axis: str = "model"):
    """Megatron MLP pattern: up kernel column-sharded, down kernel row-sharded.
    The intermediate activation is sharded on its feature dim; one
    all-reduce follows the down matmul (the Reduction parallel op of
    reference P2)."""
    up, down = strategy.op_shardings[up_layer.name], strategy.op_shardings[down_layer.name]
    up.weights["kernel"] = [None, axis]
    if "bias" in up_layer.weight_specs:
        up.weights["bias"] = [axis]
    if up.outputs:
        dims = list(up.outputs[0])
        dims[-1] = axis
        up.outputs[0] = dims
    down.weights["kernel"] = [axis, None]
    if "bias" in down_layer.weight_specs:
        down.weights["bias"] = [None]


def apply_tensor_parallel_attention(strategy: Strategy, mha_layer, axis: str = "model"):
    """Head-parallel attention (reference: create_partition_attention_combine,
    substitution.cc:1763-1770): shard qkv projections on the head (output)
    dim, out-projection on its input dim."""
    sh = strategy.op_shardings[mha_layer.name]
    for w in ("wq", "wk", "wv"):
        sh.weights[w] = [None, axis]
    for b in ("bq", "bk", "bv"):
        if b in mha_layer.weight_specs:
            sh.weights[b] = [axis]
    sh.weights["wo"] = [axis, None]
    if "bo" in mha_layer.weight_specs:
        sh.weights["bo"] = [None]


def apply_sharded_embedding(strategy: Strategy, emb_layer, axis: str = "model",
                            dim: int = 0):
    """Attribute-parallel embedding: the table sharded over its entries
    (dim 0) or its features (dim 1)."""
    sh = strategy.op_shardings[emb_layer.name]
    dims = [None, None]
    dims[dim] = axis
    sh.weights["kernel"] = dims


def apply_expert_parallel(strategy: Strategy, layers: Sequence,
                          axis: str = "expert"):
    """Expert parallelism: the group_by dispatch buffers, the expert
    weights and the expert outputs sharded over the expert dim (all-to-alls
    at the dispatch and the combine once the port runs on several GPUs)."""
    for layer in layers:
        sh = strategy.op_shardings[layer.name]
        if layer.op_type is OperatorType.GROUP_BY:
            nd0 = len(layer.outputs[0].spec.shape)
            sh.outputs[0] = [axis] + [None] * (nd0 - 1)
        elif layer.op_type is OperatorType.EXPERTS:
            sh.weights["kernel"] = [axis, None, None]
            if "bias" in layer.weight_specs:
                sh.weights["bias"] = [axis, None]
            sh.outputs[0] = [axis, None, None]


def megatron_strategy(model, machine, axis: str = "model") -> Strategy:
    """Data parallel over the batch axes plus Megatron tensor parallelism
    over `axis`: every attention head-parallel, and every linear whose only
    consumer is another linear taken as an (up, down) MLP pair."""
    from flexflow_tpu_torch.parallel.default_strategy import \
        data_parallel_strategy

    st = data_parallel_strategy(model, machine)
    st.name = f"megatron:{axis}"
    consumers = {}
    for layer in model.layers:
        for t in layer.inputs:
            if t.owner is not None:
                consumers.setdefault(t.owner.name, []).append(layer)
    for layer in topo_order(model.layers):
        if layer.op_type is OperatorType.MULTIHEAD_ATTENTION:
            apply_tensor_parallel_attention(st, layer, axis)
        elif layer.op_type is OperatorType.LINEAR:
            cons = consumers.get(layer.name, [])
            if len(cons) == 1 and cons[0].op_type is OperatorType.LINEAR:
                apply_tensor_parallel_linear_pair(st, layer, cons[0], axis)
    return st
