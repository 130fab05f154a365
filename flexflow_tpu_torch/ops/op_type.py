"""Operator vocabulary (counterpart: flexflow_tpu/ops/op_type.py).

The same names and values as the JAX package, so graphs built by either
package compare op for op, and the search's rule list (search/
substitution.py) comes out in the same order with the same indices.
ops/__init__.py registers a lowering only for the ops this package runs;
the rest are names the search and the rule loader refer to.
"""

from __future__ import annotations

import enum


class OperatorType(enum.Enum):
    # anchors
    INPUT = "input"
    WEIGHT = "weight"
    NOOP = "noop"
    # dense / conv family
    CONV2D = "conv2d"
    DROPOUT = "dropout"
    LINEAR = "linear"
    BATCHMATMUL = "batch_matmul"
    POOL2D = "pool2d"
    SCALAR_MULTIPLY = "scalar_multiply"
    SCALAR_ADD = "scalar_add"
    SCALAR_SUB = "scalar_sub"
    SCALAR_TRUE_DIV = "scalar_truediv"
    SCALAR_FLOOR_DIV = "scalar_floordiv"
    # normalization
    BATCHNORM = "batch_norm"
    LAYERNORM = "layer_norm"
    # element binary
    EW_ADD = "add"
    EW_SUB = "subtract"
    EW_MUL = "multiply"
    EW_DIV = "divide"
    EW_MAX = "max"
    EW_MIN = "min"
    EW_EQUAL = "equal"
    EW_GREATER = "greater"
    EW_LESS = "less"
    # element unary
    RELU = "relu"
    IDENTITY = "identity"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    ELU = "elu"
    GELU = "gelu"
    EXP = "exp"
    LOG = "log"
    SIN = "sin"
    COS = "cos"
    SQRT = "sqrt"
    RSQRT = "rsqrt"
    POW = "pow"
    SILU = "silu"
    ERF = "erf"
    # shape / movement
    RESHAPE = "reshape"
    TRANSPOSE = "transpose"
    FLAT = "flat"
    CONCAT = "concat"
    SPLIT = "split"
    REVERSE = "reverse"
    PAD = "pad"
    CAST = "cast"
    GATHER = "gather"
    SLICE = "slice"
    EXPAND = "expand"
    CONSTANT = "constant"
    MASKED_FILL = "masked_fill"
    WHERE = "where"
    # reductions
    REDUCE_SUM = "reduce_sum"
    REDUCE_MEAN = "reduce_mean"
    REDUCE_MAX = "reduce_max"
    REDUCE_MIN = "reduce_min"
    MEAN = "mean"
    ARGMAX = "argmax"
    ARGMIN = "argmin"
    # embeddings / softmax / attention
    EMBEDDING = "embedding"
    SOFTMAX = "softmax"
    LOG_SOFTMAX = "log_softmax"
    MULTIHEAD_ATTENTION = "multihead_attention"
    SDPA = "scaled_dot_product_attention"
    # MoE family (reference: src/ops/{topk,group_by,aggregate,aggregate_spec,cache}.cc)
    TOPK = "topk"
    GROUP_BY = "group_by"
    AGGREGATE = "aggregate"
    AGGREGATE_SPEC = "aggregate_spec"
    CACHE = "cache"
    EXPERTS = "experts"
    # fused compute op (reference: src/ops/fused.cc)
    FUSED = "fused"
    # inter-op placement composite (reference: nonsequence splits,
    # src/runtime/graph.cc:187-321; branches on disjoint device subsets)
    FORK_JOIN = "fork_join"
    # parallel ops (reference: src/parallel_ops/)
    REPARTITION = "repartition"
    COMBINE = "combine"
    REPLICATE = "replicate"
    REDUCTION = "reduction"
    ALLTOALL = "all_to_all"
    FUSED_PARALLEL = "fused_parallel"
    PIPELINE = "pipeline"
    # loss-side
    CROSS_ENTROPY = "cross_entropy"
    MSE = "mse"

    def __repr__(self):  # terse for debug output
        return self.value


# Ops that carry trainable weights.
WEIGHTED_OPS = frozenset(
    {
        OperatorType.CONV2D,
        OperatorType.LINEAR,
        OperatorType.EMBEDDING,
        OperatorType.BATCHNORM,
        OperatorType.LAYERNORM,
        OperatorType.MULTIHEAD_ATTENTION,
        OperatorType.EXPERTS,
        OperatorType.FORK_JOIN,
    }
)

# Pure elementwise unary ops sharing one lowering path.
UNARY_OPS = frozenset(
    {
        OperatorType.RELU,
        OperatorType.IDENTITY,
        OperatorType.SIGMOID,
        OperatorType.TANH,
        OperatorType.ELU,
        OperatorType.GELU,
        OperatorType.EXP,
        OperatorType.LOG,
        OperatorType.SIN,
        OperatorType.COS,
        OperatorType.SQRT,
        OperatorType.RSQRT,
        OperatorType.POW,
        OperatorType.SILU,
        OperatorType.ERF,
        OperatorType.SCALAR_MULTIPLY,
        OperatorType.SCALAR_ADD,
        OperatorType.SCALAR_SUB,
        OperatorType.SCALAR_TRUE_DIV,
        OperatorType.SCALAR_FLOOR_DIV,
    }
)

BINARY_OPS = frozenset(
    {
        OperatorType.EW_ADD,
        OperatorType.EW_SUB,
        OperatorType.EW_MUL,
        OperatorType.EW_DIV,
        OperatorType.EW_MAX,
        OperatorType.EW_MIN,
        OperatorType.EW_EQUAL,
        OperatorType.EW_GREATER,
        OperatorType.EW_LESS,
    }
)

PARALLEL_OPS = frozenset(
    {
        OperatorType.REPARTITION,
        OperatorType.COMBINE,
        OperatorType.REPLICATE,
        OperatorType.REDUCTION,
        OperatorType.ALLTOALL,
        OperatorType.FUSED_PARALLEL,
    }
)
