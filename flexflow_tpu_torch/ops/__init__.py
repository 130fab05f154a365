"""Op library: importing this package registers every OpDef."""

from flexflow_tpu_torch.ops.op_type import OperatorType  # noqa: F401
from flexflow_tpu_torch.ops.registry import (  # noqa: F401
    LoweringCtx,
    OpDef,
    get_op_def,
    has_op_def,
    io_bytes,
    register_op,
)

# registration side effects
from flexflow_tpu_torch.ops import (  # noqa: F401
    activations,
    attention_ops,
    conv_ops,
    dense_ops,
    elementwise,
    embed_ops,
    fork_join,
    moe_ops,
    norm_ops,
    parallel_ops,
    reduce_ops,
    shape_ops,
)
