"""Model builders (counterpart: flexflow_tpu/models/): every builder the
JAX package's zoo exports, under the same names."""

from flexflow_tpu_torch.models.alexnet import build_alexnet  # noqa: F401
from flexflow_tpu_torch.models.bert import build_bert  # noqa: F401
from flexflow_tpu_torch.models.candle_uno import build_candle_uno  # noqa: F401
from flexflow_tpu_torch.models.dlrm import build_dlrm  # noqa: F401
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2  # noqa: F401
from flexflow_tpu_torch.models.inception import build_inception_v3  # noqa: F401
from flexflow_tpu_torch.models.mlp import build_mlp  # noqa: F401
from flexflow_tpu_torch.models.moe import build_moe_mlp  # noqa: F401
from flexflow_tpu_torch.models.resnet import (  # noqa: F401
    build_resnet50, build_resnet_block)
from flexflow_tpu_torch.models.resnext import (  # noqa: F401
    build_resnext50, resnext_block)
from flexflow_tpu_torch.models.transformer import (  # noqa: F401
    build_transformer, transformer_block)
from flexflow_tpu_torch.models.xdl import build_xdl  # noqa: F401
