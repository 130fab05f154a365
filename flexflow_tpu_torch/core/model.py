"""FFModel — the model builder (counterpart: flexflow_tpu/core/model.py).

The builder methods append Layers to the frontend graph with the same op
types, params and default names as the JAX package, so the same build
script yields the same layer names, weight specs and topological order in
both packages. Only the builders GPT-2 calls are ported so far.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.tensor import Tensor, TensorSpec
from flexflow_tpu_torch.dtype import DataType
from flexflow_tpu_torch.ops import get_op_def
from flexflow_tpu_torch.ops.op_type import OperatorType


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.layers: List[Layer] = []
        self.input_tensors: List[Tensor] = []
        self._initializer_overrides: Dict[Tuple[str, str], Any] = {}

    def create_tensor(self, dims: Sequence[int], dtype=DataType.FLOAT,
                      name: Optional[str] = None) -> Tensor:
        t = Tensor(TensorSpec(tuple(dims), DataType.from_any(dtype)), name=name)
        self.input_tensors.append(t)
        return t

    def _add_layer(self, op_type: OperatorType, params: Dict[str, Any],
                   inputs: Sequence[Tensor], name: Optional[str] = None,
                   initializers: Optional[Dict[str, Any]] = None) -> List[Tensor]:
        layer = Layer(op_type, params, list(inputs), name=name)
        specs = get_op_def(op_type).infer(layer)
        for i, spec in enumerate(specs):
            layer.add_output(spec, idx=i)
        self.layers.append(layer)
        for wname, init in (initializers or {}).items():
            if init is not None:
                self._initializer_overrides[(layer.name, wname)] = init
        return layer.outputs

    def dense(self, input: Tensor, out_dim: int, activation=None,
              use_bias: bool = True, kernel_initializer=None,
              bias_initializer=None, name=None) -> Tensor:
        return self._add_layer(
            OperatorType.LINEAR,
            {"out_dim": int(out_dim), "activation": activation,
             "use_bias": use_bias},
            [input], name,
            {"kernel": kernel_initializer, "bias": bias_initializer})[0]

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: str = "none", dtype=DataType.FLOAT,
                  kernel_initializer=None, name=None) -> Tensor:
        return self._add_layer(
            OperatorType.EMBEDDING,
            {"num_entries": int(num_entries), "out_dim": int(out_dim),
             "aggr": aggr, "dtype": DataType.from_any(dtype).value},
            [input], name, {"kernel": kernel_initializer})[0]

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int, kdim: int = 0,
                            vdim: int = 0, dropout: float = 0.0,
                            bias: bool = True, add_bias_kv: bool = False,
                            add_zero_attn: bool = False, causal: bool = False,
                            kernel_initializer=None, decode: bool = False,
                            kv_out: bool = False,
                            name=None) -> Tensor:
        # decode: serving step reading/writing the paged KV cache through
        # lowering state; kv_out: prefill variant exposing per-head K/V
        return self._add_layer(
            OperatorType.MULTIHEAD_ATTENTION,
            {"embed_dim": int(embed_dim), "num_heads": int(num_heads),
             "kdim": kdim, "vdim": vdim, "dropout": dropout, "bias": bias,
             "add_bias_kv": add_bias_kv, "add_zero_attn": add_zero_attn,
             "causal": causal, "decode": decode, "kv_out": kv_out},
            [query, key, value], name,
            {"wq": kernel_initializer, "wk": kernel_initializer,
             "wv": kernel_initializer, "wo": kernel_initializer})[0]

    def add(self, a, b, name=None) -> Tensor:
        return self._add_layer(OperatorType.EW_ADD, {}, [a, b], name)[0]

    def layer_norm(self, input, axes=None, elementwise_affine: bool = True,
                   eps: float = 1e-5, name=None) -> Tensor:
        return self._add_layer(
            OperatorType.LAYERNORM,
            {"axes": axes, "elementwise_affine": elementwise_affine,
             "eps": eps},
            [input], name)[0]

    def dropout(self, input, rate: float = 0.5, seed: int = 0,
                name=None) -> Tensor:
        return self._add_layer(OperatorType.DROPOUT,
                               {"rate": rate, "seed": seed}, [input], name)[0]
