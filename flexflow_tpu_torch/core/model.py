"""FFModel — the model builder (counterpart: flexflow_tpu/core/model.py).

The builder methods append Layers to the frontend graph with the same op
types, params and default names as the JAX package, so the same build
script yields the same layer names, weight specs and topological order in
both packages. Ported: the dense, conv, pool, embedding, batch-matmul and
attention builders, the elementwise, norm, softmax, dropout, shape and
reduction builders; the MoE, fork-join, cache and parallel-op builders
are not.
`compile`, `fit`, `eval`, `forward`, `save_checkpoint`,
`load_checkpoint`, `get_weight` and `set_weight` delegate to the
`CompiledModel` (compiler/compile.py), as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

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
        self._compiled = None

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

    def conv2d(self, input: Tensor, out_channels: int, kernel_h: int,
               kernel_w: int, stride_h: int = 1, stride_w: int = 1,
               padding_h: int = 0, padding_w: int = 0, activation=None,
               groups: int = 1, use_bias: bool = True,
               kernel_initializer=None, bias_initializer=None,
               name=None) -> Tensor:
        return self._add_layer(
            OperatorType.CONV2D,
            {"out_channels": int(out_channels), "kernel_h": kernel_h,
             "kernel_w": kernel_w, "stride_h": stride_h,
             "stride_w": stride_w, "padding_h": padding_h,
             "padding_w": padding_w, "activation": activation,
             "groups": groups, "use_bias": use_bias},
            [input], name,
            {"kernel": kernel_initializer, "bias": bias_initializer})[0]

    def pool2d(self, input: Tensor, kernel_h: int, kernel_w: int,
               stride_h: int = 1, stride_w: int = 1, padding_h: int = 0,
               padding_w: int = 0, pool_type: str = "max", activation=None,
               name=None) -> Tensor:
        return self._add_layer(
            OperatorType.POOL2D,
            {"kernel_h": kernel_h, "kernel_w": kernel_w,
             "stride_h": stride_h, "stride_w": stride_w,
             "padding_h": padding_h, "padding_w": padding_w,
             "pool_type": pool_type, "activation": activation},
            [input], name)[0]

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: str = "none", dtype=DataType.FLOAT,
                  kernel_initializer=None, name=None) -> Tensor:
        return self._add_layer(
            OperatorType.EMBEDDING,
            {"num_entries": int(num_entries), "out_dim": int(out_dim),
             "aggr": aggr, "dtype": DataType.from_any(dtype).value},
            [input], name, {"kernel": kernel_initializer})[0]

    def batch_matmul(self, A: Tensor, B: Tensor, a_seq_length_dim: int = -1,
                     b_seq_length_dim: int = -1, name=None) -> Tensor:
        # the config's seq_length is captured at build time, so shape
        # inference sees the truncated lengths (ops/dense_ops.py)
        return self._add_layer(
            OperatorType.BATCHMATMUL,
            {"a_seq_length_dim": a_seq_length_dim,
             "b_seq_length_dim": b_seq_length_dim,
             "seq_length": int(self.config.seq_length or 0)},
            [A, B], name)[0]

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int, kdim: int = 0,
                            vdim: int = 0, dropout: float = 0.0,
                            bias: bool = True, add_bias_kv: bool = False,
                            add_zero_attn: bool = False, causal: bool = False,
                            kernel_initializer=None, impl: str = "auto",
                            decode: bool = False, kv_out: bool = False,
                            name=None) -> Tensor:
        # impl: "auto" (the flash kernel when fusion is on), "flash" (the
        # kernel always) or "xla" (the einsum path); decode: serving step
        # reading/writing the paged KV cache through lowering state;
        # kv_out: prefill variant exposing per-head K/V
        return self._add_layer(
            OperatorType.MULTIHEAD_ATTENTION,
            {"embed_dim": int(embed_dim), "num_heads": int(num_heads),
             "kdim": kdim, "vdim": vdim, "dropout": dropout, "bias": bias,
             "add_bias_kv": add_bias_kv, "add_zero_attn": add_zero_attn,
             "causal": causal, "impl": impl, "decode": decode,
             "kv_out": kv_out},
            [query, key, value], name,
            {"wq": kernel_initializer, "wk": kernel_initializer,
             "wv": kernel_initializer, "wo": kernel_initializer})[0]

    # elementwise ---------------------------------------------------------
    def _unary(self, op, input, name=None, **params) -> Tensor:
        return self._add_layer(op, params, [input], name)[0]

    def _binary(self, op, a, b, name=None) -> Tensor:
        return self._add_layer(op, {}, [a, b], name)[0]

    def add(self, a, b, name=None) -> Tensor:
        return self._binary(OperatorType.EW_ADD, a, b, name)

    def subtract(self, a, b, name=None) -> Tensor:
        return self._binary(OperatorType.EW_SUB, a, b, name)

    def multiply(self, a, b, name=None) -> Tensor:
        return self._binary(OperatorType.EW_MUL, a, b, name)

    def divide(self, a, b, name=None) -> Tensor:
        return self._binary(OperatorType.EW_DIV, a, b, name)

    def max(self, a, b, name=None) -> Tensor:
        return self._binary(OperatorType.EW_MAX, a, b, name)

    def min(self, a, b, name=None) -> Tensor:
        return self._binary(OperatorType.EW_MIN, a, b, name)

    def relu(self, input, name=None) -> Tensor:
        return self._unary(OperatorType.RELU, input, name)

    def identity(self, input, name=None) -> Tensor:
        return self._unary(OperatorType.IDENTITY, input, name)

    def sigmoid(self, input, name=None) -> Tensor:
        return self._unary(OperatorType.SIGMOID, input, name)

    def tanh(self, input, name=None) -> Tensor:
        return self._unary(OperatorType.TANH, input, name)

    def elu(self, input, name=None) -> Tensor:
        return self._unary(OperatorType.ELU, input, name)

    def gelu(self, input, name=None) -> Tensor:
        return self._unary(OperatorType.GELU, input, name)

    def erf(self, input, name=None) -> Tensor:
        return self._unary(OperatorType.ERF, input, name)

    def silu(self, input, name=None) -> Tensor:
        return self._unary(OperatorType.SILU, input, name)

    def exp(self, input, name=None) -> Tensor:
        return self._unary(OperatorType.EXP, input, name)

    def log(self, input, name=None) -> Tensor:
        return self._unary(OperatorType.LOG, input, name)

    def sin(self, input, name=None) -> Tensor:
        return self._unary(OperatorType.SIN, input, name)

    def cos(self, input, name=None) -> Tensor:
        return self._unary(OperatorType.COS, input, name)

    def sqrt(self, input, name=None) -> Tensor:
        return self._unary(OperatorType.SQRT, input, name)

    def rsqrt(self, input, name=None) -> Tensor:
        return self._unary(OperatorType.RSQRT, input, name)

    def pow(self, input, exponent: float, name=None) -> Tensor:
        return self._unary(OperatorType.POW, input, name, exponent=exponent)

    def scalar_multiply(self, input, scalar: float, name=None) -> Tensor:
        return self._unary(OperatorType.SCALAR_MULTIPLY, input, name,
                           scalar=scalar)

    def scalar_add(self, input, scalar: float, name=None) -> Tensor:
        return self._unary(OperatorType.SCALAR_ADD, input, name,
                           scalar=scalar)

    def scalar_sub(self, input, scalar: float, name=None) -> Tensor:
        return self._unary(OperatorType.SCALAR_SUB, input, name,
                           scalar=scalar)

    def scalar_true_divide(self, input, scalar: float, name=None) -> Tensor:
        return self._unary(OperatorType.SCALAR_TRUE_DIV, input, name,
                           scalar=scalar)

    # norm / softmax / dropout ---------------------------------------------
    def batch_norm(self, input, relu: bool = True, momentum: float = 0.9,
                   eps: float = 1e-5, name=None) -> Tensor:
        return self._add_layer(OperatorType.BATCHNORM,
                               {"relu": relu, "momentum": momentum,
                                "eps": eps}, [input], name)[0]

    def layer_norm(self, input, axes=None, elementwise_affine: bool = True,
                   eps: float = 1e-5, name=None) -> Tensor:
        return self._add_layer(
            OperatorType.LAYERNORM,
            {"axes": axes, "elementwise_affine": elementwise_affine,
             "eps": eps},
            [input], name)[0]

    def softmax(self, input, axis: int = -1, name=None) -> Tensor:
        return self._add_layer(OperatorType.SOFTMAX, {"axis": axis},
                               [input], name)[0]

    def log_softmax(self, input, axis: int = -1, name=None) -> Tensor:
        return self._add_layer(OperatorType.LOG_SOFTMAX, {"axis": axis},
                               [input], name)[0]

    def dropout(self, input, rate: float = 0.5, seed: int = 0,
                name=None) -> Tensor:
        return self._add_layer(OperatorType.DROPOUT,
                               {"rate": rate, "seed": seed}, [input], name)[0]

    # shape ops -------------------------------------------------------------
    def reshape(self, input, shape: Sequence[int], name=None) -> Tensor:
        return self._add_layer(OperatorType.RESHAPE, {"shape": tuple(shape)},
                               [input], name)[0]

    def transpose(self, input, perm: Sequence[int], name=None) -> Tensor:
        return self._add_layer(OperatorType.TRANSPOSE, {"perm": tuple(perm)},
                               [input], name)[0]

    def flat(self, input, name=None) -> Tensor:
        return self._add_layer(OperatorType.FLAT, {}, [input], name)[0]

    def concat(self, tensors: Sequence[Tensor], axis: int,
               name=None) -> Tensor:
        return self._add_layer(OperatorType.CONCAT, {"axis": axis},
                               list(tensors), name)[0]

    def split(self, input, sizes: Union[int, Sequence[int]], axis: int,
              name=None) -> List[Tensor]:
        if isinstance(sizes, int):
            d = input.shape[axis % input.ndim]
            if d % sizes:
                raise ValueError(f"split of dim {d} into {sizes} parts")
            sizes = [d // sizes] * sizes
        return self._add_layer(OperatorType.SPLIT,
                               {"sizes": tuple(sizes), "axis": axis},
                               [input], name)

    def reverse(self, input, axis: int, name=None) -> Tensor:
        return self._add_layer(OperatorType.REVERSE, {"axis": axis},
                               [input], name)[0]

    def pad(self, input, pads, value=0.0, name=None) -> Tensor:
        return self._add_layer(OperatorType.PAD,
                               {"pads": tuple(map(tuple, pads)),
                                "value": value}, [input], name)[0]

    def cast(self, input, dtype, name=None) -> Tensor:
        return self._add_layer(OperatorType.CAST,
                               {"dtype": DataType.from_any(dtype).value},
                               [input], name)[0]

    def gather(self, input, index: Tensor, dim: int, name=None) -> Tensor:
        return self._add_layer(OperatorType.GATHER, {"dim": dim},
                               [input, index], name)[0]

    def slice_tensor(self, input, starts, limits, name=None) -> Tensor:
        return self._add_layer(OperatorType.SLICE,
                               {"starts": tuple(starts),
                                "limits": tuple(limits)}, [input], name)[0]

    def expand(self, input, sizes: Sequence[int], name=None) -> Tensor:
        """torch.Tensor.expand semantics (-1 keeps the dim)."""
        return self._add_layer(OperatorType.EXPAND, {"sizes": tuple(sizes)},
                               [input], name)[0]

    def constant(self, value, name=None) -> Tensor:
        """A fixed array baked into the graph."""
        return self._add_layer(OperatorType.CONSTANT,
                               {"value": np.asarray(value)}, [], name)[0]

    def masked_fill(self, input, mask: Tensor, value: float,
                    name=None) -> Tensor:
        """Where mask is true, replace with value (torch.masked_fill)."""
        return self._add_layer(OperatorType.MASKED_FILL,
                               {"value": float(value)}, [input, mask],
                               name)[0]

    def where(self, cond: Tensor, a: Tensor, b: Tensor, name=None) -> Tensor:
        """Elementwise select (torch.where): a where cond else b."""
        return self._add_layer(OperatorType.WHERE, {}, [cond, a, b], name)[0]

    # reductions ------------------------------------------------------------
    def reduce_sum(self, input, axes, keepdims: bool = False,
                   name=None) -> Tensor:
        return self._add_layer(OperatorType.REDUCE_SUM,
                               {"axes": tuple(axes), "keepdims": keepdims},
                               [input], name)[0]

    def reduce_mean(self, input, axes, keepdims: bool = False,
                    name=None) -> Tensor:
        return self._add_layer(OperatorType.REDUCE_MEAN,
                               {"axes": tuple(axes), "keepdims": keepdims},
                               [input], name)[0]

    def mean(self, input, axes, keepdims: bool = False, name=None) -> Tensor:
        return self._add_layer(OperatorType.MEAN,
                               {"axes": tuple(axes), "keepdims": keepdims},
                               [input], name)[0]

    def argmax(self, input, axis: int = -1, name=None) -> Tensor:
        return self._add_layer(OperatorType.ARGMAX, {"axis": axis}, [input],
                               name)[0]

    def top_k(self, input, k: int, sorted: bool = True,
              name=None) -> List[Tensor]:
        return self._add_layer(OperatorType.TOPK,
                               {"k": int(k), "sorted": sorted}, [input], name)

    # ------------------------------------------------------------- compile
    def compile(self, optimizer=None,
                loss_type="sparse_categorical_crossentropy",
                metrics: Sequence = ("accuracy",), device=None):
        """Build the training program (compiler/compile.py). It runs on the
        GPU unless `device="cpu"` is passed."""
        from flexflow_tpu_torch.compiler.compile import compile_model

        self._compiled = compile_model(self, optimizer, loss_type, metrics,
                                       device=device)
        return self._compiled

    @property
    def compiled(self):
        if self._compiled is None:
            raise RuntimeError("call compile() first")
        return self._compiled

    # ------------------------------------------------------------ training
    def fit(self, x, y, batch_size: Optional[int] = None,
            epochs: Optional[int] = None, callbacks=None, verbose: bool = True,
            sync_every: Optional[int] = None,
            accum_steps: Optional[int] = None,
            resume: Optional[str] = None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every_steps: Optional[int] = None,
            checkpoint_every_secs: Optional[float] = None):
        """Train (CompiledModel.fit); each keyword given overrides the
        config's value for this call."""
        return self.compiled.fit(
            x, y, batch_size=batch_size, epochs=epochs, callbacks=callbacks,
            verbose=verbose, sync_every=sync_every, accum_steps=accum_steps,
            resume=resume, checkpoint_dir=checkpoint_dir,
            checkpoint_every_steps=checkpoint_every_steps,
            checkpoint_every_secs=checkpoint_every_secs)

    def save_checkpoint(self, path: str, block: Optional[bool] = None) -> str:
        """Full-state checkpoint (async by default: cfg.async_checkpoint);
        see CompiledModel.save_checkpoint."""
        return self.compiled.save_checkpoint(path, block=block)

    def load_checkpoint(self, path: str) -> None:
        self.compiled.load_checkpoint(path)

    def forward(self, *inputs):
        return self.compiled.forward(*inputs)

    def eval(self, x, y, batch_size: Optional[int] = None):
        return self.compiled.evaluate(x, y, batch_size=batch_size)

    def get_layer_by_name(self, name: str) -> Layer:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)

    def get_weight(self, layer_name: str, wname: str = "kernel"):
        return self.compiled.get_weight(layer_name, wname)

    def set_weight(self, layer_name: str, wname: str, value) -> None:
        self.compiled.set_weight(layer_name, wname, value)
