"""FFModel — the model builder (counterpart: flexflow_tpu/core/model.py).

The builder methods append Layers to the frontend graph with the same op
types, params and default names as the JAX package, so the same build
script yields the same layer names, weight specs and topological order in
both packages. Only the builders GPT-2 calls are ported so far.
`compile`, `fit`, `eval`, `forward`, `save_checkpoint`,
`load_checkpoint`, `get_weight` and `set_weight` delegate to the
`CompiledModel` (compiler/compile.py), as in JAX.
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
