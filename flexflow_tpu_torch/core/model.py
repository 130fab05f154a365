"""FFModel — the model builder (counterpart: flexflow_tpu/core/model.py).

The builder methods append Layers to the frontend graph with the same op
types, params and default names as the JAX package, so the same build
script yields the same layer names, weight specs and topological order in
both packages. Every builder of the JAX FFModel is here: dense, conv,
pool, embedding, batch matmul, attention and scaled-dot-product attention,
the elementwise, norm, softmax, dropout, shape and reduction builders, the
MoE ops and the composite `moe`, `fork_join`, and the parallel ops.
`compile`, `fit`, `eval`, `forward`, `save_checkpoint`,
`load_checkpoint`, `get_weight` and `set_weight` (and JAX's names for the
last two, `get_parameter_by_name` and `set_parameter_by_name`) delegate to
the `CompiledModel` (compiler/compile.py), as in JAX. `dot()` is the
Graphviz export that `compile` writes to the config's `export_dot`
(`--compgraph`), with each op's predicted time under
`include_costs_dot_graph`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import to_dot, topo_order
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
        # (layer, wname) -> [("l1" | "l2", coeff)]: penalty terms the train
        # step adds to the f32 loss
        self._weight_regularizers: Dict[Tuple[str, str],
                                        List[Tuple[str, float]]] = {}

    def add_weight_regularizer(self, layer_name: str, wname: str,
                               mode: str, coeff: float) -> None:
        """Register an L1 or L2 penalty on a weight: the train step adds
        coeff * sum|w| or coeff * sum w^2 (of the f32 master weight) to
        the loss it differentiates, the eager step and the K-step graph
        alike."""
        if mode not in ("l1", "l2"):
            raise ValueError(f"unknown regularizer mode {mode!r}")
        self._weight_regularizers.setdefault(
            (layer_name, wname), []).append((mode, float(coeff)))

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

    def scaled_dot_product_attention(self, query, key, value, attn_mask=None,
                                     dropout_p: float = 0.0,
                                     is_causal: bool = False, scale=None,
                                     name=None) -> Tensor:
        """Core attention without projections (torch's
        F.scaled_dot_product_attention semantics, JAX's masking)."""
        ins = [query, key, value] + ([attn_mask] if attn_mask is not None
                                     else [])
        return self._add_layer(
            OperatorType.SDPA,
            {"dropout_p": dropout_p, "is_causal": is_causal, "scale": scale},
            ins, name)[0]

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

    # MoE -------------------------------------------------------------------
    def group_by(self, data: Tensor, assign: Tensor, n_experts: int,
                 alpha: float = 1.0, name=None) -> List[Tensor]:
        return self._add_layer(OperatorType.GROUP_BY,
                               {"n_experts": int(n_experts), "alpha": alpha},
                               [data, assign], name)

    def experts(self, dispatched: Tensor, out_dim: int, activation=None,
                use_bias: bool = True, name=None) -> Tensor:
        return self._add_layer(OperatorType.EXPERTS,
                               {"out_dim": int(out_dim),
                                "activation": activation,
                                "use_bias": use_bias},
                               [dispatched], name)[0]

    def aggregate(self, gates: Tensor, assign: Tensor, positions: Tensor,
                  expert_outputs: Tensor, name=None) -> Tensor:
        return self._add_layer(OperatorType.AGGREGATE, {},
                               [gates, assign, positions, expert_outputs],
                               name)[0]

    def aggregate_spec(self, gates, assign, positions, expert_outputs,
                       name=None) -> Tensor:
        return self._add_layer(OperatorType.AGGREGATE_SPEC, {},
                               [gates, assign, positions, expert_outputs],
                               name)[0]

    def cache(self, input: Tensor, num_batches: int = 1, name=None) -> Tensor:
        return self._add_layer(OperatorType.CACHE,
                               {"num_batches": num_batches}, [input], name)[0]

    def moe(self, input: Tensor, num_exp: int, num_select: int,
            expert_hidden_size: int, alpha: float = 2.0,
            lambda_bal: float = 0.0, name=None) -> Tensor:
        """Composite MoE block: top-k gating, group_by, the per-expert
        dense and aggregate."""
        gate_logits = self.dense(input, num_exp, name=f"{name or 'moe'}_gate")
        gate_probs = self.softmax(gate_logits)
        topk_vals, topk_idx = self.top_k(gate_probs, num_select)
        dispatched, positions = self.group_by(input, topk_idx, num_exp, alpha)
        hidden = self.experts(dispatched, expert_hidden_size,
                              activation="relu",
                              name=f"{name or 'moe'}_experts")
        return self.aggregate(topk_vals, topk_idx, positions, hidden,
                              name=f"{name or 'moe'}_agg")

    def fork_join(self, input: Tensor, branches, join: str = "add",
                  name=None) -> Tensor:
        """Parallel branches joined by "add" or a last-dim "concat"
        (ops/fork_join.py). Each branch is a callable f(sub_model, x) ->
        Tensor building an ordinary sub-graph on a sub-model; its weights
        surface on this layer as "b{i}.{sub_layer}.{wname}" (or stacked,
        "stk.{sub_layer}.{wname}", for congruent branches). A sub-layer
        whose name embeds its guid is renamed by position, so models built
        alike get the same weight names; branch initializer overrides move
        to the prefixed names."""
        subs = []
        overrides = []
        for bi, build in enumerate(branches):
            bm = FFModel(self.config)
            bx = bm.create_tensor(list(input.shape), dtype=input.spec.dtype,
                                  name=f"_fj_b{bi}_in")
            out = build(bm, bx)
            rename = {}
            for j, l in enumerate(bm.layers):
                if l.name == f"{l.op_type.value}_{l.guid}":
                    rename[l.name] = f"{l.op_type.value}{j}"
                    l.name = rename[l.name]
            subs.append((bm.layers, bx, out))
            overrides.append({(rename.get(ln, ln), wn): init for (ln, wn), init
                              in bm._initializer_overrides.items()})
        layer = Layer(OperatorType.FORK_JOIN,
                      {"join": join, "n_branches": len(branches)},
                      [input], name=name)
        layer.branches = subs
        for i, spec in enumerate(get_op_def(OperatorType.FORK_JOIN).infer(layer)):
            layer.add_output(spec, idx=i)
        self.layers.append(layer)
        for bi, ov in enumerate(overrides):
            for (lname, wname), init in ov.items():
                self._initializer_overrides[
                    (layer.name, f"b{bi}.{lname}.{wname}")] = init
        return layer.outputs[0]

    # parallel ops (identities on one device: ops/parallel_ops.py) ----------
    def repartition(self, input: Tensor, dim: int, axis: str = "data",
                    name=None) -> Tensor:
        return self._add_layer(OperatorType.REPARTITION,
                               {"dim": dim, "axis": axis}, [input], name)[0]

    def combine(self, input: Tensor, dim: int, axis: str, name=None) -> Tensor:
        return self._add_layer(OperatorType.COMBINE,
                               {"dim": dim, "axis": axis}, [input], name)[0]

    def replicate(self, input: Tensor, name=None) -> Tensor:
        return self._add_layer(OperatorType.REPLICATE, {}, [input], name)[0]

    def reduction(self, input: Tensor, axis: str, name=None) -> Tensor:
        return self._add_layer(OperatorType.REDUCTION, {"axis": axis},
                               [input], name)[0]

    def all_to_all(self, input: Tensor, src_dim: int, dst_dim: int, axis: str,
                   name=None) -> Tensor:
        return self._add_layer(OperatorType.ALLTOALL,
                               {"src_dim": src_dim, "dst_dim": dst_dim,
                                "axis": axis}, [input], name)[0]

    def fused_parallel(self, input: Tensor, dims: Sequence,
                       name=None) -> Tensor:
        return self._add_layer(OperatorType.FUSED_PARALLEL,
                               {"dims": tuple(dims)}, [input], name)[0]

    # ------------------------------------------------------------- compile
    def compile(self, optimizer=None,
                loss_type="sparse_categorical_crossentropy",
                metrics: Sequence = ("accuracy",), device=None):
        """Build the training program (compiler/compile.py). It runs on the
        GPU unless `device="cpu"` is passed."""
        from flexflow_tpu_torch.compiler.compile import compile_model

        self._compiled = compile_model(self, optimizer, loss_type, metrics,
                                       device=device)
        if self.config.export_dot:
            with open(self.config.export_dot, "w") as f:
                f.write(self.dot())
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

    def get_layers(self) -> List[Layer]:
        return list(self.layers)

    def get_layer_by_name(self, name: str) -> Layer:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)

    def get_weight(self, layer_name: str, wname: str = "kernel"):
        return self.compiled.get_weight(layer_name, wname)

    def set_weight(self, layer_name: str, wname: str, value) -> None:
        self.compiled.set_weight(layer_name, wname, value)

    def get_parameter_by_name(self, layer_name: str, wname: str = "kernel"):
        return self.compiled.get_weight(layer_name, wname)

    def set_parameter_by_name(self, layer_name: str, wname: str, value):
        self.compiled.set_weight(layer_name, wname, value)

    def dot(self, include_costs: Optional[bool] = None) -> str:
        """Graphviz text with each layer's compiled sharding; with
        include_costs (default: the config's `include_costs_dot_graph`)
        also each op's roofline time on the compiled machine
        (search/cost_model.compute_time), as JAX's `dot` writes it."""
        if include_costs is None:
            include_costs = self.config.include_costs_dot_graph
        ann = {}
        if self._compiled is not None:
            ann = {l: str(self._compiled.strategy.op_shardings.get(l.name, ""))
                   for l in self.layers}
            if include_costs:
                from flexflow_tpu_torch.ops.registry import io_bytes
                from flexflow_tpu_torch.search import cost_model as cm_

                machine = self._compiled.machine
                for l in self.layers:
                    t = cm_.compute_time(get_op_def(l.op_type).flop_count(l),
                                         io_bytes(l), machine)
                    ann[l] = (ann.get(l, "") + f"\\n{t * 1e6:.1f}us"
                              ).lstrip("\\n")
        return to_dot(topo_order(self.layers), ann)
