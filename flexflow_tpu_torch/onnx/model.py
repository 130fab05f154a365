"""ONNX frontend (counterpart: flexflow_tpu/onnx/model.py): a walker with
one `handleX` method per ONNX op, each emitting FFModel builder calls.

Initializer values are kept and copied onto the compiled model by
`import_weights` (as torch tensors on its device; batch norm's running
moments into its `state`), so an imported graph computes what the source
framework's does. An unsupported op or attribute raises
NotImplementedError: nothing is dropped quietly.

Usage:
    om = ONNXModel("model.onnx")
    outputs = om.apply(ffmodel)            # builds layers, returns outputs
    cm = ffmodel.compile(..., outputs=outputs)
    cm.init(); om.import_weights(cm)       # copy the exported weights in
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from flexflow_tpu_torch.dtype import DataType
from flexflow_tpu_torch.onnx import proto
from flexflow_tpu_torch.onnx.proto import Msg

_DT = {
    proto.DT_FLOAT: np.float32,
    proto.DT_UINT8: np.uint8,
    proto.DT_INT8: np.int8,
    proto.DT_INT32: np.int32,
    proto.DT_INT64: np.int64,
    proto.DT_BOOL: np.bool_,
    proto.DT_FLOAT16: np.float16,
    proto.DT_DOUBLE: np.float64,
}
_FF_DT = {
    proto.DT_FLOAT: DataType.FLOAT,
    proto.DT_INT32: DataType.INT32,
    proto.DT_INT64: DataType.INT64,
    proto.DT_BOOL: DataType.BOOL,
    proto.DT_DOUBLE: DataType.DOUBLE,
    proto.DT_FLOAT16: DataType.HALF,
}


def tensor_to_numpy(t: Msg) -> np.ndarray:
    """TensorProto -> ndarray (raw_data little-endian, or the typed lists)."""
    shape = tuple(t.dims)
    if t.data_type not in _DT:
        raise NotImplementedError(f"tensor dtype {t.data_type} not supported")
    dt = _DT[t.data_type]
    if t.raw_data:
        return np.frombuffer(t.raw_data, dtype=np.dtype(dt).newbyteorder("<")) \
            .reshape(shape).astype(dt)
    if t.data_type == proto.DT_FLOAT16 and t.int32_data:
        # spec: fp16 values are bit-packed as uint16 in int32_data —
        # reinterpret the bits, don't convert numerically
        return np.asarray(t.int32_data, np.uint16).view(np.float16) \
            .reshape(shape)
    for field, cast in (("float_data", np.float32), ("int64_data", np.int64),
                        ("int32_data", np.int32), ("double_data", np.float64)):
        data = getattr(t, field)
        if data:
            return np.asarray(data, dtype=cast).reshape(shape).astype(dt)
    return np.zeros(shape, dt)


def _attrs(node: Msg) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for a in node.attribute:
        # AttributeProto.type: 1 f, 2 i, 3 s, 4 t, 6 floats, 7 ints, 8 strings
        if a.type == 1:
            out[a.name] = a.f
        elif a.type == 2:
            out[a.name] = a.i
        elif a.type == 3:
            out[a.name] = a.s.decode("utf-8")
        elif a.type == 4:
            out[a.name] = tensor_to_numpy(a.t)
        elif a.type == 6:
            out[a.name] = list(a.floats)
        elif a.type == 7:
            out[a.name] = list(a.ints)
        elif a.type == 8:
            out[a.name] = [s.decode("utf-8") for s in a.strings]
    return out


def _sym_pads(pads, n=2):
    pads = list(pads) if pads else [0] * (2 * n)
    begin, end = pads[:n], pads[n:]
    if begin != end:
        raise NotImplementedError(f"asymmetric pads {pads} not supported")
    return begin


class ONNXModel:
    """Walks a decoded ONNX graph, emitting FFModel builder calls per node
    (FlexFlow's ONNXModel, python/flexflow/onnx/model.py)."""

    def __init__(self, path_or_model):
        self.model = (proto.load_model(path_or_model)
                      if isinstance(path_or_model, str) else path_or_model)
        if self.model.graph is None:
            raise ValueError("ONNX file has no graph")
        self.graph = self.model.graph
        self.inits: Dict[str, np.ndarray] = {
            t.name: tensor_to_numpy(t) for t in self.graph.initializer}
        # (layer_name, wname) -> array, filled during apply
        self._weights: Dict[tuple, np.ndarray] = {}
        # state-dict entries (BN running moments), keyed by the lowering's
        # state keys
        self._state: Dict[str, np.ndarray] = {}
        self.symbols: Dict[str, object] = {}

    # ------------------------------------------------------------- plumbing
    def _value(self, ff, name: str):
        """A graph value as a Tensor: symbol, or a constant initializer."""
        if name in self.symbols:
            return self.symbols[name]
        if name in self.inits:
            t = ff.constant(self.inits[name], name=f"onnx_const_{name}")
            self.symbols[name] = t
            return t
        raise KeyError(f"unknown ONNX value {name!r}")

    def _record(self, out_tensor, node: Msg, **weights):
        lname = out_tensor.owner.name
        for w, arr in weights.items():
            if arr is not None:
                self._weights[(lname, w)] = np.ascontiguousarray(arr)

    # ---------------------------------------------------------------- apply
    def apply(self, ff, inputs: Optional[Dict[str, object]] = None) -> List:
        """Build the graph onto `ff`; returns the graph's output tensors.
        `inputs` maps graph-input names to pre-made Tensors (created from the
        declared value_info shapes when absent; dynamic dims need `inputs`)."""
        inputs = inputs or {}
        for vi in self.graph.input:
            if vi.name in self.inits:
                continue
            if vi.name in inputs:
                self.symbols[vi.name] = inputs[vi.name]
                continue
            tt = vi.type.tensor_type
            dims = []
            for d in (tt.shape.dim if tt.shape else []):
                if not d.dim_value:
                    raise ValueError(
                        f"input {vi.name!r} has dynamic dim {d.dim_param!r}; "
                        "pass a pre-made tensor via `inputs`")
                dims.append(d.dim_value)
            self.symbols[vi.name] = ff.create_tensor(
                dims, dtype=_FF_DT.get(tt.elem_type, DataType.FLOAT),
                name=vi.name)
        for node in self.graph.node:
            handler = getattr(self, f"handle{node.op_type}", None)
            if handler is None:
                raise NotImplementedError(
                    f"ONNX op {node.op_type!r} has no handler")
            handler(ff, node)
        return [self._value(ff, o.name) for o in self.graph.output]

    def import_weights(self, compiled) -> None:
        """Copy the exported initializer weights into a CompiledModel, so
        that the imported graph computes what the source framework's does:
        each weight onto the compiled model's device (`set_weight`), batch
        norm's running moments into `compiled.state` as f32 tensors there."""
        import torch

        for (lname, wname), arr in self._weights.items():
            compiled.set_weight(lname, wname, arr)
        for key, arr in self._state.items():
            compiled.state[key] = torch.from_numpy(
                np.ascontiguousarray(arr, np.float32)).to(compiled.device)

    # ------------------------------------------------------- layer handlers
    def handleConv(self, ff, node):
        a = _attrs(node)
        x = self._value(ff, node.input[0])
        w = self.inits[node.input[1]]
        b = self.inits[node.input[2]] if len(node.input) > 2 else None
        if any(d != 1 for d in a.get("dilations", [1, 1])):
            raise NotImplementedError("dilated conv not supported")
        ph, pw = _sym_pads(a.get("pads"))
        sh, sw = a.get("strides", [1, 1])
        kh, kw = a.get("kernel_shape", w.shape[2:])
        out = ff.conv2d(x, w.shape[0], kh, kw, sh, sw, ph, pw,
                        groups=a.get("group", 1), use_bias=b is not None,
                        name=node.name or None)
        self.symbols[node.output[0]] = out
        self._record(out, node, kernel=w, bias=b)

    def _pool(self, ff, node, pool_type):
        a = _attrs(node)
        if a.get("ceil_mode"):
            raise NotImplementedError("ceil_mode pooling not supported")
        x = self._value(ff, node.input[0])
        kh, kw = a["kernel_shape"]
        sh, sw = a.get("strides", [1, 1])
        ph, pw = _sym_pads(a.get("pads"))
        out = ff.pool2d(x, kh, kw, sh, sw, ph, pw, pool_type=pool_type,
                        name=node.name or None)
        self.symbols[node.output[0]] = out

    def handleMaxPool(self, ff, node):
        self._pool(ff, node, "max")

    def handleAveragePool(self, ff, node):
        a = _attrs(node)
        if a.get("count_include_pad") and any(a.get("pads", [])):
            raise NotImplementedError("count_include_pad not supported")
        self._pool(ff, node, "avg")

    def handleGlobalAveragePool(self, ff, node):
        x = self._value(ff, node.input[0])
        _, _, h, w = x.shape
        self.symbols[node.output[0]] = ff.pool2d(
            x, h, w, 1, 1, 0, 0, pool_type="avg", name=node.name or None)

    def handleGemm(self, ff, node):
        a = _attrs(node)
        if a.get("alpha", 1.0) != 1.0 or a.get("beta", 1.0) != 1.0 \
                or a.get("transA", 0):
            raise NotImplementedError(f"Gemm attrs {a} not supported")
        x = self._value(ff, node.input[0])
        w = self.inits[node.input[1]]
        if a.get("transB", 0):
            w = w.T
        b = self.inits[node.input[2]] if len(node.input) > 2 else None
        out = ff.dense(x, w.shape[1], use_bias=b is not None,
                       name=node.name or None)
        self.symbols[node.output[0]] = out
        self._record(out, node, kernel=w, bias=b)

    def handleMatMul(self, ff, node):
        bname = node.input[1]
        x = self._value(ff, node.input[0])
        if bname in self.inits and self.inits[bname].ndim == 2:
            w = self.inits[bname]
            out = ff.dense(x, w.shape[1], use_bias=False, name=node.name or None)
            self.symbols[node.output[0]] = out
            self._record(out, node, kernel=w)
        else:
            b = self._value(ff, bname)
            self.symbols[node.output[0]] = ff.batch_matmul(x, b, name=node.name or None)

    def handleGather(self, ff, node):
        a = _attrs(node)
        dname = node.input[0]
        if dname in self.inits and self.inits[dname].ndim == 2 \
                and a.get("axis", 0) == 0:
            # embedding lookup: table initializer gathered on dim 0
            tbl = self.inits[dname]
            idx = self._value(ff, node.input[1])
            if idx.spec.dtype != DataType.INT32:
                idx = ff.cast(idx, DataType.INT32)
            out = ff.embedding(idx, tbl.shape[0], tbl.shape[1],
                               name=node.name or None)
            self.symbols[node.output[0]] = out
            self._record(out, node, kernel=tbl)
        else:
            raise NotImplementedError("Gather supported only as embedding "
                                      "(rank-2 initializer table, axis 0)")

    # ------------------------------------------------- elementwise handlers
    def _binary(self, ff, node, builder):
        x = self._value(ff, node.input[0])
        y = self._value(ff, node.input[1])
        self.symbols[node.output[0]] = builder(x, y, name=node.name or None)

    def handleAdd(self, ff, node):
        self._binary(ff, node, ff.add)

    def handleSub(self, ff, node):
        self._binary(ff, node, ff.subtract)

    def handleMul(self, ff, node):
        self._binary(ff, node, ff.multiply)

    def handleDiv(self, ff, node):
        self._binary(ff, node, ff.divide)

    def handlePow(self, ff, node):
        e = node.input[1]
        if e in self.inits and self.inits[e].size == 1:
            x = self._value(ff, node.input[0])
            self.symbols[node.output[0]] = ff.pow(
                x, float(self.inits[e].reshape(())), name=node.name or None)
        else:
            raise NotImplementedError("Pow with tensor exponent")

    def _unary(self, ff, node, builder, **kw):
        x = self._value(ff, node.input[0])
        self.symbols[node.output[0]] = builder(x, name=node.name or None, **kw)

    def handleRelu(self, ff, node):
        self._unary(ff, node, ff.relu)

    def handleTanh(self, ff, node):
        self._unary(ff, node, ff.tanh)

    def handleSigmoid(self, ff, node):
        self._unary(ff, node, ff.sigmoid)

    def handleElu(self, ff, node):
        self._unary(ff, node, ff.elu)

    def handleGelu(self, ff, node):
        self._unary(ff, node, ff.gelu)

    def handleErf(self, ff, node):
        self._unary(ff, node, ff.erf)

    def handleExp(self, ff, node):
        self._unary(ff, node, ff.exp)

    def handleLog(self, ff, node):
        self._unary(ff, node, ff.log)

    def handleSqrt(self, ff, node):
        self._unary(ff, node, ff.sqrt)

    def handleReciprocal(self, ff, node):
        self._unary(ff, node, ff.pow, exponent=-1.0)

    def handleIdentity(self, ff, node):
        self._unary(ff, node, ff.identity)

    def handleSoftmax(self, ff, node):
        a = _attrs(node)
        self._unary(ff, node, ff.softmax, axis=a.get("axis", -1))

    def handleCast(self, ff, node):
        a = _attrs(node)
        to = a.get("to", proto.DT_FLOAT)
        if to not in _FF_DT:
            raise NotImplementedError(f"Cast to ONNX dtype {to}")
        self._unary(ff, node, ff.cast, dtype=_FF_DT[to])

    def handleDropout(self, ff, node):
        a = _attrs(node)
        rate = a.get("ratio", 0.5)
        if len(node.input) > 1 and node.input[1] in self.inits:
            rate = float(self.inits[node.input[1]].reshape(()))
        x = self._value(ff, node.input[0])
        self.symbols[node.output[0]] = ff.dropout(x, rate, name=node.name or None)

    # ------------------------------------------------------- shape handlers
    def handleFlatten(self, ff, node):
        a = _attrs(node)
        axis = a.get("axis", 1)
        x = self._value(ff, node.input[0])
        lead = int(np.prod(x.shape[:axis])) if axis else 1
        rest = int(np.prod(x.shape[axis:]))
        self.symbols[node.output[0]] = ff.reshape(x, (lead, rest),
                                                  name=node.name or None)

    def handleReshape(self, ff, node):
        x = self._value(ff, node.input[0])
        shape = [int(s) for s in self.inits[node.input[1]]]
        # ONNX: 0 copies the input dim; -1 infers
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
        self.symbols[node.output[0]] = ff.reshape(x, shape, name=node.name or None)

    def handleTranspose(self, ff, node):
        a = _attrs(node)
        x = self._value(ff, node.input[0])
        perm = a.get("perm") or list(range(x.ndim))[::-1]
        self.symbols[node.output[0]] = ff.transpose(x, perm, name=node.name or None)

    def handleConcat(self, ff, node):
        a = _attrs(node)
        ts = [self._value(ff, i) for i in node.input]
        self.symbols[node.output[0]] = ff.concat(ts, axis=a["axis"],
                                                 name=node.name or None)

    def handleSplit(self, ff, node):
        a = _attrs(node)
        x = self._value(ff, node.input[0])
        axis = a.get("axis", 0)
        sizes = a.get("split")
        if sizes is None and len(node.input) > 1 and node.input[1] in self.inits:
            sizes = [int(s) for s in self.inits[node.input[1]]]
        if sizes is None:
            sizes = a.get("num_outputs", len(node.output))
        outs = ff.split(x, sizes, axis=axis, name=node.name or None)
        for oname, t in zip(node.output, outs):
            self.symbols[oname] = t

    def _axes_reshape(self, ff, node, squeeze: bool):
        a = _attrs(node)
        x = self._value(ff, node.input[0])
        axes = a.get("axes")
        if axes is None and len(node.input) > 1 and node.input[1] in self.inits:
            axes = [int(s) for s in self.inits[node.input[1]]]
        shape = list(x.shape)
        if squeeze:
            axes = [ax % x.ndim for ax in (axes or
                    [i for i, s in enumerate(shape) if s == 1])]
            shape = [s for i, s in enumerate(shape) if i not in axes]
        else:
            for ax in sorted(ax % (x.ndim + len(axes)) for ax in axes):
                shape.insert(ax, 1)
        self.symbols[node.output[0]] = ff.reshape(x, shape, name=node.name or None)

    def handleSqueeze(self, ff, node):
        self._axes_reshape(ff, node, squeeze=True)

    def handleUnsqueeze(self, ff, node):
        self._axes_reshape(ff, node, squeeze=False)

    def handleReduceMean(self, ff, node):
        a = _attrs(node)
        axes = a.get("axes")
        if axes is None and len(node.input) > 1 and node.input[1] in self.inits:
            axes = [int(s) for s in self.inits[node.input[1]]]
        x = self._value(ff, node.input[0])
        self.symbols[node.output[0]] = ff.reduce_mean(
            x, tuple(axes), keepdims=bool(a.get("keepdims", 1)),
            name=node.name or None)

    def handleConstant(self, ff, node):
        a = _attrs(node)
        if "value" not in a:
            raise NotImplementedError("Constant without tensor value")
        self.symbols[node.output[0]] = ff.constant(a["value"],
                                                   name=node.name or None)

    # --------------------------------------------------------- norm handlers
    def handleBatchNormalization(self, ff, node):
        a = _attrs(node)
        x = self._value(ff, node.input[0])
        gamma = self.inits[node.input[1]]
        beta = self.inits[node.input[2]]
        out = ff.batch_norm(x, relu=False, momentum=a.get("momentum", 0.9),
                            eps=a.get("epsilon", 1e-5), name=node.name or None)
        self.symbols[node.output[0]] = out
        self._record(out, node, gamma=gamma, beta=beta)
        # exported running moments land in the compiled model's state dict
        # (the BN lowering's "{layer}/mean" / "{layer}/var" keys)
        lname = out.owner.name
        if len(node.input) > 3:
            self._state[f"{lname}/mean"] = \
                np.asarray(self.inits[node.input[3]], np.float32)
        if len(node.input) > 4:
            self._state[f"{lname}/var"] = \
                np.asarray(self.inits[node.input[4]], np.float32)

    def handleLayerNormalization(self, ff, node):
        a = _attrs(node)
        x = self._value(ff, node.input[0])
        axis = a.get("axis", -1) % x.ndim
        if axis != x.ndim - 1:
            raise NotImplementedError("LayerNormalization only on last axis")
        gamma = beta = None
        if len(node.input) > 1 and node.input[1]:
            if node.input[1] not in self.inits:
                raise NotImplementedError(
                    "LayerNormalization scale must be an initializer")
            gamma = self.inits[node.input[1]]
        if len(node.input) > 2 and node.input[2]:
            if node.input[2] not in self.inits:
                raise NotImplementedError(
                    "LayerNormalization bias must be an initializer")
            beta = self.inits[node.input[2]]
        out = ff.layer_norm(x, elementwise_affine=gamma is not None,
                            eps=a.get("epsilon", 1e-5), name=node.name or None)
        self.symbols[node.output[0]] = out
        self._record(out, node, gamma=gamma, beta=beta)
