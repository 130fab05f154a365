"""The ONNX frontend of the port (flexflow_tpu_torch/onnx/) against the
JAX package's (flexflow_tpu/onnx/) on the CPU, on the graphs of
tests/test_onnx_frontend.py, each written to wire bytes by each
package's own encoder:

- the port's `proto` encodes the same bytes as JAX's and decodes JAX's;
- the CNN and the pre-LN transformer block (LayerNormalization, MatMul,
  Split, Reshape, Transpose, Softmax, Erf, ...) import in both packages
  to the same layers, and after `import_weights` the port's forward
  matches JAX's (f32, 1e-5 relative) and plain torch's (2e-5 on the CNN,
  2e-4 on the block, JAX's own tolerances);
- batch norm's running moments arrive in the compiled model's `state`;
- an unknown op fails loudly.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.onnx import ONNXModel as JONNXModel
from flexflow_tpu.onnx import proto as jproto
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.onnx import ONNXModel
from flexflow_tpu_torch.onnx import proto


# ------------------------------------------------ graphs as {field: value}
def _tensor(name, arr):
    arr = np.ascontiguousarray(arr)
    dt = {np.dtype(np.float32): proto.DT_FLOAT,
          np.dtype(np.int64): proto.DT_INT64,
          np.dtype(np.int32): proto.DT_INT32}[arr.dtype]
    return {1: [int(d) for d in arr.shape], 2: dt, 8: name,
            9: arr.tobytes()}


def _vi(name, shape, elem=proto.DT_FLOAT):
    return {1: name, 2: {1: {1: elem, 2: {1: [{1: int(d)} for d in shape]}}}}


def _attr(name, val):
    if isinstance(val, float):
        return {1: name, 20: 1, 2: val}
    if isinstance(val, int):
        return {1: name, 20: 2, 3: val}
    return {1: name, 20: 7, 8: [int(v) for v in val]}


def _node(op, ins, outs, name="", **attrs):
    return {4: op, 1: list(ins), 2: list(outs), 3: name,
            5: [_attr(k, v) for k, v in attrs.items()]}


def _model_dict(nodes, inputs, outputs, inits=()):
    graph = {2: "g", 1: list(nodes), 5: list(inits),
             11: list(inputs), 12: list(outputs)}
    return {1: 8, 2: "test", 7: graph, 8: [{1: "", 2: 17}]}


def _cnn(rng):
    w = {"Wc": rng.normal(size=(8, 3, 3, 3), scale=0.2),
         "Bc": rng.normal(size=(8,)),
         "Wf": rng.normal(size=(10, 8 * 4 * 4), scale=0.1),
         "Bf": rng.normal(size=(10,))}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    nodes = [
        _node("Conv", ["x", "Wc", "Bc"], ["c"], name="conv",
              kernel_shape=[3, 3], pads=[1, 1, 1, 1], strides=[1, 1]),
        _node("Relu", ["c"], ["r"], name="act"),
        _node("MaxPool", ["r"], ["p"], name="pool", kernel_shape=[2, 2],
              strides=[2, 2]),
        _node("Flatten", ["p"], ["f"], name="flatten", axis=1),
        _node("Gemm", ["f", "Wf", "Bf"], ["y"], name="fc", transB=1)]
    m = _model_dict(nodes, [_vi("x", (2, 3, 8, 8))], [_vi("y", (2, 10))],
                    [_tensor(k, v) for k, v in w.items()])

    def ref(x, t):
        h = F.max_pool2d(F.relu(F.conv2d(x, t["Wc"], t["Bc"], padding=1)), 2)
        return h.flatten(1) @ t["Wf"].T + t["Bf"]
    return m, w, (2, 3, 8, 8), ref, 2e-5


def _block(rng, b=2, s=8, d=32, h=4):
    """tests/test_onnx_frontend.py's pre-LN block, op by op."""
    dh = d // h
    w = {k: rng.normal(size=sz, scale=0.15).astype(np.float32)
         for k, sz in {"Wqkv": (d, 3 * d), "Bqkv": (3 * d,), "Wo": (d, d),
                       "Bo": (d,), "W1": (d, 4 * d), "B1": (4 * d,),
                       "W2": (4 * d, d), "B2": (d,), "g1": (d,), "be1": (d,),
                       "g2": (d,), "be2": (d,)}.items()}
    w["g1"] = np.abs(w["g1"]) + 0.5
    w["g2"] = np.abs(w["g2"]) + 0.5
    scale = np.float32(1.0 / np.sqrt(dh))
    nodes = [
        _node("LayerNormalization", ["x", "g1", "be1"], ["ln1"], name="ln1"),
        _node("MatMul", ["ln1", "Wqkv"], ["qkv0"], name="qkv"),
        _node("Add", ["qkv0", "Bqkv"], ["qkv1"], name="qkv_b"),
        _node("Split", ["qkv1"], ["q", "k", "v"], name="split", axis=2,
              split=[d, d, d]),
        _node("Reshape", ["q", "hshape"], ["q4"], name="q4"),
        _node("Transpose", ["q4"], ["qh"], name="qh", perm=[0, 2, 1, 3]),
        _node("Reshape", ["k", "hshape"], ["k4"], name="k4"),
        _node("Transpose", ["k4"], ["kh"], name="kh", perm=[0, 2, 3, 1]),
        _node("Reshape", ["v", "hshape"], ["v4"], name="v4"),
        _node("Transpose", ["v4"], ["vh"], name="vh", perm=[0, 2, 1, 3]),
        _node("MatMul", ["qh", "kh"], ["logits"], name="logits"),
        _node("Mul", ["logits", "scale"], ["scaled"], name="scale"),
        _node("Softmax", ["scaled"], ["probs"], name="probs", axis=-1),
        _node("MatMul", ["probs", "vh"], ["ctx"], name="ctx"),
        _node("Transpose", ["ctx"], ["ctxT"], name="ctxT", perm=[0, 2, 1, 3]),
        _node("Reshape", ["ctxT", "dshape"], ["ctx2"], name="ctx2"),
        _node("MatMul", ["ctx2", "Wo"], ["proj0"], name="proj"),
        _node("Add", ["proj0", "Bo"], ["proj1"], name="proj_b"),
        _node("Add", ["proj1", "x"], ["res1"], name="res1"),
        _node("LayerNormalization", ["res1", "g2", "be2"], ["ln2"],
              name="ln2"),
        _node("MatMul", ["ln2", "W1"], ["up0"], name="up"),
        _node("Add", ["up0", "B1"], ["up1"], name="up_b"),
        _node("Mul", ["up1", "inv_sqrt2"], ["g_in"], name="g_in"),
        _node("Erf", ["g_in"], ["g_erf"], name="g_erf"),
        _node("Add", ["g_erf", "one"], ["g_1p"], name="g_1p"),
        _node("Mul", ["up1", "g_1p"], ["g_m"], name="g_m"),
        _node("Mul", ["g_m", "half"], ["gelu"], name="g_half"),
        _node("MatMul", ["gelu", "W2"], ["down0"], name="down"),
        _node("Add", ["down0", "B2"], ["down1"], name="down_b"),
        _node("Add", ["down1", "res1"], ["y"], name="res2")]
    consts = {"hshape": np.asarray([b, s, h, dh], np.int64),
              "dshape": np.asarray([b, s, d], np.int64),
              "scale": np.asarray([scale], np.float32),
              "inv_sqrt2": np.asarray([1.0 / np.sqrt(2.0)], np.float32),
              "one": np.asarray([1.0], np.float32),
              "half": np.asarray([0.5], np.float32)}
    inits = [_tensor(k, v) for k, v in {**w, **consts}.items()]
    m = _model_dict(nodes, [_vi("x", (b, s, d))], [_vi("y", (b, s, d))],
                    inits)

    def ref(x, t):
        ln1 = F.layer_norm(x, (d,), t["g1"], t["be1"])
        q, k, v = (ln1 @ t["Wqkv"] + t["Bqkv"]).split(d, dim=2)
        qh, kh, vh = (z.reshape(b, s, h, dh).permute(0, 2, 1, 3)
                      for z in (q, k, v))
        probs = torch.softmax(qh @ kh.transpose(-1, -2) * float(scale), -1)
        ctx = (probs @ vh).permute(0, 2, 1, 3).reshape(b, s, d)
        res1 = ctx @ t["Wo"] + t["Bo"] + x
        ln2 = F.layer_norm(res1, (d,), t["g2"], t["be2"])
        return F.gelu(ln2 @ t["W1"] + t["B1"]) @ t["W2"] + t["B2"] + res1
    return m, w, (b, s, d), ref, 2e-4


def _bn(rng, c=4):
    w = {"g": rng.normal(size=(c,)) + 1.0, "b": rng.normal(size=(c,)),
         "m": rng.normal(size=(c,)), "v": np.abs(rng.normal(size=(c,))) + 0.5}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    m = _model_dict([_node("BatchNormalization", ["x", "g", "b", "m", "v"],
                           ["y"], name="bn", epsilon=1e-5)],
                    [_vi("x", (2, c, 3, 3))], [_vi("y", (2, c, 3, 3))],
                    [_tensor(k, v) for k, v in w.items()])

    def ref(x, t):
        return F.batch_norm(x, t["m"], t["v"], t["g"], t["b"],
                            training=False, eps=1e-5)
    return m, w, (2, c, 3, 3), ref, 2e-5


GRAPHS = {"cnn": _cnn, "transformer_block": _block, "batchnorm": _bn}


def _import(pkg, buf):
    if pkg == "port":
        om = ONNXModel(proto.decode(buf, proto.MODEL_PROTO))
        ff = FFModel(FFConfig(batch_size=2))
    else:
        om = JONNXModel(jproto.decode(buf, jproto.MODEL_PROTO))
        ff = JFFModel(JFFConfig(batch_size=2, mesh_shape={"data": 1},
                                log_level="warning"))
    (y,) = om.apply(ff)
    kw = {"device": "cpu"} if pkg == "port" else {}
    cm = ff.compile(loss_type="identity", metrics=[], outputs=[y], **kw)
    cm.init(seed=0)
    om.import_weights(cm)
    return om, ff, cm


def test_proto_encodes_as_jax_and_decodes_jax_bytes():
    m, _, _, _, _ = _block(np.random.default_rng(0))
    buf = proto.encode(m)
    assert buf == jproto.encode(m)
    got = proto.decode(jproto.encode(m), proto.MODEL_PROTO)
    want = jproto.decode(buf, jproto.MODEL_PROTO)
    assert [n.op_type for n in got.graph.node] == \
        [n.op_type for n in want.graph.node]
    assert [(t.name, t.dims, t.raw_data) for t in got.graph.initializer] == \
        [(t.name, t.dims, t.raw_data) for t in want.graph.initializer]


@pytest.mark.parametrize("which", sorted(GRAPHS))
def test_import_matches_jax_and_torch(which):
    rng = np.random.default_rng(3)
    m, w, xshape, ref, tol = GRAPHS[which](rng)
    buf = proto.encode(m)
    pom, pff, pcm = _import("port", buf)
    _, jff, jcm = _import("jax", buf)
    assert [(l.name, l.op_type.value, [t.shape for t in l.outputs])
            for l in pff.layers] == \
        [(l.name, l.op_type.value, [t.shape for t in l.outputs])
         for l in jff.layers]
    x = rng.normal(size=xshape).astype(np.float32)
    got = pcm.forward(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jcm.forward(x)), rtol=1e-5,
                               atol=1e-5)
    want = ref(torch.from_numpy(x),
               {k: torch.from_numpy(v) for k, v in w.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if which == "batchnorm":
        for key, arr in (("mean", w["m"]), ("var", w["v"])):
            t = pcm.state[f"bn/{key}"]
            assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), arr)


@pytest.mark.parametrize("op,fn", [("Add", torch.add), ("Sub", torch.sub),
                                   ("Mul", torch.mul), ("Div", torch.div)])
def test_binary_ops_match_torch(op, fn):
    m = _model_dict([_node(op, ["in0", "in1"], ["out"], name=f"/{op}")],
                    [_vi("in0", (1, 16)), _vi("in1", (1, 16))],
                    [_vi("out", (1, 16))])
    _, ff, cm = _import("port", proto.encode(m))
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(1, 16)).astype(np.float32) + 3 for _ in "ab")
    got = cm.forward(a, b).numpy()
    np.testing.assert_allclose(got, fn(torch.tensor(a), torch.tensor(b)),
                               rtol=1e-6)


def test_unknown_op_fails_loudly():
    m = _model_dict([_node("NotARealOp", ["x"], ["y"])],
                    [_vi("x", (1, 4))], [_vi("y", (1, 4))])
    om = ONNXModel(proto.decode(proto.encode(m), proto.MODEL_PROTO))
    with pytest.raises(NotImplementedError, match="NotARealOp"):
        om.apply(FFModel(FFConfig(batch_size=1)))


def test_model_loads_from_a_file(tmp_path):
    m, _, _, _, _ = _cnn(np.random.default_rng(0))
    path = tmp_path / "cnn.onnx"
    path.write_bytes(proto.encode(m))
    om = ONNXModel(str(path))
    assert om.model.producer_name == "test"
    assert [n.op_type for n in om.graph.node] == \
        ["Conv", "Relu", "MaxPool", "Flatten", "Gemm"]
