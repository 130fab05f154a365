"""The port's op lowerings, losses and metrics against the JAX package's.

Each op is built by both packages' FFModel builders on graph inputs of the
same specs, so the two layers carry the same params and shape inference;
the same numpy inputs and weights, drawn from a seed, go through both
lowerings (JAX eagerly on the CPU, the port on CPU tensors) in f32. The
outputs, their specs, the weight specs, the forward flops the cost model
reads and, for the training ops (conv, pool, batch norm), the input and
weight gradients must agree at atol 1e-5 unless a case says otherwise.
Batch norm is also held across three training steps of running stats and
in inference mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.losses import compute_loss as jcompute_loss
from flexflow_tpu.metrics import compute_metrics as jcompute_metrics
from flexflow_tpu.ops.registry import LoweringCtx as JLoweringCtx
from flexflow_tpu.ops.registry import get_op_def as jget_op_def
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.tensor import Tensor
from flexflow_tpu_torch.losses import LossType, compute_loss
from flexflow_tpu_torch.metrics import MetricsType, compute_metrics
from flexflow_tpu_torch.ops.registry import LoweringCtx, get_op_def

ATOL = 1e-5
CONV_SCALED = 1e-6
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _guids_in_step():
    """Leave both packages' layer and tensor guid counters equal after each
    test (they start a layer's default name): this file builds models in
    one package alone, and other files in the process build unnamed
    layers in both and compare their names."""
    yield
    from flexflow_tpu.core.layer import Layer as JLayer
    from flexflow_tpu.core.tensor import Tensor as JTensor

    for a, b in ((JLayer, Layer), (JTensor, Tensor)):
        a._next_guid[0] = b._next_guid[0] = max(a._next_guid[0],
                                                b._next_guid[0])


def _pair(build, *specs, seq_length=0):
    """(JAX layer, port layer): `build(model, *inputs)` on graph inputs of
    `specs` ((shape, dtype) pairs), the last layer it adds."""
    layers = []
    for M, C in ((JFFModel, JFFConfig), (FFModel, FFConfig)):
        m = M(C(seq_length=seq_length))
        ins = [m.create_tensor(shape, dtype) for shape, dtype in specs]
        build(m, *ins)
        layers.append(m.layers[-1])
    jl, pl = layers
    assert jl.params == pl.params
    for jo, po in zip(jl.outputs, pl.outputs):
        assert (jo.shape, jo.dtype.value) == (po.shape, po.dtype.value)
    assert {w: (s.shape, s.dtype.value) for w, s in jl.weight_specs.items()} \
        == {w: (s.shape, s.dtype.value) for w, s in pl.weight_specs.items()}
    assert get_op_def(pl.op_type).flop_count(pl) == \
        jget_op_def(jl.op_type).flop_count(jl)
    return jl, pl


def _weights(layer, rng):
    return {w: (1.0 + 0.1 * rng.standard_normal(s.shape)
                if w == "gamma" else rng.standard_normal(s.shape))
            .astype(np.float32) for w, s in layer.weight_specs.items()}


def _lower(jl, pl, arrays, weights=None, training=False, jstate=None,
           pstate=None, compute_dtype=None):
    """Both lowerings on the same arrays: (jax outputs, port outputs, jax
    new state, port new state)."""
    weights = weights or {}
    jctx = JLoweringCtx(training=training, state=dict(jstate or {}),
                        compute_dtype=compute_dtype)
    jout = jget_op_def(jl.op_type).lower(
        jl, [jnp.asarray(a) for a in arrays],
        {k: jnp.asarray(v) for k, v in weights.items()}, jctx)
    pctx = LoweringCtx(training=training, state=dict(pstate or {}),
                       device=CPU,
                       compute_dtype=(None if compute_dtype is None
                                      else getattr(torch, compute_dtype)))
    pout = get_op_def(pl.op_type).lower(
        pl, [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays],
        {k: torch.from_numpy(v) for k, v in weights.items()}, pctx)
    return jout, pout, jctx.new_state, pctx.new_state


def _tol(want, atol, scaled):
    """atol, or `scaled` x max |want| where that is larger (an error
    relative to the array's largest value)."""
    return max(atol, scaled * float(np.abs(np.asarray(want)).max()))


def _same(jout, pout, atol=ATOL, scaled=0.0):
    assert len(jout) == len(pout)
    for j, p in zip(jout, pout):
        j = np.asarray(j)
        atol = _tol(j, atol, scaled)
        assert tuple(p.shape) == j.shape
        assert str(p.dtype).replace("torch.", "") == str(j.dtype)
        if j.dtype == np.bool_ or np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(p.numpy(), j)
        else:
            np.testing.assert_allclose(p.float().numpy(), j.astype(np.float32),
                                       atol=atol, rtol=0)


def _grads_same(jl, pl, arrays, weights, atol=ATOL, scaled=0.0,
                training=False):
    """The input and weight gradients of sum(out * cotangent), by jax.vjp
    and by autograd, for one random cotangent."""
    rng = np.random.default_rng(7)

    def jf(xs, ws):
        ctx = JLoweringCtx(training=training)
        return jget_op_def(jl.op_type).lower(jl, xs, ws, ctx)[0]

    jx = [jnp.asarray(a) for a in arrays]
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    out, vjp = jax.vjp(jf, jx, jw)
    ct = rng.standard_normal(out.shape).astype(np.float32)
    jgx, jgw = vjp(jnp.asarray(ct))
    px = [torch.from_numpy(a).requires_grad_() for a in arrays]
    pw = {k: torch.from_numpy(v).requires_grad_() for k, v in weights.items()}
    y = get_op_def(pl.op_type).lower(
        pl, px, pw, LoweringCtx(training=training, device=CPU))[0]
    got = torch.autograd.grad((y * torch.from_numpy(ct)).sum(),
                              px + list(pw.values()))
    want = list(jgx) + [jgw[k] for k in pw]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=_tol(w, atol, scaled))


F32 = "float32"


# ------------------------------------------------------------------- conv
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", [0, 1, 3])
@pytest.mark.parametrize("bias_act", [(True, None), (False, "relu"),
                                      (True, "sigmoid")])
def test_conv2d(groups, stride, padding, bias_act):
    use_bias, act = bias_act
    k = 7 if padding == 3 else 3
    jl, pl = _pair(lambda m, x: m.conv2d(
        x, 8, k, k, stride, stride, padding, padding, activation=act,
        groups=groups, use_bias=use_bias), ((2, 8, 11, 11), F32))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 11, 11)).astype(np.float32)
    w = _weights(pl, rng)
    assert ("bias" in w) == use_bias
    assert w["kernel"].shape == (8, 8 // groups, k, k)
    # a conv output sums up to 8 * 49 products of unit normals (|y| up to
    # ~40; the weight gradients sum 2 * 121 such terms): f32 in another
    # summation order, held at atol 1e-5 or CONV_SCALED of the array's
    # largest value, whichever is larger
    jout, pout, _, _ = _lower(jl, pl, [x], w)
    _same(jout, pout, scaled=CONV_SCALED)
    _grads_same(jl, pl, [x], w, scaled=CONV_SCALED)


# ------------------------------------------------------------------- pool
@pytest.mark.parametrize("pool_type", ["max", "avg"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", [0, 1])
def test_pool2d(pool_type, stride, padding):
    act = "relu" if pool_type == "avg" else None
    jl, pl = _pair(lambda m, x: m.pool2d(
        x, 3, 3, stride, stride, padding, padding, pool_type=pool_type,
        activation=act), ((2, 3, 9, 9), F32))
    x = np.random.default_rng(1).standard_normal((2, 3, 9, 9)) \
        .astype(np.float32)
    jout, pout, _, _ = _lower(jl, pl, [x])
    _same(jout, pout)
    _grads_same(jl, pl, [x], {})


def test_flat():
    jl, pl = _pair(lambda m, x: m.flat(x), ((2, 3, 4, 5), F32))
    x = np.random.default_rng(2).standard_normal((2, 3, 4, 5)) \
        .astype(np.float32)
    _same(*_lower(jl, pl, [x])[:2])


# -------------------------------------------------------------- batchnorm
@pytest.mark.parametrize("shape", [(4, 6, 5, 5), (8, 6)])
@pytest.mark.parametrize("relu", [True, False])
def test_batchnorm_train_three_steps_then_eval(shape, relu):
    """Three training steps thread the running stats (momentum 0.9 on the
    old value, the biased batch variance) through `new_state`; the
    outputs, both stats after each step, and the gradients agree; then
    inference normalizes with the stats, and before any step with 0, 1."""
    jl, pl = _pair(lambda m, x: m.batch_norm(x, relu=relu, name="bn"),
                   (shape, F32))
    rng = np.random.default_rng(3)
    w = _weights(pl, rng)
    js, ps = {}, {}
    for step in range(3):
        x = (2.0 + 3.0 * rng.standard_normal(shape)).astype(np.float32)
        jout, pout, jns, pns = _lower(jl, pl, [x], w, training=True,
                                      jstate=js, pstate=ps)
        _same(jout, pout)
        assert sorted(pns) == sorted(jns) == ["bn/mean", "bn/var"]
        for key in jns:
            assert pns[key].dtype == torch.float32
            assert not pns[key].requires_grad
            np.testing.assert_allclose(pns[key].numpy(), np.asarray(jns[key]),
                                       atol=ATOL, rtol=0)
        js = dict(js, **jns)
        ps = dict(ps, **pns)
    # the running mean moved 1 - 0.9**3 of the way to ~2
    assert 0.3 < float(ps["bn/mean"].mean()) < 0.8
    _grads_same(jl, pl, [x], w, training=True)
    x = rng.standard_normal(shape).astype(np.float32)
    for jstate, pstate in (({}, {}), (js, ps)):
        jout, pout, jns, pns = _lower(jl, pl, [x], w, jstate=jstate,
                                      pstate=pstate)
        _same(jout, pout)
        assert jns == {} and pns == {}


# ---------------------------------------------------- elementwise and cast
UNARY = ["relu", "identity", "sigmoid", "tanh", "elu", "gelu", "erf", "silu",
         "exp", "log", "sin", "cos", "sqrt", "rsqrt"]
SCALAR = [("pow", 3.0), ("scalar_multiply", -1.5), ("scalar_add", 0.25),
          ("scalar_sub", 2.0), ("scalar_true_divide", 4.0)]


@pytest.mark.parametrize("op", UNARY + [s[0] for s in SCALAR])
def test_unary_and_scalar_ops(op):
    kw = dict(SCALAR).get(op)
    positive = op in ("log", "sqrt", "rsqrt")

    def build(m, x):
        fn = getattr(m, op)
        if kw is None:
            return fn(x)
        return fn(x, **({"exponent": kw} if op == "pow" else {"scalar": kw}))

    jl, pl = _pair(build, ((3, 17), F32))
    x = np.random.default_rng(4).standard_normal((3, 17)).astype(np.float32)
    if positive:
        x = np.abs(x) + 0.1
    _same(*_lower(jl, pl, [x])[:2])


def test_scalar_floor_divide():
    """SCALAR_FLOOR_DIV has a lowering and no builder in either package."""
    from flexflow_tpu.ops.op_type import OperatorType as JOT
    from flexflow_tpu_torch.ops.op_type import OperatorType

    jl, pl = _pair(lambda m, x: m._unary(
        JOT.SCALAR_FLOOR_DIV if isinstance(m, JFFModel)
        else OperatorType.SCALAR_FLOOR_DIV, x, scalar=0.75), ((4, 9), F32))
    x = 3 * np.random.default_rng(5).standard_normal((4, 9)).astype(np.float32)
    _same(*_lower(jl, pl, [x])[:2])


@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "divide",
                                "max", "min", "equal", "greater", "less"])
def test_binary_ops_broadcast(op):
    """Every binary op, the second operand broadcast along dim 0; the
    comparisons (no builder: `_binary` with the op type) return bool."""
    from flexflow_tpu.ops.op_type import OperatorType as JOT
    from flexflow_tpu_torch.ops.op_type import OperatorType

    def build(m, a, b):
        if hasattr(m, op):
            return getattr(m, op)(a, b)
        ot = JOT if isinstance(m, JFFModel) else OperatorType
        return m._binary(getattr(ot, f"EW_{op.upper()}"), a, b)

    jl, pl = _pair(build, ((4, 6), F32), ((1, 6), F32))
    rng = np.random.default_rng(6)
    a = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((1, 6)).astype(np.float32)
    a[0] = b[0]     # some equal pairs
    _same(*_lower(jl, pl, [a, b])[:2])


@pytest.mark.parametrize("to", ["bfloat16", "int32", "float32"])
def test_cast(to):
    jl, pl = _pair(lambda m, x: m.cast(x, to), ((3, 8), F32))
    x = 5 * np.random.default_rng(7).standard_normal((3, 8)).astype(np.float32)
    _same(*_lower(jl, pl, [x])[:2], atol=0)


# --------------------------------------------------------------- shape ops
def _arr(shape, seed=8):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


SHAPE_CASES = {
    "reshape": (lambda m, x: m.reshape(x, [4, -1]), [(2, 6, 5)]),
    "transpose": (lambda m, x: m.transpose(x, [0, 2, 1]), [(2, 6, 5)]),
    "concat": (lambda m, a, b: m.concat([a, b], axis=-1),
               [(2, 3, 4), (2, 3, 2)]),
    "split": (lambda m, x: m.split(x, [2, 4], axis=1), [(3, 6, 2)]),
    "split_even": (lambda m, x: m.split(x, 3, axis=1), [(3, 6, 2)]),
    "reverse": (lambda m, x: m.reverse(x, axis=1), [(3, 5)]),
    "pad": (lambda m, x: m.pad(x, [(0, 0), (1, 2), (3, 0)], value=-2.0),
            [(2, 3, 4)]),
    "slice": (lambda m, x: m.slice_tensor(x, (0, 1, 2), (2, 4, 5)),
              [(3, 5, 6)]),
    "expand": (lambda m, x: m.expand(x, [2, -1, 4]), [(3, 1)]),
}


@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_shape_ops(case):
    build, shapes = SHAPE_CASES[case]
    jl, pl = _pair(build, *[(s, F32) for s in shapes])
    arrays = [_arr(s, seed=i) for i, s in enumerate(shapes)]
    _same(*_lower(jl, pl, arrays)[:2], atol=0)


def test_gather():
    jl, pl = _pair(lambda m, x, i: m.gather(x, i, dim=1),
                   ((3, 5), F32), ((3, 4), "int32"))
    idx = np.random.default_rng(9).integers(0, 5, (3, 4)).astype(np.int32)
    _same(*_lower(jl, pl, [_arr((3, 5)), idx])[:2], atol=0)


def test_where_and_masked_fill():
    mask = np.random.default_rng(10).integers(0, 2, (3, 4)).astype(np.bool_)
    jl, pl = _pair(lambda m, c, a, b: m.where(c, a, b), ((3, 4), "bool"),
                   ((3, 4), F32), ((1, 4), F32))
    _same(*_lower(jl, pl, [mask, _arr((3, 4)), _arr((1, 4), 1)])[:2], atol=0)
    jl, pl = _pair(lambda m, x, c: m.masked_fill(x, c, -1e4),
                   ((3, 4), F32), ((3, 4), "bool"))
    _same(*_lower(jl, pl, [_arr((3, 4)), mask])[:2], atol=0)


@pytest.mark.parametrize("value", [np.arange(6, dtype=np.int64).reshape(2, 3),
                                   np.linspace(0, 1, 4),
                                   np.ones((2, 2), np.float32)])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_constant(value, compute_dtype):
    """64-bit constants narrow as JAX holds them with x64 off; floating
    ones take the compute dtype under the mixed policy."""
    jl, pl = _pair(lambda m: m.constant(value))
    _same(*_lower(jl, pl, [], compute_dtype=compute_dtype)[:2], atol=0)


# -------------------------------------------------------------- reductions
@pytest.mark.parametrize("op", ["reduce_sum", "reduce_mean", "mean"])
@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axes", [[2, 3], [-1], [0, 1, 2, 3]])
def test_reductions(op, keepdims, axes):
    jl, pl = _pair(lambda m, x: getattr(m, op)(x, axes, keepdims=keepdims),
                   ((2, 3, 4, 5), F32))
    _same(*_lower(jl, pl, [_arr((2, 3, 4, 5))])[:2])


@pytest.mark.parametrize("op", ["REDUCE_MAX", "REDUCE_MIN", "ARGMIN"])
def test_reductions_without_builders(op):
    """reduce_max, reduce_min and argmin have lowerings and no builder in
    either package."""
    from flexflow_tpu.ops.op_type import OperatorType as JOT
    from flexflow_tpu_torch.ops.op_type import OperatorType

    params = {"axis": 1} if op == "ARGMIN" else {"axes": (1,),
                                                 "keepdims": True}

    def build(m, x):
        ot = JOT if isinstance(m, JFFModel) else OperatorType
        return m._add_layer(getattr(ot, op), dict(params), [x])[0]

    jl, pl = _pair(build, ((3, 7, 2), F32))
    _same(*_lower(jl, pl, [_arr((3, 7, 2))])[:2], atol=0)


def test_argmax_and_top_k():
    x = _arr((4, 9))
    jl, pl = _pair(lambda m, t: m.argmax(t, axis=-1), ((4, 9), F32))
    _same(*_lower(jl, pl, [x])[:2], atol=0)
    jl, pl = _pair(lambda m, t: m.top_k(t, 3), ((4, 9), F32))
    _same(*_lower(jl, pl, [x])[:2], atol=0)


# ------------------------------------------------------------ bmm, softmax
@pytest.mark.parametrize("seq_length", [0, 5])
def test_batch_matmul(seq_length):
    """With the config's seq_length, the a/b seq dims are cut to it at
    shape inference and at run time."""
    jl, pl = _pair(lambda m, a, b: m.batch_matmul(a, b, a_seq_length_dim=1,
                                                  b_seq_length_dim=2),
                   ((2, 8, 6), F32), ((2, 6, 8), F32), seq_length=seq_length)
    want = (2, seq_length or 8, seq_length or 8)
    assert pl.outputs[0].shape == want
    jout, pout, _, _ = _lower(jl, pl, [_arr((2, 8, 6)), _arr((2, 6, 8), 1)])
    _same(jout, pout)
    assert tuple(pout[0].shape) == want


@pytest.mark.parametrize("op", ["softmax", "log_softmax"])
@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax(op, axis):
    jl, pl = _pair(lambda m, x: getattr(m, op)(x, axis=axis),
                   ((3, 5, 7), F32))
    _same(*_lower(jl, pl, [4 * _arr((3, 5, 7))])[:2])


# -------------------------------------------------------- losses, metrics
def _loss_inputs(kind):
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((6, 10)).astype(np.float32)
    if kind == "sparse":
        return logits, rng.integers(0, 10, (6,)).astype(np.int32)
    if kind == "dense":
        lab = rng.random((6, 10)).astype(np.float32)
        return logits, lab / lab.sum(-1, keepdims=True)
    out = rng.random((64, 1)).astype(np.float32)    # DLRM: (b, 1) clicks
    return out, rng.random((64, 1)).astype(np.float32)


LOSSES = [("sparse_categorical_crossentropy", "sparse", True),
          ("sparse_categorical_crossentropy", "sparse", False),
          ("categorical_crossentropy", "dense", True),
          ("categorical_crossentropy", "dense", False),
          ("mean_squared_error", "regress", True),
          ("mean_squared_error_avg_reduce", "regress", True),
          ("identity", "regress", True)]


@pytest.mark.parametrize("loss,kind,from_logits", LOSSES)
def test_losses(loss, kind, from_logits):
    out, lab = _loss_inputs(kind)
    if not from_logits:      # probabilities
        out = np.exp(out) / np.exp(out).sum(-1, keepdims=True)
    want = jcompute_loss(loss, jnp.asarray(out), jnp.asarray(lab),
                         from_logits=from_logits)
    x = torch.from_numpy(out).requires_grad_()
    got = compute_loss(LossType.from_any(loss), x, torch.from_numpy(lab),
                       from_logits=from_logits)
    assert got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(want), atol=ATOL,
                               rtol=1e-6)
    jg = jax.grad(lambda o: jcompute_loss(loss, o, jnp.asarray(lab),
                                          from_logits=from_logits))(
        jnp.asarray(out))
    (pg,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=ATOL)


@pytest.mark.parametrize("kind,metrics", [
    ("sparse", ["accuracy", "sparse_categorical_crossentropy"]),
    ("dense", ["accuracy", "categorical_crossentropy"]),
    ("regress", ["mean_squared_error", "root_mean_squared_error",
                 "mean_absolute_error"])])
def test_metrics(kind, metrics):
    """Every metric; accuracy with int labels and with one-hot labels
    (argmax of both)."""
    out, lab = _loss_inputs(kind)
    if kind == "dense":
        lab = np.eye(10, dtype=np.float32)[np.argmax(lab, -1)]
        out[:3] = lab[:3] * 5     # half the rows right
    want = jcompute_metrics(metrics, jnp.asarray(out), jnp.asarray(lab))
    got = compute_metrics([MetricsType.from_any(m) for m in metrics],
                          torch.from_numpy(out), torch.from_numpy(lab))
    assert sorted(got) == sorted(want) == sorted(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=ATOL,
                                   rtol=1e-6)
