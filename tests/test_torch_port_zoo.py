"""The rest of the port's op vocabulary, its FFModel API and the model
zoo against the JAX package's, on the CPU.

- scaled-dot-product attention (bool mask, float mask, causal, a fully
  masked row, dropout on JAX's mask): output and gradients within 1e-5 in
  f32; multi-head attention with add_bias_kv / add_zero_attn (causal and
  not): forward and one SGD step within 1e-5;
- the graph's dominators and post-dominators equal JAX's, and `dot()`'s
  text is byte-equal to JAX's, before and after compile, with and without
  costs; `--compgraph` writes it at compile;
- a loss with L1 and L2 weight regularizers agrees with JAX's (relative
  1e-6), and one SGD step's params within 1e-6; the K-step path adds them
  too;
- ConstantInitializer equals JAX's exactly; Uniform and Norm are held to
  their bounds and moments (5 standard errors);
- one training step of each of the seven models at a small size
  (AlexNet's CIFAR-10 variant, Inception-v3's `inception_a`/`inception_b`
  blocks at 9x9, the MLP, CANDLE Uno, XDL, MoE-MLP and the branch
  ensemble) from JAX's initial params: the loss within 1e-5 relative, and
  every param after an SGD step of lr 1 (it moves by its gradient) within
  1e-5; dropout is fed JAX's masks (`mask_hook`), batch-norm state is
  compared too;
- each of them (the ImageNet AlexNet too) built at its JAX defaults, not
  compiled: the same layers, params, weight specs, outputs and flops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu.models as jmodels
import flexflow_tpu_torch.models as pmodels
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.core.graph import dominators as jdominators
from flexflow_tpu.core.graph import post_dominators as jpost_dominators
from flexflow_tpu.initializers import ConstantInitializer as JConstant
from flexflow_tpu.ops.registry import LoweringCtx as JLoweringCtx
from flexflow_tpu.ops.registry import get_op_def as jget_op_def
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch import random as ff_random
from flexflow_tpu_torch.convert import (params_from_jax, params_to_numpy,
                                        state_from_jax)
from flexflow_tpu_torch.core.graph import dominators, post_dominators
from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.initializers import (ConstantInitializer,
                                             NormInitializer,
                                             UniformInitializer)
from flexflow_tpu_torch.ops.registry import LoweringCtx, get_op_def

from test_torch_port_moe import sync_guids

TOL = 1e-5
REG_RTOL = 1e-6
JKW = dict(mesh_shape={"data": 1}, only_data_parallel=True,
           log_level="warning")


@pytest.fixture(autouse=True)
def _guids_in_step():
    sync_guids()
    yield
    sync_guids()


def _pair(build, **cfg):
    start = sync_guids()
    out = []
    for ffm, ffc, kw in ((JFFModel, JFFConfig, JKW), (FFModel, FFConfig, {})):
        sync_guids(start)
        m = ffm(ffc(**kw, **cfg))
        build(m)
        out.append(m)
    sync_guids()
    return out


# ----------------------------------------------------------------- SDPA
def _sdpa_layers(shapes, mask_dtype, **params):
    out = []
    for ffm, ffc in ((JFFModel, JFFConfig), (FFModel, FFConfig)):
        m = ffm(ffc())
        q, k, v = (m.create_tensor(list(s), name=n)
                   for s, n in zip(shapes, "qkv"))
        mask = (m.create_tensor(list(shapes[3]), mask_dtype, name="mask")
                if len(shapes) > 3 else None)
        m.scaled_dot_product_attention(q, k, v, attn_mask=mask, name="sdpa",
                                       **params)
        out.append(m.layers[-1])
    return out


SDPA_CASES = ["bool_mask", "float_mask", "causal", "masked_row", "scale",
              "dropout"]


@pytest.mark.parametrize("case", SDPA_CASES)
def test_sdpa_matches_jax(case):
    b, h, sq, sk, d = 2, 3, 5, 7, 4
    rng = np.random.default_rng(SDPA_CASES.index(case))
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sk, 6)).astype(np.float32)
    shapes = [q.shape, k.shape, v.shape]
    params = {}
    mask = None
    if case in ("bool_mask", "masked_row"):
        mask = rng.uniform(size=(b, 1, sq, sk)) > 0.3
        if case == "masked_row":
            mask[0, 0, 2, :] = False  # every key masked: V averaged
        shapes.append(mask.shape)
    elif case == "float_mask":
        mask = rng.normal(size=(sq, sk)).astype(np.float32)
        shapes.append(mask.shape)
    elif case == "causal":
        params["is_causal"] = True
    elif case == "scale":
        params["scale"] = 0.3
    elif case == "dropout":
        params["dropout_p"] = 0.25
    jl, pl = _sdpa_layers(shapes, "bool" if mask is not None
                          and mask.dtype == bool else "float32", **params)
    assert pl.outputs[0].spec.shape == jl.outputs[0].spec.shape
    assert get_op_def(pl.op_type).flop_count(pl) == \
        jget_op_def(jl.op_type).flop_count(jl)
    jkey = jax.random.PRNGKey(5)
    training = case == "dropout"
    g = rng.normal(size=(b, h, sq, 6)).astype(np.float32)
    extra = [] if mask is None else [mask]

    def jf(q_, k_, v_):
        return jget_op_def(jl.op_type).lower(
            jl, [q_, k_, v_] + [jnp.asarray(m_) for m_ in extra], {},
            JLoweringCtx(training=training, rng=jkey))[0]

    jy, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    hook = None
    if training:
        def hook(layer, rng_, shape, keep):
            return torch.from_numpy(np.array(jax.random.bernoulli(
                jax.random.fold_in(jkey, jl.guid), keep, shape)))
    ctx = LoweringCtx(training=training, rng=ff_random.key(0),
                      mask_hook=hook)
    py = get_op_def(pl.op_type).lower(
        pl, ts + [torch.from_numpy(np.array(m_)) for m_ in extra], {}, ctx)[0]
    py.backward(torch.from_numpy(g))
    got = py.detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jy), atol=TOL, rtol=TOL)
    for t, want in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)
    if case == "masked_row":  # the uniform average of V, not NaN
        np.testing.assert_allclose(got[0, 0, 2], v[0, 0].mean(0), atol=TOL)


def _mha_model(bias_kv, zero_attn, causal):
    def build(m):
        x = m.create_tensor([2, 8, 16], name="x")
        t = m.multihead_attention(x, x, x, 16, 2, add_bias_kv=bias_kv,
                                  add_zero_attn=zero_attn, causal=causal,
                                  name="mha")
        m.dense(t, 4, name="head")
    return build


@pytest.mark.parametrize("bias_kv,zero_attn,causal", [
    (True, False, False), (False, True, False), (True, True, True)])
def test_mha_extra_key_positions_match_jax(bias_kv, zero_attn, causal):
    jm, pm = _pair(_mha_model(bias_kv, zero_attn, causal),
                   compute_dtype="float32")
    jl, pl = jm.layers[0], pm.layers[0]
    assert {w: s.shape for w, s in pl.weight_specs.items()} == \
        {w: s.shape for w, s in jl.weight_specs.items()}
    jcm = jm.compile(JSGDOptimizer(lr=1.0), "mean_squared_error", [])
    jcm.init(seed=0)
    pcm = pm.compile(SGDOptimizer(lr=1.0), "mean_squared_error", [],
                     device="cpu")
    params = jax.device_get(jcm.params)
    if bias_kv:  # JAX initializes them to 0: give them weight
        rng = np.random.default_rng(9)
        for w in ("bias_k", "bias_v"):
            params["mha"][w] = rng.normal(size=(16,)).astype(np.float32)
        jcm.params = jax.device_put(params)
    pcm.load_params(params_from_jax(params))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 16)).astype(np.float32)
    y = rng.normal(size=(2, 8, 4)).astype(np.float32)
    np.testing.assert_allclose(pcm.forward(x).numpy(),
                               np.asarray(jcm.forward(x)), atol=TOL)
    _step_close(jcm, pcm, [x], y)


def _step_close(jcm, pcm, xs, y, rng=None, jkey=None):
    jkey = jax.random.PRNGKey(0) if jkey is None else jkey
    jcm.params, jcm.opt_state, jcm.state, jl, _ = jcm.train_step(
        jcm.params, jcm.opt_state, jcm.state, xs, y, jkey)
    pcm.params, pcm.opt_state, pcm.state, pl, _ = pcm.train_step(
        pcm.params, pcm.opt_state, pcm.state, xs, y, rng)
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL)
    jp, pp = jax.device_get(jcm.params), params_to_numpy(pcm.params)
    assert sorted(pp) == sorted(jp)
    for layer, ws in pp.items():
        for w, a in ws.items():
            np.testing.assert_allclose(a, np.asarray(jp[layer][w]), atol=TOL,
                                       err_msg=f"{layer}.{w}")
    js = jax.device_get(jcm.state)
    assert sorted(pcm.state) == sorted(js)
    for k_, v_ in pcm.state.items():
        np.testing.assert_allclose(v_.numpy(), np.asarray(js[k_]), atol=TOL,
                                   err_msg=k_)
    return float(pl)


# ------------------------------------------------------- graph and dot
def _diamond(m):
    """A residual block and a two-branch join: nontrivial dominators."""
    x = m.create_tensor([4, 8], name="x")
    a = m.dense(x, 8, activation="relu", name="a")
    b = m.dense(a, 8, name="b")
    r = m.add(a, b, name="res")
    c = m.dense(r, 6, name="c")
    d = m.dense(r, 6, activation="tanh")
    m.dense(m.concat([c, d], axis=-1, name="cat"), 3, name="head")


def test_dominators_and_dot_equal_jax(tmp_path):
    jm, pm = _pair(_diamond)

    def names(dom):
        return {k.name: sorted(v.name for v in vs) for k, vs in dom.items()}
    assert names(dominators(pm.layers)) == names(jdominators(jm.layers))
    assert names(post_dominators(pm.layers)) == \
        names(jpost_dominators(jm.layers))
    assert names(dominators(pm.layers))["head"] == ["a", "cat", "head", "res"]
    assert pm.dot() == jm.dot()
    jcm = jm.compile(JSGDOptimizer(lr=0.1), "mean_squared_error", [])
    pm.config.export_dot = str(tmp_path / "g.dot")
    pm.compile(SGDOptimizer(lr=0.1), "mean_squared_error", [], device="cpu")
    assert pm.dot() == jm.dot() and "(data,.)" in pm.dot()
    assert pm.dot(include_costs=True) == jm.dot(include_costs=True)
    assert "us}" in pm.dot(include_costs=True)
    assert (tmp_path / "g.dot").read_text() == pm.dot()
    assert jcm is not None


def test_compgraph_flags_parse_into_jax_fields():
    argv = ["--compgraph", "graph.dot", "--include-costs-dot-graph"]
    jcfg, pcfg = JFFConfig.parse_args(argv), FFConfig.parse_args(argv)
    for f in ("export_dot", "include_costs_dot_graph"):
        assert getattr(pcfg, f) == getattr(jcfg, f)
        assert getattr(FFConfig(), f) == getattr(JFFConfig(), f)
    assert pcfg.export_dot == "graph.dot" and pcfg.include_costs_dot_graph


def test_api_methods_of_jax_ffmodel_all_exist():
    public = {n for n in dir(JFFModel) if not n.startswith("_")}
    assert public <= {n for n in dir(FFModel)}, \
        sorted(public - set(dir(FFModel)))


def test_parallel_op_builders_are_identities_with_jax_params():
    def build(m):
        x = m.create_tensor([4, 6], name="x")
        t = m.repartition(x, 0, "data", name="rp")
        t = m.combine(t, 0, "data", name="cb")
        t = m.replicate(t, name="rep")
        t = m.reduction(t, "model", name="red")
        t = m.all_to_all(t, 0, 1, "model", name="a2a")
        t = m.fused_parallel(t, [["data"], None], name="fp")
        m.dense(t, 2, name="head")
    jm, pm = _pair(build)
    for jl, pl in zip(jm.layers, pm.layers):
        assert (pl.name, pl.op_type.value, pl.params) == \
            (jl.name, jl.op_type.value, jl.params)
    cm = pm.compile(SGDOptimizer(lr=0.1), "mean_squared_error", [],
                    device="cpu")
    cm.init(seed=0)
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    want = x @ cm.get_weight("head", "kernel") + cm.get_weight("head", "bias")
    np.testing.assert_allclose(cm.forward(x).numpy(), want, rtol=1e-6)
    assert pm.get_parameter_by_name("head", "bias").shape == (2,)
    pm.set_parameter_by_name("head", "bias", np.ones(2, np.float32))
    np.testing.assert_array_equal(cm.get_weight("head", "bias"), [1, 1])
    assert [l.name for l in pm.get_layers()] == [l.name for l in pm.layers]


# ------------------------------------------------------- regularizers
def test_regularized_loss_matches_jax():
    def build(m):
        x = m.create_tensor([8, 5], name="x")
        t = m.dense(x, 7, activation="relu", name="d0")
        m.dense(t, 3, name="d1")
        m.add_weight_regularizer("d0", "kernel", "l1", 0.01)
        m.add_weight_regularizer("d1", "kernel", "l2", 0.05)
        m.add_weight_regularizer("d1", "kernel", "l1", 0.002)
    jm, pm = _pair(build, compute_dtype="float32")
    jcm = jm.compile(JSGDOptimizer(lr=1.0), "mean_squared_error", [])
    jcm.init(seed=0)
    pcm = pm.compile(SGDOptimizer(lr=1.0), "mean_squared_error", [],
                     device="cpu")
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 5)).astype(np.float32)
    y = rng.normal(size=(8, 3)).astype(np.float32)
    k0 = pcm.get_weight("d0", "kernel")
    k1 = pcm.get_weight("d1", "kernel")
    penalty = (0.01 * np.abs(k0).sum() + 0.05 * (k1 * k1).sum()
               + 0.002 * np.abs(k1).sum())
    plain = float(pcm.eval_step(pcm.params, pcm.state, [x], y)[0])
    loss = _step_close(jcm, pcm, [x], y)
    np.testing.assert_allclose(loss, plain + penalty, rtol=REG_RTOL)
    # the K-step path (eager on the CPU) takes the same penalties
    pcm2 = pm.compile(SGDOptimizer(lr=1.0), "mean_squared_error", [],
                      device="cpu")
    pcm2.load_params(params_to_numpy(pcm.params))
    p1 = pcm.train_step(pcm.params, pcm.opt_state, pcm.state, [x], y)[3]
    multi = pcm2.make_multi_step(1)
    p2 = multi(pcm2.params, pcm2.opt_state, pcm2.state, [x[None]], y[None],
               ff_random.key(0))[3]
    assert float(p1) == float(p2)


# ------------------------------------------------------- initializers
def test_initializers():
    spec = TensorSpec((64, 32))
    gen = torch.Generator().manual_seed(0)
    got = ConstantInitializer(0.375)(gen, spec, "cpu")
    want = JConstant(0.375)(jax.random.PRNGKey(0),
                            __import__("flexflow_tpu").core.tensor.TensorSpec(
                                (64, 32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = 64 * 32
    u = UniformInitializer(min_value=-0.2, max_value=0.6)(gen, spec, "cpu")
    assert u.shape == (64, 32) and u.dtype == torch.float32
    assert u.min() >= -0.2 and u.max() <= 0.6
    var = 0.8 ** 2 / 12
    assert abs(float(u.mean()) - 0.2) < 5 * (var / n) ** 0.5
    assert abs(float(u.var()) - var) < 5 * var * (0.8 / n) ** 0.5
    z = NormInitializer(mean=1.5, stddev=0.5)(gen, spec, "cpu")
    assert abs(float(z.mean()) - 1.5) < 5 * 0.5 / n ** 0.5
    assert abs(float(z.std()) - 0.5) < 5 * 0.5 / (2 * n) ** 0.5
    assert not torch.equal(UniformInitializer()(gen, spec, "cpu"),
                           UniformInitializer()(gen, spec, "cpu"))


# ------------------------------------------------------------- models
def _inception_blocks(m):
    from flexflow_tpu.models import inception as jinc
    from flexflow_tpu_torch.models import inception as pinc
    inc = jinc if isinstance(m, JFFModel) else pinc
    x = m.create_tensor([2, 8, 9, 9], name="image")
    t = inc.inception_a(m, x, 4, "mixed0")
    t = inc.inception_b(m, t, "mixed3")
    t = m.mean(t, axes=[2, 3], name="gap")
    t = m.dropout(t, 0.5)
    m.dense(t, 5, name="fc")


def _zoo(m):
    return jmodels if isinstance(m, JFFModel) else pmodels


def _alexnet_cifar10(m):
    from flexflow_tpu.models.alexnet import build_alexnet_cifar10 as j
    from flexflow_tpu_torch.models.alexnet import build_alexnet_cifar10 as p
    (j if isinstance(m, JFFModel) else p)(m, batch=4)


def _branchy(m):
    from flexflow_tpu.models.branchy import build_branchy as j
    from flexflow_tpu_torch.models.branchy import build_branchy as p
    (j if isinstance(m, JFFModel) else p)(m, batch=8, width=12, hidden=24,
                                          modules=2, k=4)


CANDLE_SHAPES = {"dose": 1, "cell.rnaseq": 12, "drug.descriptors": 20,
                 "drug.fingerprints": 16}

MODELS = {
    "alexnet_cifar10": (_alexnet_cifar10, "sparse_categorical_crossentropy"),
    "inception_blocks": (_inception_blocks, "sparse_categorical_crossentropy"),
    "mlp": (lambda m: _zoo(m).build_mlp(m, batch=8, in_dim=20,
                                        hidden=(16, 16), classes=4),
            "sparse_categorical_crossentropy"),
    "candle_uno": (lambda m: _zoo(m).build_candle_uno(
        m, batch=8, dense_layers=(16, 16), dense_feature_layers=(8, 8),
        feature_shapes=CANDLE_SHAPES), "mean_squared_error"),
    "xdl": (lambda m: _zoo(m).build_xdl(
        m, batch=8, embedding_size=(100,) * 4, sparse_feature_size=8,
        dense_dim=8, mlp_top=(16, 16, 2)), "sparse_categorical_crossentropy"),
    "moe_mlp": (lambda m: _zoo(m).build_moe_mlp(
        m, batch=8, in_dim=12, num_exp=4, num_select=2, hidden=8,
        classes=4), "sparse_categorical_crossentropy"),
    "branchy": (_branchy, "sparse_categorical_crossentropy"),
}


def _inputs(m, rng):
    xs = []
    for t in m.input_tensors:
        if t.dtype.value == "int32":
            hi = next(l.params["num_entries"] for l in m.layers
                      if t in l.inputs)
            xs.append(rng.integers(0, hi, size=t.shape).astype(np.int32))
        else:
            xs.append(rng.normal(size=t.shape, scale=0.5).astype(np.float32))
    return xs


@pytest.mark.parametrize("which", sorted(MODELS))
def test_model_step_matches_jax(which):
    build, loss = MODELS[which]
    jm, pm = _pair(build, compute_dtype="float32")
    assert [l.name for l in pm.layers] == [l.name for l in jm.layers]
    assert [o.spec.shape for o in pm.layers[-1].outputs] == \
        [o.spec.shape for o in jm.layers[-1].outputs]
    jcm = jm.compile(JSGDOptimizer(lr=1.0), loss, [])
    jcm.init(seed=0)
    pcm = pm.compile(SGDOptimizer(lr=1.0), loss, [], device="cpu")
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))
    pcm.state = state_from_jax(jax.device_get(jcm.state))
    rng = np.random.default_rng(len(which))
    xs = _inputs(pm, rng)
    out = pm.layers[-1].outputs[0].spec.shape
    y = (rng.normal(size=out).astype(np.float32) if loss == "mean_squared_error"
         else rng.integers(0, out[-1], size=out[:1]).astype(np.int32))
    jkey = jax.random.PRNGKey(1)
    pcm.forward_fn.mask_hook = lambda layer, rng_, shape, keep: \
        torch.from_numpy(np.array(jax.random.bernoulli(
            jax.random.fold_in(jkey, layer.guid), keep, shape)))
    loss_v = _step_close(jcm, pcm, xs, y, rng=ff_random.key(1), jkey=jkey)
    assert np.isfinite(loss_v)


def _full(which):
    """The builders at their JAX defaults (the chip's phase 14 widths)."""
    def build(m):
        zoo = _zoo(m)
        if which == "alexnet":
            zoo.build_alexnet(m)
        elif which == "inception_v3":
            zoo.build_inception_v3(m)
        elif which == "mlp":
            zoo.build_mlp(m, 64, 784)
        elif which == "candle_uno":
            zoo.build_candle_uno(m)
        elif which == "xdl":
            zoo.build_xdl(m)
        elif which == "moe_mlp":
            zoo.build_moe_mlp(m)
        else:
            from flexflow_tpu.models.branchy import build_branchy as j
            from flexflow_tpu_torch.models.branchy import build_branchy as p
            (j if isinstance(m, JFFModel) else p)(m)
    return build


@pytest.mark.parametrize("which", ["alexnet", "inception_v3", "mlp",
                                   "candle_uno", "xdl", "moe_mlp", "branchy"])
def test_full_size_builders_equal_jax(which):
    jm, pm = _pair(_full(which))
    assert len(pm.layers) == len(jm.layers)
    assert [t.shape for t in pm.input_tensors] == \
        [t.shape for t in jm.input_tensors]
    for jl, pl in zip(jm.layers, pm.layers):
        assert (pl.name, pl.op_type.value) == (jl.name, jl.op_type.value)
        assert pl.params == jl.params, pl.name
        assert {w: s.shape for w, s in pl.weight_specs.items()} == \
            {w: s.shape for w, s in jl.weight_specs.items()}, pl.name
        assert [o.spec.shape for o in pl.outputs] == \
            [o.spec.shape for o in jl.outputs], pl.name
        assert get_op_def(pl.op_type).flop_count(pl) == \
            jget_op_def(jl.op_type).flop_count(jl), pl.name
