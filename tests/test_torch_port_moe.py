"""The port's MoE ops, the MoE-MLP and its expert-parallel search against
the JAX package's, on the CPU.

- group_by: the dispatch buffer and the positions, with overflowed
  choices, element for element (both are copies of the inputs: exact);
- experts and aggregate: outputs and gradients in f32 within 1e-5;
- `moe` (build_moe_mlp at a small size) trains 2 SGD steps to JAX's
  losses (relative 1e-5) and params (absolute 1e-5), from JAX's initial
  params;
- cache: the state it writes while training equals JAX's (exact: a copy);
- the expert candidates (`ep:{axis}`) and the search's choices and cost
  on the MoE-MLP equal JAX's on two "cpu-sim" machines (relative 1e-12,
  the same float sums in the same order), as tests/test_torch_port_search.py
  holds the dense models.

Inputs come from numpy generators with fixed seeds.
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
from flexflow_tpu.core.layer import Layer as JLayer
from flexflow_tpu.core.tensor import Tensor as JTensor
from flexflow_tpu.ops.registry import get_op_def as jget_op_def
from flexflow_tpu.parallel.sharding import Strategy as JStrategy
from flexflow_tpu.parallel.templates import \
    apply_expert_parallel as japply_expert_parallel
from flexflow_tpu.parallel.templates import \
    apply_sharded_embedding as japply_sharded_embedding
from flexflow_tpu.search.candidates import layer_candidates as jlayer_candidates
from flexflow_tpu.search.dp import search_graph as jsearch_graph
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.convert import params_from_jax, params_to_numpy
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.tensor import Tensor
from flexflow_tpu_torch.dtype import DataType
from flexflow_tpu_torch.ops.registry import LoweringCtx, get_op_def
from flexflow_tpu_torch.parallel.default_strategy import data_parallel_strategy
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.parallel.templates import (apply_expert_parallel,
                                                   apply_sharded_embedding)
from flexflow_tpu_torch.search.candidates import layer_candidates
from flexflow_tpu_torch.search.dp import search_graph

from test_torch_port_search import _close, _machines

OP_TOL = 1e-5      # experts / aggregate outputs and gradients, f32
LOSS_RTOL = 1e-5   # 2 SGD steps of the MoE-MLP
PARAM_ATOL = 1e-5

# two machines of the "cpu-sim" chip both packages keep
SEARCH_MACHINES = [{"mesh_axes": {"data": 4, "model": 2}, "chip": "cpu-sim"},
                   {"mesh_axes": {"data": 2, "model": 4}, "chip": "cpu-sim"}]


def sync_guids(start=None):
    """Both packages' layer and tensor guid counters at one value (the
    larger of the two, or `start`): unnamed layers take their names from
    them. Returns the (layer, tensor) values set."""
    out = []
    for i, (a, b) in enumerate(((JLayer, Layer), (JTensor, Tensor))):
        v = (max(a._next_guid[0], b._next_guid[0]) if start is None
             else start[i])
        a._next_guid[0] = b._next_guid[0] = v
        out.append(v)
    return tuple(out)


@pytest.fixture(autouse=True)
def _guids_in_step():
    sync_guids()
    yield
    sync_guids()


def _group_by_pair(b, k, e, d, alpha):
    out = []
    for ffm, ffc, dt in ((JFFModel, JFFConfig, "int32"),
                         (FFModel, FFConfig, DataType.INT32)):
        m = ffm(ffc())
        x = m.create_tensor([b, d], name="x")
        a = m.create_tensor([b, k], dt, name="assign")
        m.group_by(x, a, e, alpha, name="gb")
        out.append(m.layers[-1])
    return out


# (batch, top-k, experts, width, alpha): the last two overflow (a skewed
# assignment and a small capacity factor)
GROUP_CASES = [(16, 2, 8, 6, 2.0), (12, 3, 4, 5, 1.0), (32, 2, 8, 4, 0.5)]


@pytest.mark.parametrize("case", GROUP_CASES)
def test_group_by_buffer_and_positions_equal_jax(case):
    b, k, e, d, alpha = case
    rng = np.random.default_rng(sum(case[:4]))
    x = rng.normal(size=(b, d)).astype(np.float32)
    # skewed: experts 0 and 1 draw half of the choices
    p = np.full(e, 0.5 / (e - 2))
    p[:2] = 0.25
    assign = rng.choice(e, size=(b, k), p=p).astype(np.int32)
    jl, pl = _group_by_pair(b, k, e, d, alpha)
    assert pl.params["capacity"] == jl.params["capacity"]
    assert [o.spec.shape for o in pl.outputs] == \
        [o.spec.shape for o in jl.outputs]
    jbuf, jpos = jget_op_def(jl.op_type).lower(
        jl, [jnp.asarray(x), jnp.asarray(assign)], {}, None)
    pbuf, ppos = get_op_def(pl.op_type).lower(
        pl, [torch.from_numpy(x), torch.from_numpy(assign)], {}, LoweringCtx())
    assert ppos.dtype == torch.int32
    np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(pbuf.numpy(), np.asarray(jbuf))
    if alpha < 2.0:
        assert (ppos.numpy() == -1).any()  # the case overflows


def _experts_pair(e, cap, d, out, activation, use_bias):
    layers = []
    for ffm, ffc in ((JFFModel, JFFConfig), (FFModel, FFConfig)):
        m = ffm(ffc())
        x = m.create_tensor([e, cap, d], name="disp")
        m.experts(x, out, activation=activation, use_bias=use_bias,
                  name="ex")
        layers.append(m.layers[-1])
    return layers


@pytest.mark.parametrize("activation,use_bias", [("relu", True),
                                                 (None, False)])
def test_experts_output_and_grads_match_jax(activation, use_bias):
    e, cap, d, out = 4, 6, 5, 7
    jl, pl = _experts_pair(e, cap, d, out, activation, use_bias)
    assert {w: s.shape for w, s in pl.weight_specs.items()} == \
        {w: s.shape for w, s in jl.weight_specs.items()}
    assert get_op_def(pl.op_type).flop_count(pl) == \
        jget_op_def(jl.op_type).flop_count(jl)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(e, cap, d)).astype(np.float32)
    ws = {w: rng.normal(size=s.shape).astype(np.float32)
          for w, s in sorted(pl.weight_specs.items())}
    g = rng.normal(size=(e, cap, out)).astype(np.float32)

    def jf(x_, ws_):
        return jget_op_def(jl.op_type).lower(jl, [x_], ws_, None)[0]

    jy, vjp = jax.vjp(jf, jnp.asarray(x), {k: jnp.asarray(v)
                                          for k, v in ws.items()})
    jgx, jgw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = {k: torch.from_numpy(v).requires_grad_() for k, v in ws.items()}
    py = get_op_def(pl.op_type).lower(pl, [tx], tw, LoweringCtx())[0]
    py.backward(torch.from_numpy(g))
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy),
                               atol=OP_TOL, rtol=OP_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=OP_TOL,
                               rtol=OP_TOL)
    for k in ws:
        np.testing.assert_allclose(tw[k].grad.numpy(), np.asarray(jgw[k]),
                                   atol=OP_TOL, rtol=OP_TOL, err_msg=k)


@pytest.mark.parametrize("spec", [False, True])
def test_aggregate_output_and_grads_match_jax(spec):
    """aggregate and aggregate_spec over group_by's positions with
    overflowed choices: the output, and the gradients to the gates and to
    the expert outputs (dropped pairs get exactly 0)."""
    b, k, e, d, dout = 16, 2, 4, 3, 5
    rng = np.random.default_rng(2)
    assign = rng.choice(e, size=(b, k), p=[0.55, 0.15, 0.15, 0.15]).astype(
        np.int32)
    jg, pg = _group_by_pair(b, k, e, d, 0.75)
    cap = pg.params["capacity"]
    _, jpos = jget_op_def(jg.op_type).lower(
        jg, [jnp.zeros((b, d)), jnp.asarray(assign)], {}, None)
    positions = np.asarray(jpos)
    assert (positions == -1).any()
    gates = rng.uniform(size=(b, k)).astype(np.float32)
    exp = rng.normal(size=(e, cap, dout)).astype(np.float32)
    g = rng.normal(size=(b, dout)).astype(np.float32)
    layers = []
    for ffm, ffc, it in ((JFFModel, JFFConfig, "int32"),
                         (FFModel, FFConfig, DataType.INT32)):
        m = ffm(ffc())
        ts = [m.create_tensor([b, k], name="gates"),
              m.create_tensor([b, k], it, name="assign"),
              m.create_tensor([b, k], it, name="pos"),
              m.create_tensor([e, cap, dout], name="exp")]
        (m.aggregate_spec if spec else m.aggregate)(*ts, name="agg")
        layers.append(m.layers[-1])
    jl, pl = layers

    def jf(gates_, exp_):
        return jget_op_def(jl.op_type).lower(
            jl, [gates_, jnp.asarray(assign), jnp.asarray(positions), exp_],
            {}, None)[0]

    jy, vjp = jax.vjp(jf, jnp.asarray(gates), jnp.asarray(exp))
    jgg, jge = vjp(jnp.asarray(g))
    tg = torch.from_numpy(gates).requires_grad_()
    te = torch.from_numpy(exp).requires_grad_()
    py = get_op_def(pl.op_type).lower(
        pl, [tg, torch.from_numpy(assign), torch.from_numpy(positions.copy()),
             te],
        {}, LoweringCtx())[0]
    py.backward(torch.from_numpy(g))
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy),
                               atol=OP_TOL, rtol=OP_TOL)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jgg), atol=OP_TOL,
                               rtol=OP_TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jge), atol=OP_TOL,
                               rtol=OP_TOL)
    dropped = positions == -1
    assert (tg.grad.numpy()[dropped] == 0).all()


def test_group_by_overflow_gradient_is_exactly_zero():
    """A choice past its expert's capacity reads no gradient: the buffer's
    overflow slot is sliced off."""
    jl, pl = _group_by_pair(8, 2, 2, 3, 0.5)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    x.requires_grad_()
    assign = torch.from_numpy(rng.integers(0, 2, size=(8, 2)).astype(np.int32))
    buf, pos = get_op_def(pl.op_type).lower(pl, [x, assign], {}, LoweringCtx())
    buf.sum().backward()
    per_choice = pos.numpy() >= 0
    want = per_choice.sum(axis=1).astype(np.float32)[:, None] * np.ones(3)
    np.testing.assert_array_equal(x.grad.numpy(), want)


# ------------------------------------------------------------ training
MOE_KW = dict(batch=16, in_dim=12, num_exp=8, num_select=2, hidden=8,
              classes=4, alpha=1.0)


def _moe_data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(16, 12)).astype(np.float32),
            rng.integers(0, 4, size=(16,)).astype(np.int32))


def test_moe_mlp_trains_two_steps_like_jax():
    start = sync_guids()
    jm = JFFModel(JFFConfig(compute_dtype="float32", mesh_shape={"data": 1},
                            only_data_parallel=True, log_level="warning"))
    jmodels.build_moe_mlp(jm, **MOE_KW)
    sync_guids(start)
    pm = FFModel(FFConfig(compute_dtype="float32"))
    pmodels.build_moe_mlp(pm, **MOE_KW)
    assert [l.name for l in pm.layers] == [l.name for l in jm.layers]
    jcm = jm.compile(JSGDOptimizer(lr=0.01), "sparse_categorical_crossentropy",
                     [])
    jcm.init(seed=0)
    pcm = pm.compile(SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy",
                     [], device="cpu")
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))
    x, y = _moe_data()
    key = jax.random.PRNGKey(0)
    jl, pl = [], []
    for _ in range(2):
        jcm.params, jcm.opt_state, jcm.state, loss, _ = jcm.train_step(
            jcm.params, jcm.opt_state, jcm.state, [x], y, key)
        jl.append(float(loss))
        pcm.params, pcm.opt_state, pcm.state, loss, _ = pcm.train_step(
            pcm.params, pcm.opt_state, pcm.state, [x], y)
        pl.append(float(loss))
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    jp, pp = jax.device_get(jcm.params), params_to_numpy(pcm.params)
    assert sorted(pp) == sorted(jp)
    for layer, ws in pp.items():
        for w, a in ws.items():
            np.testing.assert_allclose(a, np.asarray(jp[layer][w]),
                                       atol=PARAM_ATOL, err_msg=f"{layer}.{w}")


def test_cache_state_matches_jax():
    """A cache layer writes its training input into the state under
    "{name}/cached"; in inference it writes nothing."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    y = rng.normal(size=(4, 3)).astype(np.float32)
    cms = []
    for ffm, ffc, kw in ((JFFModel, JFFConfig,
                          dict(mesh_shape={"data": 1}, log_level="warning",
                               only_data_parallel=True)),
                         (FFModel, FFConfig, {})):
        m = ffm(ffc(compute_dtype="float32", **kw))
        t = m.dense(m.create_tensor([4, 6], name="x"), 5, name="d0")
        t = m.cache(t, name="c")
        m.dense(t, 3, name="d1")
        cms.append(m)
    jcm = cms[0].compile(JSGDOptimizer(lr=0.1), "mean_squared_error", [])
    jcm.init(seed=0)
    pcm = cms[1].compile(SGDOptimizer(lr=0.1), "mean_squared_error", [],
                         device="cpu")
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))
    _, _, jstate, _, _ = jcm.train_step(jcm.params, jcm.opt_state, jcm.state,
                                        [x], y, jax.random.PRNGKey(0))
    _, _, pstate, _, _ = pcm.train_step(pcm.params, pcm.opt_state, pcm.state,
                                        [x], y)
    assert sorted(pstate) == sorted(jstate) == ["c/cached"]
    np.testing.assert_array_equal(pstate["c/cached"].numpy(),
                                  np.asarray(jstate["c/cached"]))
    _, new_state = pcm.forward_fn(pcm.params, {}, [torch.from_numpy(x)])
    assert new_state == {}
    init = get_op_def(cms[1].layers[1].op_type).init_state(cms[1].layers[1],
                                                           "cpu")
    assert list(init) == ["c/cached"] and init["c/cached"].shape == (4, 5)


# -------------------------------------------------------------- search
def _moe_search_pair(batch=32):
    out = []
    start = sync_guids()
    for ffm, ffc, zoo in ((JFFModel, JFFConfig, jmodels),
                          (FFModel, FFConfig, pmodels)):
        sync_guids(start)
        m = ffm(ffc(batch_size=batch, strategy_cache=False))
        zoo.build_moe_mlp(m, batch=batch, in_dim=256, num_exp=8,
                          num_select=2, hidden=512, classes=10, alpha=2.0)
        out.append(m)
    return out


@pytest.mark.parametrize("d", SEARCH_MACHINES)
def test_expert_candidates_and_search_equal_jax(d):
    jm, pm = _moe_search_pair()
    p, j = _machines(d)
    bs = {32}
    kinds = set()
    for jl, pl in zip(jm.layers, pm.layers):
        assert pl.name == jl.name
        jc, pc = jlayer_candidates(jl, j, bs), layer_candidates(pl, p, bs)
        assert [c.name for c in pc] == [c.name for c in jc], pl.name
        for a, b in zip(pc, jc):
            assert (a.in_dims, a.out_dims, a.weight_dims) == \
                (b.in_dims, b.out_dims, b.weight_dims)
            _close(a.op_time(pl, p), b.op_time(jl, j))
            _close(a.extra_comm, b.extra_comm)
            kinds.add((pl.op_type.value, a.name))
    assert ("experts", "ep:model") in kinds and ("group_by", "ep:model") in kinds
    for beam in (16, 64):
        jr = jsearch_graph(jm, j, beam_width=beam)
        pr = search_graph(pm, p, beam_width=beam)
        assert {k: c.name for k, c in pr.choices.items()} == \
            {k: c.name for k, c in jr.choices.items()}
        _close(pr.cost, jr.cost)
        assert pr.mem_bytes == jr.mem_bytes


def test_expert_and_embedding_templates_equal_jax():
    """apply_expert_parallel and apply_sharded_embedding lay a strategy
    out as JAX's do (compared through the strategy JSON)."""
    jm, pm = _moe_search_pair()
    mach = MachineSpec(mesh_axes={"data": 2, "expert": 4}, chip="cpu-sim")
    pst = data_parallel_strategy(pm, mach)
    jst = JStrategy.from_json(pst.to_json())
    apply_expert_parallel(pst, pm.layers)
    japply_expert_parallel(jst, jm.layers)
    assert pst.to_json() == jst.to_json()
    out = []
    for ffm, ffc in ((JFFModel, JFFConfig), (FFModel, FFConfig)):
        m = ffm(ffc())
        ids = m.create_tensor([4, 1], "int32" if ffm is JFFModel
                              else DataType.INT32, name="ids")
        m.embedding(ids, 100, 8, aggr="sum", name="emb")
        out.append(m)
    pst = data_parallel_strategy(out[1], mach)
    jst = JStrategy.from_json(pst.to_json())
    apply_sharded_embedding(pst, out[1].layers[0], axis="expert", dim=1)
    japply_sharded_embedding(jst, out[0].layers[0], axis="expert", dim=1)
    assert pst.to_json() == jst.to_json()
    assert pst.op_shardings["emb"].weights["kernel"] == [None, "expert"]
