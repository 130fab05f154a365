"""The port's fork-join composite, its graph pass and its search
candidates against the JAX package's, on the CPU.

- weight names and shapes, stacked (`stk.{sub}.{w}`, congruent branches)
  and per branch (`b{i}.{sub}.{w}`), equal JAX's;
- a fork-join's forward and one SGD step (lr 1: the params move by the
  gradient) from JAX's params agree in f32 (forward and params within
  1e-5), for add and concat joins, stacked and per-branch;
- `set_weight`/`get_weight`'s per-branch alias writes and reads slice i of
  a stacked weight; a stacked weight is initialized slice by slice, each
  by its branch's override when it has one;
- a batch norm in every branch keys its running stats by the sub-layer's
  name, as JAX does (congruent branches share one key, the last branch's
  stats win: the keys and values equal JAX's exactly after a step); in
  bf16 its gamma and beta stay f32 (the cast exemption) and the forward
  agrees with JAX's within 2e-2;
- `find_fork_join_regions` and `fuse_fork_joins` give JAX's counts on JAX's
  own cases (tests/test_fork_join_pass.py), and a fused region computes
  the unfused graph's output (1e-5);
- the fork-join candidates (`inter:{axis}`, grouped `inter:{axis}:{g0}-...`)
  and `search_graph`'s choices and cost on the branch ensemble and on a
  heterogeneous fork-join equal JAX's on two "cpu-sim" machines (relative
  1e-12).
"""

import jax
import numpy as np
import pytest

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.compiler.passes import \
    find_fork_join_regions as jfind_fork_join_regions
from flexflow_tpu.compiler.passes import fuse_fork_joins as jfuse_fork_joins
from flexflow_tpu.initializers import ConstantInitializer as JConstant
from flexflow_tpu.models.branchy import build_branchy as jbuild_branchy
from flexflow_tpu.search.candidates import layer_candidates as jlayer_candidates
from flexflow_tpu.search.dp import search_graph as jsearch_graph
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.compiler.lowering import cast_exempt
from flexflow_tpu_torch.compiler.passes import (find_fork_join_regions,
                                                fuse_fork_joins)
from flexflow_tpu_torch.convert import (params_from_jax, params_to_numpy,
                                        state_from_jax)
from flexflow_tpu_torch.initializers import ConstantInitializer
from flexflow_tpu_torch.models.branchy import (build_branchy,
                                               expert_template_pins)
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.search import memo
from flexflow_tpu_torch.search.candidates import _best_groups, layer_candidates
from flexflow_tpu_torch.search.dp import search_graph
from flexflow_tpu_torch.search.strategy_cache import graph_fingerprint

from test_torch_port_moe import sync_guids
from test_torch_port_search import _close, _machines

TOL = 1e-5        # f32 forward and params after one step
BF16_TOL = 2e-2   # bf16 forward against JAX's bf16 forward
JKW = dict(mesh_shape={"data": 1}, only_data_parallel=True,
           log_level="warning")
SEARCH_MACHINES = [{"mesh_axes": {"data": 4, "model": 2}, "chip": "cpu-sim"},
                   {"mesh_axes": {"data": 2, "model": 4}, "chip": "cpu-sim"}]


@pytest.fixture(autouse=True)
def _guids_in_step():
    sync_guids()
    yield
    sync_guids()


def _pair(build, batch=8, jkw=JKW, **cfg):
    """`build(m)` in both packages from the same guids: (jax, port)."""
    start = sync_guids()
    out = []
    for ffm, ffc, kw in ((JFFModel, JFFConfig, jkw), (FFModel, FFConfig, {})):
        sync_guids(start)
        m = ffm(ffc(batch_size=batch, **kw, **cfg))
        build(m)
        out.append(m)
    sync_guids()
    return out


def _branch(hidden, act, out=16, bn=False):
    def b(bm, x):
        h = bm.dense(x, hidden, activation=act, name="mid")
        if bn:
            h = bm.batch_norm(h, relu=False, name="bn")
        return bm.dense(h, out, name="out")
    return b


def _fj_model(kind, join="add", bn=False):
    """x (8, 12) -> fork_join -> head: "stacked" = three congruent
    branches, "hetero" = two branches of other widths and structure."""
    def build(m):
        x = m.create_tensor([8, 12], name="x")
        if kind == "stacked":
            brs = [_branch(20, a, bn=bn) for a in ("relu", "tanh", "sigmoid")]
        else:
            brs = [_branch(20, "relu", bn=bn),
                   lambda bm, t: bm.dense(bm.dense(t, 7), 16, name="proj")]
        t = m.fork_join(x, brs, join=join, name="fj")
        m.dense(t, 3, name="head")
    return build


CASES = [("stacked", "add"), ("stacked", "concat"), ("hetero", "add"),
         ("hetero", "concat")]


@pytest.mark.parametrize("kind,join", CASES)
def test_weight_names_and_shapes_equal_jax(kind, join):
    jm, pm = _pair(_fj_model(kind, join))
    jl, pl = jm.get_layer_by_name("fj"), pm.get_layer_by_name("fj")
    assert {w: s.shape for w, s in pl.weight_specs.items()} == \
        {w: s.shape for w, s in jl.weight_specs.items()}
    assert pl.outputs[0].spec.shape == jl.outputs[0].spec.shape
    assert all(w.startswith("stk.") == (kind == "stacked")
               for w in pl.weight_specs)
    if kind == "hetero":  # the auto-named sub-layers renamed by position
        assert "b1.linear0.kernel" in pl.weight_specs


def _compiled_pair(build, cdt="float32", lr=1.0):
    jm, pm = _pair(build, compute_dtype=cdt)
    jcm = jm.compile(JSGDOptimizer(lr=lr), "mean_squared_error", [])
    jcm.init(seed=0)
    pcm = pm.compile(SGDOptimizer(lr=lr), "mean_squared_error", [],
                     device="cpu")
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))
    return jcm, pcm


def _xy(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(8, 12)).astype(np.float32),
            rng.normal(size=(8, 3)).astype(np.float32))


def _params_close(jcm, pcm, atol=TOL):
    jp, pp = jax.device_get(jcm.params), params_to_numpy(pcm.params)
    assert sorted(pp) == sorted(jp)
    for layer, ws in pp.items():
        assert sorted(ws) == sorted(jp[layer])
        for w, a in ws.items():
            np.testing.assert_allclose(a, np.asarray(jp[layer][w]), atol=atol,
                                       err_msg=f"{layer}.{w}")


@pytest.mark.parametrize("kind,join", CASES)
def test_forward_and_grads_match_jax(kind, join):
    jcm, pcm = _compiled_pair(_fj_model(kind, join))
    x, y = _xy()
    np.testing.assert_allclose(pcm.forward(x).numpy(),
                               np.asarray(jcm.forward(x)), atol=TOL)
    jcm.params, jcm.opt_state, jcm.state, jl, _ = jcm.train_step(
        jcm.params, jcm.opt_state, jcm.state, [x], y, jax.random.PRNGKey(0))
    pcm.params, pcm.opt_state, pcm.state, pl, _ = pcm.train_step(
        pcm.params, pcm.opt_state, pcm.state, [x], y)
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL)
    _params_close(jcm, pcm)  # lr 1: each param moved by its gradient


def test_set_weight_branch_alias_and_stacked_init():
    jcm, pcm = _compiled_pair(_fj_model("stacked"))
    v = np.arange(12 * 20, dtype=np.float32).reshape(12, 20) / 100
    stk = pcm.params["fj"]["stk.mid.kernel"]
    ptr = stk.data_ptr()
    pcm.set_weight("fj", "b1.mid.kernel", v)
    jcm.set_weight("fj", "b1.mid.kernel", v)
    assert stk.data_ptr() == ptr and pcm.params["fj"]["stk.mid.kernel"] is stk
    np.testing.assert_array_equal(pcm.get_weight("fj", "b1.mid.kernel"), v)
    np.testing.assert_array_equal(pcm.get_weight("fj", "stk.mid.kernel"),
                                  np.asarray(jcm.get_weight("fj",
                                                            "stk.mid.kernel")))
    with pytest.raises(ValueError, match="shape"):
        pcm.set_weight("fj", "b0.mid.kernel", v[:3])
    # init: slice by slice, branch 2's override on its slice only
    def build(m):
        x = m.create_tensor([8, 12], name="x")
        const = (JConstant if isinstance(m, JFFModel) else ConstantInitializer)
        brs = [_branch(20, "relu") for _ in range(2)]
        brs.append(lambda bm, t: bm.dense(
            bm.dense(t, 20, activation="relu", name="mid",
                     kernel_initializer=const(0.25)), 16, name="out"))
        m.dense(m.fork_join(x, brs, name="fj"), 3, name="head")
    jm, pm = _pair(build)
    assert pm._initializer_overrides.keys() == jm._initializer_overrides.keys()
    pcm = pm.compile(SGDOptimizer(lr=0.1), "mean_squared_error", [],
                     device="cpu")
    pcm.init(seed=3)
    k = pcm.params["fj"]["stk.mid.kernel"].detach()
    assert k.shape == (3, 12, 20)
    assert (k[2] == 0.25).all() and not (k[0] == 0.25).any()
    limit = (6.0 / (12 + 20)) ** 0.5  # Glorot of the slice, not the stack
    assert k[:2].abs().max() <= limit and k[:2].abs().max() > 0.8 * limit


def test_batch_norm_in_branches_keys_state_as_jax():
    """Congruent branches each hold a batch norm named "bn": both packages
    key its running stats "bn/mean" and "bn/var" (one key for all three
    branches; the last branch's stats are kept)."""
    jcm, pcm = _compiled_pair(_fj_model("stacked", bn=True), lr=0.1)
    x, y = _xy(1)
    _, _, jstate, jl, _ = jcm.train_step(jcm.params, jcm.opt_state, jcm.state,
                                         [x], y, jax.random.PRNGKey(0))
    _, _, pstate, pl, _ = pcm.train_step(pcm.params, pcm.opt_state, pcm.state,
                                         [x], y)
    assert sorted(pstate) == sorted(jstate) == ["bn/mean", "bn/var"]
    for k in pstate:
        np.testing.assert_allclose(pstate[k].numpy(), np.asarray(jstate[k]),
                                   atol=TOL, err_msg=k)
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL)


def test_bf16_keeps_branch_norm_params_f32():
    jcm, pcm = _compiled_pair(_fj_model("hetero", bn=True), cdt="bfloat16",
                              lr=0.1)
    fj = pcm.model.get_layer_by_name("fj")
    assert cast_exempt(pcm.model.layers)["fj"] == {
        "b0.bn.gamma", "b0.bn.beta", "stk.bn.gamma", "stk.bn.beta"}
    x, _ = _xy(2)
    pcm.state = state_from_jax(jax.device_get(jcm.state))
    got = pcm.forward(x).float().numpy()
    want = np.asarray(jcm.forward(x), np.float32)
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)
    assert fj.weight_specs["b0.bn.gamma"].dtype.value == "float32"


# ------------------------------------------------------------- the pass
def _pass_branchy(m, hidden=64, join="add"):
    x = m.create_tensor([16, 32], name="x")
    a = m.dense(x, hidden, activation="relu", name="a1")
    a = m.dense(a, 48, name="a2")
    b = m.dense(x, hidden, activation="gelu", name="b1")
    b = m.dense(b, 48, name="b2")
    j = m.add(a, b, name="j") if join == "add" else \
        m.concat([a, b], axis=-1, name="j")
    m.dense(j, 4, name="head")


def _pass_residual(m):
    x = m.create_tensor([8, 32], name="x")
    m.add(m.dense(x, 32, name="d"), x, name="res")


def _pass_diverging(m):
    x = m.create_tensor([8, 32], name="x")
    m.dense(x, 16, name="p")
    m.dense(x, 8, name="q")


def _pass_cascaded(m):
    x = m.create_tensor([8, 16], name="x")
    j1 = m.add(m.dense(x, 32, name="r1a"), m.dense(x, 32, name="r1b"),
               name="j1")
    j2 = m.add(m.dense(j1, 32, name="r2a"), m.dense(j1, 32, name="r2b"),
               name="j2")
    m.dense(j2, 4, name="head")


def _pass_nested(m):
    x = m.create_tensor([8, 16], name="x")
    a = m.fork_join(x, [lambda mm, t: mm.dense(t, 16, name="i1"),
                        lambda mm, t: mm.dense(t, 16, name="i2")],
                    join="add", name="inner")
    a = m.dense(a, 32, name="a2")
    m.add(a, m.dense(x, 32, name="b1"), name="j")


def _pass_contract(m):
    x = m.create_tensor([16, 4, 8], name="x")
    a = m.dense(m.reshape(x, [8, 64], name="ra"), 32, name="da")
    b = m.dense(m.reshape(x, [8, 64], name="rb"), 32, name="db")
    m.add(a, b, name="j")


def _pass_auto_named(m):
    x = m.create_tensor([8, 16], name="x")
    a = m.dense(m.dense(x, 32), 16)
    m.add(a, m.dense(x, 16), name="j")


def _pass_inception_a(m):
    from flexflow_tpu.models.inception import inception_a as jinc
    from flexflow_tpu_torch.models.inception import inception_a
    x = m.create_tensor([2, 8, 9, 9], name="x")
    (jinc if isinstance(m, JFFModel) else inception_a)(m, x, 4, "mixed0")


PASS_CASES = {"add": _pass_branchy,
              "concat": lambda m: _pass_branchy(m, join="concat"),
              "residual": _pass_residual, "diverging": _pass_diverging,
              "cascaded": _pass_cascaded, "nested": _pass_nested,
              "contract": _pass_contract, "auto_named": _pass_auto_named,
              "inception_a": _pass_inception_a}
# fused regions in JAX's cases (tests/test_fork_join_pass.py); Inception's
# concat joins ride the channel axis 1, not the last: none fuses
PASS_COUNTS = {"add": 1, "concat": 1, "residual": 0, "diverging": 0,
               "cascaded": 2, "nested": 1, "contract": 0, "auto_named": 1,
               "inception_a": 0}


@pytest.mark.parametrize("case", sorted(PASS_CASES))
def test_fuse_fork_joins_counts_equal_jax(case):
    jm, pm = _pair(PASS_CASES[case])
    jreg, preg = jfind_fork_join_regions(jm), find_fork_join_regions(pm)
    assert [(r["jkind"], [[l.name for l in c] for c in r["chains"]])
            for r in preg] == \
        [(r["jkind"], [[l.name for l in c] for c in r["chains"]])
         for r in jreg]
    n = fuse_fork_joins(pm)
    assert n == jfuse_fork_joins(jm) == PASS_COUNTS[case]
    assert [l.name for l in pm.layers] == [l.name for l in jm.layers]
    for jl, pl in zip(jm.layers, pm.layers):
        assert {w: s.shape for w, s in pl.weight_specs.items()} == \
            {w: s.shape for w, s in jl.weight_specs.items()}, pl.name
    if case in ("cascaded", "nested"):  # compiles and runs
        cm = pm.compile(SGDOptimizer(lr=0.01), "mean_squared_error", [],
                        device="cpu")
        cm.init(seed=0)
        out = cm.forward(np.zeros((8, 16), np.float32))
        assert tuple(out.shape) == (8, 4 if case == "cascaded" else 32)


def test_fused_region_computes_the_unfused_output():
    x = np.random.default_rng(0).normal(size=(16, 32)).astype(np.float32)
    m1 = FFModel(FFConfig(batch_size=16))
    _pass_branchy(m1, join="concat")
    cm1 = m1.compile(SGDOptimizer(lr=0.01), "mean_squared_error", [],
                     device="cpu")
    cm1.init(seed=0)
    ref = cm1.forward(x).numpy()
    m2 = FFModel(FFConfig(batch_size=16))
    _pass_branchy(m2, join="concat")
    assert fuse_fork_joins(m2) == 1
    cm2 = m2.compile(SGDOptimizer(lr=0.01), "mean_squared_error", [],
                     device="cpu")
    cm2.init(seed=1)
    fj = next(l for l in m2.layers if l.op_type is OperatorType.FORK_JOIN)
    for bi, br in enumerate(("a", "b")):
        for li in (1, 2):
            for w in ("kernel", "bias"):
                cm2.set_weight(fj.name, f"b{bi}.{br}{li}.{w}",
                               cm1.get_weight(f"{br}{li}", w))
    for w in ("kernel", "bias"):
        cm2.set_weight("head", w, cm1.get_weight("head", w))
    np.testing.assert_allclose(cm2.forward(x).numpy(), ref, rtol=TOL,
                               atol=TOL)


# ------------------------------------------------------------- the search
def _ensemble(m):
    jm_side = isinstance(m, JFFModel)
    (jbuild_branchy if jm_side else build_branchy)(
        m, batch=64, width=64, hidden=1024, modules=2, k=4)


def _hetero(m):
    x = m.create_tensor([64, 64], name="x")
    t = m.dense(x, 64, activation="relu", name="trunk")
    brs = [lambda bm, t: bm.dense(bm.dense(t, 4096, activation="relu",
                                           name="big"), 64, name="o"),
           lambda bm, t: bm.dense(t, 64, activation="tanh", name="small")]
    t = m.fork_join(t, brs, join="add", name="fjh")
    m.dense(t, 10, name="head")


@pytest.mark.parametrize("which", ["ensemble", "hetero"])
@pytest.mark.parametrize("d", SEARCH_MACHINES)
def test_fork_join_candidates_and_search_equal_jax(which, d):
    jm, pm = _pair(_ensemble if which == "ensemble" else _hetero, batch=64)
    p, j = _machines(d)
    bs = {64}
    names = set()
    for jl, pl in zip(jm.layers, pm.layers):
        jc, pc = jlayer_candidates(jl, j, bs), layer_candidates(pl, p, bs)
        assert [c.name for c in pc] == [c.name for c in jc], pl.name
        for a, b in zip(pc, jc):
            assert (a.in_dims, a.out_dims, a.weight_dims) == \
                (b.in_dims, b.out_dims, b.weight_dims)
            _close(a.op_time(pl, p), b.op_time(jl, j))
            _close(a.extra_comm, b.extra_comm)
            assert a.weight_stream_frac == b.weight_stream_frac
            names.add(a.name)
    n_model = p.mesh_axes["model"]
    k = 4 if which == "ensemble" else 2
    if n_model == k:
        assert "inter:model" in names
    elif n_model > k:
        assert any(n.startswith("inter:model:") for n in names), names
    for beam in (16, 64):
        jr = jsearch_graph(jm, j, beam_width=beam)
        pr = search_graph(pm, p, beam_width=beam)
        assert {kk: c.name for kk, c in pr.choices.items()} == \
            {kk: c.name for kk, c in jr.choices.items()}
        _close(pr.cost, jr.cost)
        assert pr.mem_bytes == jr.mem_bytes
    if which == "ensemble":
        pins = expert_template_pins(pm, "intra_op")
        assert set(pins) == {"fj0", "fj1"}
        jr = jsearch_graph(jm, j, pins=pins)
        pr = search_graph(pm, p, pins=pins)
        _close(pr.cost, jr.cost)


def test_best_groups_and_branch_fingerprints():
    from flexflow_tpu.search.candidates import _best_groups as jbest
    assert _best_groups([3.0, 1.0], 4, 12) == jbest([3.0, 1.0], 4, 12) \
        == (1.0, [3, 1])
    assert _best_groups([3.0, 1.0], 4, 16) == jbest([3.0, 1.0], 4, 16) \
        == (1.5, [2, 2])   # 3 does not divide the per-device batch
    assert _best_groups([1.0, 1.0, 1.0], 2, 8) is None
    # an edited branch body changes the graph's fingerprint and signature
    a = FFModel(FFConfig(batch_size=8))
    _fj_model("stacked")(a)
    b = FFModel(FFConfig(batch_size=8))
    x = b.create_tensor([8, 12], name="x")
    brs = [_branch(20, act) for act in ("relu", "tanh", "gelu")]
    b.dense(b.fork_join(x, brs, name="fj"), 3, name="head")
    fa, fb = a.get_layer_by_name("fj"), b.get_layer_by_name("fj")
    assert fa.params_key() == fb.params_key()
    assert memo.branches_signature(fa) != memo.branches_signature(fb)
    assert graph_fingerprint(a) != graph_fingerprint(b)
    assert memo.branches_signature(a.get_layer_by_name("head")) is None


@pytest.mark.parametrize("mesh", [{"data": 8, "model": 4},
                                  {"data": 4, "model": 2}])
def test_unity_search_on_the_ensemble_equals_jax(mesh):
    """graph_optimize over the branch ensemble at bench.py's size on an
    H100 machine of `mesh`: the same strategy as JAX's (on data 8 x model
    4, every fork-join placed inter:model), the same predicted cost."""
    from flexflow_tpu import AdamOptimizer as JAdamOptimizer
    from flexflow_tpu.search.optimize import graph_optimize as jgraph_optimize
    from flexflow_tpu_torch import AdamOptimizer
    from flexflow_tpu_torch.search.optimize import graph_optimize

    def build(m):
        (jbuild_branchy if isinstance(m, JFFModel) else build_branchy)(m)
    jm, pm = _pair(build, batch=1024, jkw={}, search_budget=16,
                   strategy_cache=False)
    p, j = _machines({"mesh_axes": mesh, "chip": "h100"})
    js = jgraph_optimize(jm, j, optimizer=JAdamOptimizer(alpha=1e-4))
    ps = graph_optimize(pm, p, optimizer=AdamOptimizer(alpha=1e-4))
    assert ps.to_json() == js.to_json()
    _close(ps._predicted_cost, js._predicted_cost)
    placed = {k: v.attrs for k, v in ps.op_shardings.items() if v.attrs}
    if mesh["model"] == 4:
        assert placed == {f"fj{i}": {"placement": "model"} for i in range(4)}
