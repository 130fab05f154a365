"""Inter-op (branch) placement on the port (parallel/interop.py and the
placed fork-join of ops/fork_join.py), against the JAX package on the
CPU mesh of the same shape.

Mirrors tests/test_interop.py: `place_branches` (:35, :47) with both
joins, `place_branches_stacked` (:253, each rank holding its branch's
slice), `place_branches_grouped` (:356, fat and thin on (3, 1); :486 the
three-branch case, here at world 4 with a (2, 1, 1) division), forward
and gradients; `divide_workers` (:343); the errors; and the search's
`inter:` picks on the "cpu-sim" machine (:113 fat congruent branches,
:416 the unequal division), whose exported strategy file trains over
gloo ranks as JAX trains it. Ranks spawned on gloo at world 2
({"model": 2}) and 4 ({"data": 2, "model": 2} or {"model": 4}).
f32; tolerances: 1e-5 on outputs, 1e-4 on gradients (JAX's own are
2e-6 and 1e-4 against sequential execution), 1e-5 relative on losses.
"""

import numpy as np
import pytest
import torch

import _torch_port_ranks as ranks
import flexflow_tpu_torch as F
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.parallel import interop as I

MOD = __name__
OUT_TOL, GRAD_TOL, LOSS_RTOL = 1e-5, 1e-4, 1e-5
MESHES = {2: {"model": 2}, 4: {"data": 2, "model": 2}}


@pytest.fixture(scope="module", autouse=True)
def _close_groups():
    yield
    ranks.close_all()


def _arrays(kind):
    rng = np.random.default_rng(0)
    if kind == "two":
        return {"x": rng.normal(size=(8, 16)),
                "w0": rng.normal(size=(16, 8)), "w1": rng.normal(size=(16, 8)),
                "stk": rng.normal(size=(2, 16, 8))}
    if kind == "grouped":
        return {"x": rng.normal(size=(24, 16)),
                "fa": rng.normal(size=(16, 64)) * 0.1,
                "fb": rng.normal(size=(64, 32)) * 0.1,
                "ta": rng.normal(size=(16, 32)) * 0.1}
    return {"x": rng.normal(size=(16, 16)),
            "ba": rng.normal(size=(16, 128)) * 0.1,
            "bb": rng.normal(size=(128, 24)) * 0.1,
            "ma": rng.normal(size=(16, 48)) * 0.1,
            "mb": rng.normal(size=(48, 24)) * 0.1,
            "sa": rng.normal(size=(16, 24)) * 0.1}


def _branches(kind, pkg):
    """The branch functions of JAX's tests, in jax.numpy or torch."""
    if pkg == "jax":
        import jax
        import jax.numpy as jnp
        tanh, relu = jnp.tanh, jax.nn.relu
    else:
        tanh, relu = torch.tanh, torch.relu
    if kind == "two":
        return [lambda x, w: tanh(x @ w["w"]),
                lambda x, w: relu(x @ w["w"]) * 2.0]
    if kind == "grouped":
        return [lambda x, w: tanh(x @ w["a"]) @ w["b"],
                lambda x, w: x @ w["a"]]
    return [lambda x, w: tanh(x @ w["a"]) @ w["b"],
            lambda x, w: relu(x @ w["a"]) @ w["b"],
            lambda x, w: x @ w["a"]]


def _weights(kind, a, cast):
    if kind == "two":
        return [{"w": cast(a["w0"])}, {"w": cast(a["w1"])}]
    if kind == "stacked":
        return {"w": cast(a["stk"])}
    if kind == "grouped":
        return [{"a": cast(a["fa"]), "b": cast(a["fb"])}, {"a": cast(a["ta"])}]
    return [{"a": cast(a["ba"]), "b": cast(a["bb"])},
            {"a": cast(a["ma"]), "b": cast(a["mb"])}, {"a": cast(a["sa"])}]


GROUPED = {"grouped": ((3, 1), [32, 32]), "three": ((2, 1, 1), [24] * 3)}


def _call(pkg, mesh, kind, join, x, ws):
    mod = I if pkg == "torch" else __import__(
        "flexflow_tpu.parallel.interop", fromlist=["x"])
    fns = _branches("two" if kind == "stacked" else kind, pkg)
    if kind == "two":
        return mod.place_branches(mesh, "model", fns, x, ws, join)
    if kind == "stacked":
        return mod.place_branches_stacked(mesh, "model", fns, x, ws, join)
    gs, dims = GROUPED[kind]
    return mod.place_branches_grouped(mesh, "model", fns, x, ws, join, gs,
                                      dims, 2)


def _jax_run(shape, kind, join):
    """JAX's placed output and the gradients of sum(out²) for x and every
    weight leaf, on a CPU mesh of `shape`."""
    import jax
    import jax.numpy as jnp

    from flexflow_tpu.parallel.machine import MachineSpec, build_mesh

    mesh = build_mesh(MachineSpec(mesh_axes=dict(shape)))
    a = _arrays("two" if kind == "stacked" else kind)
    cast = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    x, ws = cast(a["x"]), _weights(kind, a, cast)

    def f(x_, ws_):
        return _call("jax", mesh, kind, join, x_, ws_)

    with mesh:
        y = jax.jit(f)(x, ws)
        gx, gw = jax.jit(jax.grad(lambda x_, ws_: (f(x_, ws_) ** 2).sum(),
                                  argnums=(0, 1)))(x, ws)
    return [np.asarray(t) for t in [y, gx] + jax.tree_util.tree_leaves(gw)]


# ------------------------------------------------------------- rank code
def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def rank_place(shape, kind, join):
    from torch.distributed.tensor import DTensor, Replicate

    mesh = _mesh(shape)
    a = _arrays("two" if kind == "stacked" else kind)

    def cast(v):
        return DTensor.from_local(torch.tensor(v, dtype=torch.float32), mesh,
                                  [Replicate()] * mesh.ndim,
                                  run_check=False).requires_grad_()

    x, ws = cast(a["x"]), _weights(kind, a, cast)
    y = _call("torch", mesh, kind, join, x, ws)
    (y * y).sum().backward()
    leaves = torch.utils._pytree.tree_leaves(ws)
    return {"out": [t.full_tensor().detach().numpy()
                    for t in [y, x.grad] + [w.grad for w in leaves]]}


def rank_stacked_local():
    """Under `place_branches_stacked` each rank of the axis reads only its
    branch's slice: the local block of the (k, ...) weight."""
    from torch.distributed.tensor import DTensor, Shard

    mesh = _mesh(MESHES[2])
    stk = torch.tensor(_arrays("two")["stk"], dtype=torch.float32)
    w = DTensor.from_local(stk.chunk(2)[mesh.get_local_rank("model")].clone(),
                           mesh, [Shard(0)], run_check=False)
    seen = []

    def fn(i):
        def run(x, tree):
            seen.append((i, tuple(tree["w"].shape)))
            return x @ tree["w"]
        return run
    I.place_branches_stacked(mesh, "model", [fn(0), fn(1)],
                             torch.ones(4, 16), {"w": w}, "add")
    return seen, tuple(w.to_local().shape)


def rank_errors():
    mesh = _mesh({"model": 4})
    fns = _branches("two", "torch")
    a = _arrays("two")
    x = torch.tensor(a["x"], dtype=torch.float32)
    ws = _weights("two", a, lambda v: torch.tensor(v, dtype=torch.float32))
    out = []
    for call in (lambda: I.place_branches(mesh, "nope", fns, x, ws, "add"),
                 lambda: I.place_branches(mesh, "model", fns + fns[:1], x,
                                          ws + ws[:1], "add"),
                 lambda: I.place_branches(mesh, "model", fns, x, ws, "max"),
                 lambda: I.place_branches_grouped(
                     mesh, "model", fns, x, ws, "add", (3, 1), [8, 8], 2),
                 lambda: I.place_branches_grouped(
                     mesh, "model", fns, x, ws, "add", (2, 1), [8, 8], 2)):
        try:
            call()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def _fat(pkg, cfg, hidden=4096):
    m = pkg.FFModel(cfg)
    x = m.create_tensor([32, 64], name="x")

    def branch(act):
        def build(mm, t):
            h = mm.dense(t, hidden, activation=act, name="mid")
            return mm.dense(h, 64, name="out")
        return build
    t = m.fork_join(x, [branch("relu"), branch("gelu")], join="add",
                    name="fj")
    m.dense(t, 4, name="head")
    return m


def _fat_data():
    rng = np.random.default_rng(1)
    return (rng.normal(size=(64, 64)).astype(np.float32),
            rng.integers(0, 4, size=(64,)).astype(np.int32))


def rank_fit_imported(shape, path, params):
    m = _fat(F, F.FFConfig(batch_size=32, mesh_shape=dict(shape), seed=7,
                           import_strategy_file=path))
    cm = m.compile(F.SGDOptimizer(lr=0.05),
                   "sparse_categorical_crossentropy", [], device="cpu")
    cm.load_params(params_from_jax(params))
    x, y = _fat_data()
    hist = cm.fit(x, y, epochs=1, verbose=False)
    return {"loss": hist[0]["loss"],
            "attrs": cm.strategy.sharding_for("fj").attrs,
            "local": tuple(cm.params["fj"]["stk.mid.kernel"].to_local().shape)}


def _ensemble_fit(mesh, groups, k):
    """The branch ensemble (2 modules of k congruent branches, small
    widths) trained 2 steps, its fork-joins placed over "model" (stacked,
    or on `groups`) when `mesh` names one: the losses and each rank's
    block of fj0's stacked kernel."""
    from flexflow_tpu_torch.models.branchy import build_branchy
    from flexflow_tpu_torch.parallel.templates import apply_branch_placement

    m = F.FFModel(F.FFConfig(batch_size=32, mesh_shape=dict(mesh), seed=7,
                             only_data_parallel=True))
    build_branchy(m, batch=32, width=16, hidden=32, modules=2, k=k)
    cm = m.compile(F.AdamOptimizer(alpha=1e-2),
                   "sparse_categorical_crossentropy", [], device="cpu")
    if mesh:
        for l in m.layers:
            if l.op_type.value == "fork_join":
                apply_branch_placement(cm.strategy, l, "model", groups)
        cm._build_steps()
    cm.init(seed=3)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    y = rng.integers(0, 10, size=(64,)).astype(np.int32)
    hist = cm.fit(x, y, epochs=1, verbose=False)
    k0 = cm.params["fj0"]["stk.mid.kernel"]
    return {"losses": [h["loss"] for h in hist],
            "local": tuple(getattr(k0, "to_local", lambda: k0)().shape)}


def rank_ensemble_fit(mesh, groups, k):
    return _ensemble_fit(mesh, groups, k)


# ------------------------------------------------------------------ tests
def _close(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        tol = OUT_TOL if i == 0 else GRAD_TOL
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=str(i))


@pytest.mark.parametrize("world", [2, 4])
def test_place_branches_matches_jax(world):
    """Branch i on index i of the model axis, add and concat joins: the
    output and the gradients of x and each branch's weight equal JAX's
    on every rank."""
    for join in ("add", "concat"):
        want = _jax_run(MESHES[world], "two", join)
        for o in ranks.shared(world, MOD).run("rank_place", MESHES[world],
                                              "two", join):
            _close(o["out"], want)


@pytest.mark.parametrize("world", [2, 4])
def test_place_branches_stacked_matches_jax(world):
    """Stacked (2, 16, 8) weights sharded over the placement axis: JAX's
    output and gradients; each rank's branch reads its (1, ...) slice."""
    want = _jax_run(MESHES[world], "stacked", "add")
    for o in ranks.shared(world, MOD).run("rank_place", MESHES[world],
                                          "stacked", "add"):
        _close(o["out"], want)
    if world == 2:
        outs = ranks.shared(2, MOD).run("rank_stacked_local")
        for r, (seen, local) in enumerate(outs):
            assert seen == [(r, (16, 8))] and local == (1, 16, 8)


@pytest.mark.parametrize("kind", ["grouped", "three"])
def test_place_branches_grouped_matches_jax(kind):
    """Unequal groups over a 4-way axis at world 4: fat and thin on
    (3, 1) with both joins, and three branches on (2, 1, 1) with add:
    JAX's output and gradients."""
    joins = ("add", "concat") if kind == "grouped" else ("add",)
    for join in joins:
        want = _jax_run({"model": 4}, kind, join)
        for o in ranks.shared(4, MOD).run("rank_place", {"model": 4}, kind,
                                          join):
            _close(o["out"], want)


def test_divide_workers_and_errors():
    """JAX's waterfill, and the errors: an axis the mesh lacks, a branch
    count other than the axis size, an unknown join, a batch a group
    size does not divide, groups that do not sum to the axis."""
    from flexflow_tpu.parallel.interop import divide_workers as jdivide

    for costs, n in (([3.0, 1.0], 4), ([1.0, 1.0, 2.0], 4),
                     ([5.0, 1.0, 1.0], 8)):
        assert I.divide_workers(costs, n) == jdivide(costs, n)
    with pytest.raises(ValueError):
        I.divide_workers([1.0, 1.0], 1)
    errs = ranks.shared(4, MOD).run("rank_errors")[0]
    assert all(errs), errs
    assert "no axis 'nope'" in errs[0]
    assert "axis size == n_branches" in errs[1]
    assert "unsupported join" in errs[2]
    assert "not divisible by group size" in errs[3]
    assert "sum to 3" in errs[4]


def test_search_places_branches_and_the_strategy_trains():
    """The port's search on the "cpu-sim" machine picks JAX's placements:
    inter:model for fat congruent branches on data 4 x model 2, and
    inter:model:3-1 for a fat and a thin branch on data 2 x model 4. The
    strategy it exports for data 2 x model 2 trains over 4 gloo ranks to
    JAX's loss (JAX importing the same file); each rank holds one
    branch's half of the stacked weights."""
    import jax

    import flexflow_tpu as J
    from flexflow_tpu.parallel.machine import MachineSpec as JM
    from flexflow_tpu.search.dp import search_graph as jsearch
    from flexflow_tpu_torch.parallel.machine import MachineSpec
    from flexflow_tpu_torch.search.dp import search_graph
    from flexflow_tpu_torch.search.optimize import graph_optimize

    def thin_fat(pkg):
        m = pkg.FFModel(pkg.FFConfig(batch_size=24))
        x = m.create_tensor([24, 64], name="x")

        def br(h, act):
            def build(mm, t):
                return mm.dense(mm.dense(t, h, activation=act, name="mid"),
                                64, name="out")
            return build
        m.fork_join(x, [br(4096, "relu"), br(256, "gelu")], join="add",
                    name="fj")
        return m

    for shape, build, want in (
            ({"data": 4, "model": 2},
             lambda pkg: _fat(pkg, pkg.FFConfig(batch_size=32)),
             "inter:model"),
            ({"data": 2, "model": 4}, thin_fat, "inter:model:3-1")):
        got = search_graph(build(F), MachineSpec(mesh_axes=shape,
                                                 chip="cpu-sim"))
        jgot = jsearch(build(J), JM(mesh_axes=shape, chip="cpu-sim"))
        assert got.choices["fj"].name == jgot.choices["fj"].name == want

    import tempfile
    shape = MESHES[4]
    st = graph_optimize(_fat(F, F.FFConfig(batch_size=32)),
                        MachineSpec(mesh_axes=shape, chip="cpu-sim"),
                        optimizer=F.SGDOptimizer(lr=0.05))
    assert st.sharding_for("fj").attrs == {"placement": "model"}
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/strategy.json"
        st.save(path)
        jm = _fat(J, J.FFConfig(batch_size=32, mesh_shape=shape, seed=7,
                                import_strategy_file=path))
        jcm = jm.compile(J.SGDOptimizer(lr=0.05),
                         "sparse_categorical_crossentropy", [])
        jcm.init(seed=3)
        params = jax.device_get(jcm.params)
        want = jcm.fit(*_fat_data(), epochs=1, verbose=False)[0]["loss"]
        outs = ranks.shared(4, MOD).run("rank_fit_imported", shape, path,
                                        params)
    for o in outs:
        np.testing.assert_allclose(o["loss"], want, rtol=LOSS_RTOL)
        assert o["attrs"] == {"placement": "model"}
        assert o["local"] == (1, 64, 4096)


@pytest.mark.parametrize("mesh,groups,k", [
    (MESHES[4], (), 2), ({"model": 4}, (2, 1, 1), 3)])
def test_placed_fork_join_trains_as_world1(mesh, groups, k):
    """The placed lowering through the compile: the ensemble's fork-joins
    under inter:model over data 2 x model 2 (stacked, each rank one
    branch's slice) and under inter:model:2-1-1 over model 4 (three
    branches, weights replicated) train to the losses of the same model
    on one device."""
    want = _ensemble_fit({}, (), k)
    for o in ranks.shared(4, MOD).run("rank_ensemble_fit", mesh, groups, k):
        np.testing.assert_allclose(o["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        assert o["local"] == ((1, 16, 32) if not groups else (k, 16, 32))
