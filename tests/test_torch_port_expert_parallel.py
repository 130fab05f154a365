"""Expert parallelism on the port (ops/moe_ops.py over a mesh), against
the JAX package on the CPU mesh of the same shape, and the checkpoint
round trip across meshes with expert-sharded and stacked branch weights.

- tests/test_hybrid_parallel.py:112 at world 4 over {"data": 2,
  "expert": 2} with 8 experts (the tokens replicated over the expert
  axis: each rank keeps its experts' slots, the batch shards summed), and
  at world 2 over {"expert": 2} (the tokens sharded over the expert axis:
  one all-to-all each way): the losses of a 2-step fit equal JAX's, and
  each rank holds its 4 experts' kernel (4, 32, 32);
- the search on the "cpu-sim" machine of data 2 x expert 2 gives JAX's
  strategy for the MoE model (the `ep:` candidates and the
  `expert_parallel` substitution), and that strategy trains over the
  ranks to JAX's loss;
- ZeRO-1 and ZeRO-2 compose with `ep:expert` and with `inter:model`:
  the same losses as without (test_zero.py's 1e-6);
- a checkpoint saved under `ep:expert` and under `inter:model` (stacked
  branch weights, each rank holding one branch) loads onto another mesh
  (JAX tests/test_zero.py:253's round trip): the full weights equal and
  the loaded model's forward equals the saved one's.
f32; losses within 1e-5 relative of JAX's, weights bitwise.
"""

import numpy as np
import pytest

import _torch_port_ranks as ranks
import flexflow_tpu_torch as F
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.parallel import templates as T

MOD = __name__
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _close_groups():
    yield
    ranks.close_all()


GUIDS = (10 ** 6, 10 ** 7)  # the layer and tensor guids a build starts at


def _moe(pkg, cfg):
    """JAX's model; its unnamed layers take their names from the guid
    counters, set alike in both packages so a strategy names the same
    layers in each."""
    import importlib

    for mod, cls, start in (("core.layer", "Layer", GUIDS[0]),
                            ("core.tensor", "Tensor", GUIDS[1])):
        getattr(importlib.import_module(f"{pkg.__name__}.{mod}"),
                cls)._next_guid[0] = start
    m = pkg.FFModel(cfg)
    x = m.create_tensor([64, 32], name="x")
    y = m.moe(x, num_exp=8, num_select=2, expert_hidden_size=32, alpha=2.0,
              name="moe")
    m.dense(y, 4, name="head")
    return m


def _moe_data():
    xd = np.random.default_rng(4).normal(size=(128, 32)).astype(np.float32)
    return xd, (xd.sum(-1) > 0).astype(np.int32)


def _moe_layers(m):
    return [l for l in m.layers if l.op_type.value in ("group_by", "experts")]


def _branchy(pkg, cfg):
    import importlib

    m = pkg.FFModel(cfg)
    importlib.import_module(pkg.__name__ + ".models.branchy").build_branchy(
        m, batch=32, width=16, hidden=32, modules=2, k=2)
    return m


# ------------------------------------------------------------- rank code
def rank_moe_fit(mesh, params, strategy_json=None):
    from flexflow_tpu_torch.parallel.sharding import Strategy

    m = _moe(F, F.FFConfig(batch_size=64, mesh_shape=dict(mesh), seed=7,
                           only_data_parallel=strategy_json is None))
    cm = m.compile(F.SGDOptimizer(lr=0.05),
                   "sparse_categorical_crossentropy", [], device="cpu")
    if strategy_json is None:
        T.apply_expert_parallel(cm.strategy, _moe_layers(m), "expert")
    else:
        cm.strategy = Strategy.from_json(strategy_json)
    cm._build_steps()
    cm.load_params(params_from_jax(params))
    hist = cm.fit(*_moe_data(), epochs=1, verbose=False)
    ek = next(l.name for l in m.layers if l.op_type.value == "experts")
    return {"losses": [h["loss"] for h in hist],
            "expert_local": tuple(cm.params[ek]["kernel"].to_local().shape),
            "steps": cm._iteration}


def rank_round_trip(ckdir):
    """Save under ep:expert and under inter:model at world 4, load onto
    {"data": 4} (replicated experts and branches): full weights and the
    forward equal."""
    out = {}
    x_moe = _moe_data()[0][:64]
    x_fj = np.random.default_rng(2).normal(size=(32, 16)).astype(np.float32)
    for kind, mesh, x in (("moe", {"data": 2, "expert": 2}, x_moe),
                          ("branchy", {"data": 2, "model": 2}, x_fj)):
        build = _moe if kind == "moe" else _branchy
        m = build(F, F.FFConfig(batch_size=x.shape[0], mesh_shape=mesh,
                                seed=7, only_data_parallel=True))
        cm = m.compile(F.SGDOptimizer(lr=0.05),
                       "sparse_categorical_crossentropy", [], device="cpu")
        if kind == "moe":
            T.apply_expert_parallel(cm.strategy, _moe_layers(m), "expert")
        else:
            for l in m.layers:
                if l.op_type.value == "fork_join":
                    T.apply_branch_placement(cm.strategy, l, "model")
        cm._build_steps()
        cm.init(seed=11)
        path = f"{ckdir}/{kind}"
        cm.save_checkpoint(path)
        before = {f"{l}.{w}": cm.get_weight(l, w)
                  for l, ws in cm.params.items() for w in ws}
        local = {f"{l}.{w}": tuple(t.to_local().shape)
                 for l, ws in cm.params.items() for w, t in ws.items()}
        y0 = cm.forward(x).detach().numpy()
        m2 = build(F, F.FFConfig(batch_size=x.shape[0], seed=7,
                                 mesh_shape={"data": 4},
                                 only_data_parallel=True))
        cm2 = m2.compile(F.SGDOptimizer(lr=0.05),
                         "sparse_categorical_crossentropy", [], device="cpu")
        cm2.init(seed=99)
        cm2.load_checkpoint(path)
        after = {f"{l}.{w}": cm2.get_weight(l, w)
                 for l, ws in cm2.params.items() for w in ws}
        out[kind] = {"same": sorted(before) == sorted(after) and all(
            np.array_equal(before[k], after[k]) for k in before),
            "local": local,
            "forward_diff": float(np.abs(
                cm2.forward(x).detach().numpy() - y0).max())}
    return out


def rank_zero_modes():
    """MoE-MLP under ep:expert over {"data": 2, "expert": 2} and the
    ensemble under inter:model over {"data": 2, "model": 2}, Adam, one
    epoch of 2 steps with zero_sharding off, zero1 and zero2."""
    out = {}
    rng = np.random.default_rng(0)
    xf = rng.normal(size=(64, 16)).astype(np.float32)
    yf = rng.integers(0, 10, size=(64,)).astype(np.int32)
    for zero in ("off", "zero1", "zero2"):
        for kind, mesh, data in (("moe", {"data": 2, "expert": 2},
                                  _moe_data()),
                                 ("branchy", {"data": 2, "model": 2},
                                  (xf, yf))):
            build = _moe if kind == "moe" else _branchy
            m = build(F, F.FFConfig(batch_size=64 if kind == "moe" else 32,
                                    mesh_shape=mesh, seed=7,
                                    only_data_parallel=True,
                                    zero_sharding=zero))
            cm = m.compile(F.AdamOptimizer(alpha=1e-2),
                           "sparse_categorical_crossentropy", [],
                           device="cpu")
            if kind == "moe":
                T.apply_expert_parallel(cm.strategy, _moe_layers(m),
                                        "expert")
            else:
                for l in m.layers:
                    if l.op_type.value == "fork_join":
                        T.apply_branch_placement(cm.strategy, l, "model")
            cm._build_steps()
            cm.init(seed=3)
            hist = cm.fit(*data, epochs=2, verbose=False)
            out[f"{kind} {zero}"] = ([h["loss"] for h in hist], cm._zero)
    return out


# ------------------------------------------------------------------ tests
def _jax_moe(mesh, strategy=None):
    import jax

    import flexflow_tpu as J
    from flexflow_tpu.parallel.templates import apply_expert_parallel

    jm = _moe(J, J.FFConfig(batch_size=64, mesh_shape=dict(mesh), seed=7,
                            only_data_parallel=strategy is None))
    jcm = jm.compile(J.SGDOptimizer(lr=0.05),
                     "sparse_categorical_crossentropy", [])
    if strategy is None:
        apply_expert_parallel(jcm.strategy, _moe_layers(jm), "expert")
    else:
        jcm.strategy = strategy
    jcm._build_steps()
    jcm.init(seed=0)
    params = jax.device_get(jcm.params)
    return params, [h["loss"] for h in jcm.fit(*_moe_data(), epochs=1,
                                               verbose=False)]


@pytest.mark.parametrize("world,mesh", [(4, {"data": 2, "expert": 2}),
                                        (2, {"expert": 2})])
def test_expert_parallel_moe_matches_jax(world, mesh):
    """JAX's `test_expert_parallel_moe` on the port: JAX's losses on every
    rank, each rank holding 8 / 2 experts."""
    params, want = _jax_moe(mesh)
    outs = ranks.shared(world, MOD).run("rank_moe_fit", mesh, params)
    for o in outs:
        np.testing.assert_allclose(o["losses"], want, rtol=LOSS_RTOL)
        assert o["expert_local"] == (4, 32, 32) and o["steps"] == 2
    assert len({tuple(o["losses"]) for o in outs}) == 1


def test_search_gives_jax_strategy_and_it_trains():
    """graph_optimize on the "cpu-sim" machine of data 2 x expert 2: the
    port's strategy is JAX's, and it trains over 4 ranks to JAX's loss."""
    import flexflow_tpu as J
    from flexflow_tpu.parallel.machine import MachineSpec as JM
    from flexflow_tpu.parallel.sharding import Strategy as JStrategy
    from flexflow_tpu.search.optimize import graph_optimize as jopt
    from flexflow_tpu_torch.parallel.machine import MachineSpec
    from flexflow_tpu_torch.search.optimize import graph_optimize

    shape = {"data": 2, "expert": 2}
    cfg = dict(batch_size=64, search_budget=16, strategy_cache=False)
    st = graph_optimize(_moe(F, F.FFConfig(**cfg)),
                        MachineSpec(mesh_axes=shape, chip="cpu-sim"),
                        optimizer=F.SGDOptimizer(lr=0.05))
    js = jopt(_moe(J, J.FFConfig(**cfg)), JM(mesh_axes=shape, chip="cpu-sim"),
              optimizer=J.SGDOptimizer(lr=0.05))
    assert st.to_json() == js.to_json()
    params, want = _jax_moe(shape, JStrategy.from_json(st.to_json()))
    outs = ranks.shared(4, MOD).run("rank_moe_fit", shape, params,
                                    st.to_json())
    for o in outs:
        np.testing.assert_allclose(o["losses"], want, rtol=LOSS_RTOL)


def test_checkpoint_round_trip_across_meshes(tmp_path):
    """Expert-sharded kernels and stacked branch weights are saved full
    and reload onto a mesh of another layout, bitwise, with the same
    forward (1e-6)."""
    out = ranks.shared(4, MOD).run("rank_round_trip", str(tmp_path))
    for o in out:
        for kind in ("moe", "branchy"):
            assert o[kind]["same"], kind
            assert o[kind]["forward_diff"] <= 1e-6, o[kind]
        moe_local = o["moe"]["local"]
        assert (4, 32, 32) in moe_local.values()
        assert o["branchy"]["local"]["fj0.stk.mid.kernel"] == (1, 16, 32)


def test_zero_composes_with_ep_and_stacked_placement():
    """zero1 and zero2 over the data axis beside `ep:expert` and
    `inter:model`: the losses of 2 epochs equal zero off's within 1e-6."""
    (out,) = ranks.shared(4, MOD).run("rank_zero_modes")[:1]
    for kind in ("moe", "branchy"):
        base, mode = out[f"{kind} off"]
        assert mode == "off"
        for zero in ("zero1", "zero2"):
            got, mode = out[f"{kind} {zero}"]
            assert mode == zero
            np.testing.assert_allclose(got, base, rtol=1e-6)
