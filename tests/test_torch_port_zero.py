"""ZeRO and gradient accumulation over a mesh on the CPU: ranks spawned on
gloo, held against the JAX package on the same mesh shape.

Mirrors tests/test_zero.py: zero1's loss parity and per-rank moment
memory (an MLP and GPT-2), zero2 with accumulation and K-step dispatches,
the moments sharded from init, accum_steps against the bigger batch, and
the checkpoint round trip across meshes. World 2: over {"data": 2}, and
for the round trip from {"data": 2} under zero1 to {"data": 1,
"model": 2}, where the moments are not sharded.
The port loads the JAX initial weights (`convert.params_from_jax`).
Tolerances: 1e-5 relative against JAX in f32, and test_zero.py's own
(1e-6) between the port's ZeRO and plain runs; bitwise across ranks.
One group of ranks per world size serves the file
(tests/_torch_port_ranks.py), each case under a watchdog.
"""

import importlib

import numpy as np
import pytest

import _torch_port_ranks as ranks
import flexflow_tpu_torch as F
from flexflow_tpu_torch.convert import params_from_jax

MOD = __name__
RTOL = 1e-5
DP2 = {"data": 2}


@pytest.fixture(scope="module", autouse=True)
def _close_groups():
    yield
    ranks.close_all()


def _mlp(pkg, cfg, batch):
    m = pkg.FFModel(cfg)
    t = m.create_tensor([batch, 64], name="x")
    h = m.dense(t, 256, activation="gelu", name="up")
    h = m.dense(h, 64, name="down")
    m.dense(h, 8, name="head")
    return m


def _gpt2(pkg, cfg, batch):
    models = importlib.import_module(pkg.__name__ + ".models")
    m = pkg.FFModel(cfg)
    models.build_gpt2(m, models.GPT2Config(
        vocab=512, seq=16, d_model=64, heads=2, layers=1, dropout=0.0),
        batch=batch)
    return m


def _data(kind, n, rng):
    if kind == "gpt2":
        ids = rng.integers(0, 512, size=(n, 16)).astype(np.int32)
        pos = np.broadcast_to(np.arange(16, dtype=np.int32), (n, 16)).copy()
        y = rng.integers(0, 512, size=(n, 16)).astype(np.int32)
        return [ids, pos], y
    x = rng.normal(size=(n, 64)).astype(np.float32)
    return [x], rng.integers(0, 8, size=(n,)).astype(np.int32)


def _opt(pkg, name):
    return (pkg.SGDOptimizer(lr=0.05) if name == "sgd"
            else pkg.AdamOptimizer(alpha=0.01))


def _compile(pkg, kind, zero, batch, accum, mesh, opt, k=1, seed=3, **kw):
    cfg = pkg.FFConfig(batch_size=batch, only_data_parallel=True, seed=seed,
                       zero_sharding=zero, accum_steps=accum,
                       steps_per_dispatch=k, mesh_shape=dict(mesh), **kw)
    m = (_gpt2 if kind == "gpt2" else _mlp)(pkg, cfg, batch)
    return m.compile(_opt(pkg, opt), "sparse_categorical_crossentropy", [],
                     **({} if pkg is not F else {"device": "cpu"}))


# ------------------------------------------------------------- rank code
def rank_train(kind, zero, batch, accum, mesh, opt, params, n, epochs, k=1):
    cm = _compile(F, kind, zero, batch, accum, mesh, opt, k=k)
    cm.load_params(params_from_jax(params))
    syncs = [0]
    sync = cm._sync_grads

    def counted(grads):
        syncs[0] += 1
        return sync(grads)
    cm._sync_grads = counted
    init_mem = cm.memory_stats()
    mu = cm.opt_state.get("mu", {}).get("up", {}).get("kernel")
    x, y = _data(kind, n, np.random.default_rng(0))
    hist = cm.fit(x, y, epochs=epochs, verbose=False)
    return {"losses": [h["loss"] for h in hist], "init_mem": init_mem,
            "mem": cm.memory_stats(), "stats": dict(cm.step_stats),
            "syncs": syncs[0], "updates": cm._iteration,
            "mu_local": None if mu is None else tuple(mu.to_local().shape),
            "mu_placements": None if mu is None else str(mu.placements),
            "weights": {f"{l}.{w}": t.to_local().detach().numpy().copy()
                        for l, ws in cm.params.items()
                        for w, t in ws.items()}}


def _moments(cm):
    return {f"{m}.{l}.{w}": t.full_tensor().numpy().copy()
            for m in ("mu", "nu") for l, ws in cm.opt_state[m].items()
            for w, t in ws.items()}


def rank_roundtrip(params, ckdir):
    """Fit an epoch under zero1 over {"data": 2}, save, fit on; restore
    into a compile over {"data": 1, "model": 2} and fit the same epoch."""
    x, y = _data("mlp", 32, np.random.default_rng(0))
    cm1 = _compile(F, "mlp", "zero1", 16, 1, {"data": 2}, "adam", seed=5)
    cm1.load_params(params_from_jax(params))
    cm1.fit(x, y, epochs=1, verbose=False)
    cm1.save_checkpoint(ckdir, block=True)
    saved = _moments(cm1)
    ref = cm1.fit(x, y, epochs=1, verbose=False)[0]["loss"]
    cm2 = _compile(F, "mlp", "zero1", 16, 1, {"data": 1, "model": 2},
                   "adam", seed=5)
    cm2.init(seed=123)
    cm2.load_checkpoint(ckdir)
    got = _moments(cm2)
    mu = cm2.opt_state["mu"]["up"]["kernel"]
    return {"iteration": cm2._iteration,
            "same": all(np.array_equal(saved[k], got[k]) for k in saved),
            "mu_local": tuple(mu.to_local().shape),
            "ref": ref,
            "resumed": cm2.fit(x, y, epochs=1, verbose=False)[0]["loss"]}


# ------------------------------------------------------------ JAX side
def _jax(kind, zero, batch, accum, mesh, opt, n, epochs, k=1):
    import jax

    import flexflow_tpu as J

    cm = _compile(J, kind, zero, batch, accum, mesh, opt, k=k,
                  log_level="warning")
    cm.init(seed=0)
    params = jax.device_get(cm.params)
    x, y = _data(kind, n, np.random.default_rng(0))
    hist = cm.fit(x, y, epochs=epochs, verbose=False)
    return params, [h["loss"] for h in hist]


def _agree(outs):
    """Every rank saw the same losses and holds the same replicated
    weights, bit for bit."""
    for o in outs[1:]:
        assert o["losses"] == outs[0]["losses"]
        for name, v in o["weights"].items():
            assert np.array_equal(v, outs[0]["weights"][name]), name


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("kind", ["mlp", "gpt2"])
def test_zero1_loss_parity_and_memory_reduction(kind):
    """zero1 at world 2 trains as the plain mesh run does and as JAX's
    zero1 does on {"data": 2}, while each rank holds half the moment
    bytes and all the param bytes."""
    params, jl = _jax(kind, "zero1", 8, 1, DP2, "adam", 16, 2)
    g = ranks.shared(2, MOD)
    off = g.run("rank_train", kind, "off", 8, 1, DP2, "adam", params, 16, 2)
    z = g.run("rank_train", kind, "zero1", 8, 1, DP2, "adam", params, 16, 2)
    _agree(off)
    _agree(z)
    np.testing.assert_allclose(z[0]["losses"], jl, rtol=RTOL)
    np.testing.assert_allclose(z[0]["losses"], off[0]["losses"], atol=1e-6)
    mo, mz = off[0]["mem"], z[0]["mem"]
    assert mz["zero_sharding"] == "zero1" and mz["data_axis_degree"] == 2
    assert mo["zero_sharding"] == "off"
    if kind == "mlp":  # every weight has a dim that 2 divides
        assert 2 * mz["actual_opt_state_bytes_per_device"] == \
            mo["actual_opt_state_bytes_per_device"]
    assert mo["actual_opt_state_bytes_per_device"] >= \
        1.5 * mz["actual_opt_state_bytes_per_device"]
    assert mz["actual_param_bytes_per_device"] == \
        mo["actual_param_bytes_per_device"]


def test_zero2_accum_and_k_steps_parity():
    """zero2 (each microbatch's gradient reduce-scattered) with
    accum_steps=2 and two updates a dispatch equals the plain mesh run's
    accumulation within 1e-6, and JAX's zero2 on {"data": 2} within
    1e-5."""
    params, jl = _jax("mlp", "zero2", 8, 2, DP2, "adam", 64, 1, k=2)
    g = ranks.shared(2, MOD)
    ref = g.run("rank_train", "mlp", "off", 8, 2, DP2, "adam", params, 64, 1)
    z = g.run("rank_train", "mlp", "zero2", 8, 2, DP2, "adam", params, 64, 1,
              2)
    _agree(z)
    assert z[0]["stats"]["fused_steps"] > 0
    # zero2 reduce-scatters each of an update's 2 microbatch gradients
    # before summing them (the update's own sync then moves nothing);
    # the plain run syncs the sum once
    assert z[0]["syncs"] == 3 * z[0]["updates"]
    assert ref[0]["syncs"] == ref[0]["updates"]
    np.testing.assert_allclose(z[0]["losses"], ref[0]["losses"], atol=1e-6)
    np.testing.assert_allclose(z[0]["losses"], jl, rtol=RTOL)


def test_opt_state_sharded_from_init():
    """Under zero1 the moments are born sharded over "data": each rank's
    block of up's moment is half its rows, before any step."""
    params, _ = _jax("mlp", "zero1", 16, 1, DP2, "adam", 32, 1)
    outs = ranks.shared(2, MOD).run("rank_train", "mlp", "zero1", 16, 1,
                                    DP2, "adam", params, 32, 1)
    for o in outs:
        assert o["mu_local"] == (32, 256)
        assert o["mu_placements"] == "(Shard(dim=0),)"
        # two moments, each half a param's bytes on a rank
        mem = o["init_mem"]
        assert mem["actual_opt_state_bytes_per_device"] == \
            mem["actual_param_bytes_per_device"]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_accum_equivalence(opt):
    """accum_steps=4 at batch 8 equals one update at batch 32 on the same
    data over {"data": 2} (test_zero.py's 1e-6 relative), and each
    equals JAX's."""
    params, jacc = _jax("mlp", "off", 8, 4, DP2, opt, 64, 1)
    _, jbig = _jax("mlp", "off", 32, 1, DP2, opt, 64, 1)
    g = ranks.shared(2, MOD)
    acc = g.run("rank_train", "mlp", "off", 8, 4, DP2, opt, params, 64, 1)
    big = g.run("rank_train", "mlp", "off", 32, 1, DP2, opt, params, 64, 1)
    _agree(acc)
    np.testing.assert_allclose(acc[0]["losses"], big[0]["losses"], rtol=1e-6)
    np.testing.assert_allclose(acc[0]["losses"], jacc, rtol=RTOL)
    np.testing.assert_allclose(big[0]["losses"], jbig, rtol=RTOL)


def test_zero_checkpoint_roundtrip_across_meshes(tmp_path):
    """Moments saved sharded under zero1 over {"data": 2} restore bitwise
    under {"data": 1, "model": 2}, land in the new mesh's layout (no
    batch axis to shard over: whole on each rank), and training resumes
    on the same trajectory."""
    import jax

    import flexflow_tpu as J

    jcm = _compile(J, "mlp", "zero1", 16, 1, DP2, "adam", seed=5,
                   log_level="warning")
    jcm.init(seed=0)
    params = jax.device_get(jcm.params)
    outs = ranks.shared(2, MOD).run("rank_roundtrip", params,
                                    str(tmp_path / "ck"))
    for o in outs:
        assert o["iteration"] == 2 and o["same"]
        assert o["mu_local"] == (64, 256)
        assert o["resumed"] == pytest.approx(o["ref"], rel=1e-6)
