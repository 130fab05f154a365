"""Pipeline parallelism on the port (parallel/pipeline.py) at world 2: two
gloo ranks spawned on the CPU, one stage each, held against the JAX
package's `PipelinedModel` on its CPU mesh of the same size
(`mesh_shape={"data": 2}`, 2 stages of {"data": 1}) and against the port's
own sequential accum_steps run (world 1, in this process), from the same
weights (JAX's, through `convert.params_from_jax`; each rank keeps its
stage's layers) and data.

Mirrors tests/test_pipeline.py: the schedules against the sequential loop
(an MLP under SGD and Adam, GPT-2 under Adam; 1F1B equals GPipe bitwise
in the port, `:65-80`), dropout's rng parity (`:82`), batch norm's
running stats chaining in the last stage under both schedules (`:349`),
the regularizer loss reported from every stage (`:389`); and the
boundary hop under a fault plan with one transient failure
(`pipe/boundary_hop`), whose losses equal the clean run's; the warm
strategy cache, which skips the cut search (`:288`); and durable
snapshots of the "pipeline" format with `resume="auto"`. Every rank
returns the same history. Tolerances, f32: 1e-5 relative on losses
against JAX and against the sequential run (float reassociation), 1e-6
on batch norm's stats (JAX's own).
"""

import numpy as np
import pytest

import _torch_port_ranks as ranks
import flexflow_tpu_torch as F
from flexflow_tpu_torch.convert import params_from_jax

MOD = __name__
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _close_groups():
    yield
    ranks.close_all()


def _reset_guids():
    """The guid counters a fresh process starts from: dropout keys fold
    the layer guid, so the sequential model and each rank's must be
    numbered alike."""
    from flexflow_tpu_torch.core.layer import Layer
    from flexflow_tpu_torch.core.tensor import Tensor

    Layer._next_guid[0] = 100
    Tensor._next_guid[0] = 1000


def _mlp(pkg, cfg, batch=8, bn=False):
    m = pkg.FFModel(cfg)
    t = m.create_tensor([batch, 64], name="x")
    h = m.dense(t, 256, activation="gelu", name="up")
    if bn:
        h = m.batch_norm(h, relu=True, name="bn")
        m.dense(h, 8, name="head")
        return m
    h = m.dense(h, 64, name="down")
    h = m.dense(h, 128, activation="relu", name="mid")
    m.dense(h, 8, name="head")
    return m


def _gpt2(pkg, cfg, batch=8, dropout=0.0):
    import importlib

    models = importlib.import_module(pkg.__name__ + ".models")
    m = pkg.FFModel(cfg)
    models.build_gpt2(m, models.GPT2Config(vocab=512, seq=16, d_model=64,
                                           heads=2, layers=2,
                                           dropout=dropout), batch=batch)
    return m


def _data(kind, n):
    rng = np.random.default_rng(0)
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


def _build(pkg, kind, stages, sched="1f1b", accum=4, dropout=0.0, reg=False,
           mesh=None, **kw):
    cfg = pkg.FFConfig(batch_size=8, only_data_parallel=True, seed=3,
                       pipeline_stages=stages, pipeline_schedule=sched,
                       accum_steps=accum, mesh_shape=dict(mesh or {}), **kw)
    if kind == "gpt2":
        m = _gpt2(pkg, cfg, dropout=dropout)
    else:
        m = _mlp(pkg, cfg, bn=kind == "bn")
    if reg:
        m.add_weight_regularizer("up", "kernel", "l2", 0.01)
    return m


def _compile(pkg, m, opt):
    extra = {"device": "cpu"} if pkg is F else {}
    return m.compile(_opt(pkg, opt), "sparse_categorical_crossentropy", [],
                     **extra)


# ------------------------------------------------------------- rank code
def rank_fit(kind, sched, opt, params, n=64, epochs=2, dropout=0.0,
             reg=False, plan=""):
    from flexflow_tpu_torch.runtime import faults

    _reset_guids()
    m = _build(F, kind, 2, sched, dropout=dropout, reg=reg)
    cm = _compile(F, m, opt)
    if params is None:
        cm.init(seed=0)
    else:
        cm.load_params(params_from_jax(params))
    x, y = _data(kind, n)
    if plan:
        faults.configure(plan)
    try:
        hist = cm.fit(x, y, epochs=epochs, verbose=False)
        fired = faults.fired() if plan else {}
    finally:
        faults.clear()
    out = {"losses": [h["loss"] for h in hist], "cuts": list(cm.cuts),
           "stage": cm.stage, "type": type(cm).__name__, "fired": fired,
           "layers": sorted(cm.params),
           "state": {k: v.detach().numpy().copy()
                     for k, v in cm.stage_state.items()},
           "weights": {f"{l}.{w}": t.detach().numpy().copy()
                       for l, ws in cm.params.items()
                       for w, t in ws.items()}}
    if kind != "gpt2":
        out["forward"] = np.asarray(cm.forward(x[0][:8]))
        out["eval"] = cm.evaluate(x, y)["loss"]
    return out


def rank_cached_compile(cache_dir):
    """Two compiles with the cut search on (search_budget > 0) against one
    strategy cache: the second finds the pipeline block and runs no DP."""
    from flexflow_tpu_torch.search.dp import SEARCH_STATS, reset_search_stats

    def once():
        m = _build(F, "mlp", 2, search_budget=8, strategy_cache_dir=cache_dir)
        m.config.only_data_parallel = False
        return _compile(F, m, "sgd")

    reset_search_stats()
    a = once()
    cold = dict(SEARCH_STATS)
    reset_search_stats()
    b = once()
    return {"cold": cold, "warm": dict(SEARCH_STATS),
            "pipelines": [a.strategy.pipeline, b.strategy.pipeline],
            "events": [a.search_cache_info["event"],
                       b.search_cache_info["event"]],
            "searched": getattr(a.strategy, "_pipeline_search", None)
            is not None}


def rank_durable(root, epochs, resume):
    """A fit of `epochs` with a durable snapshot every 2 updates under
    `root` (resume="auto" continues the newest one): the losses and the
    manifests committed."""
    from flexflow_tpu_torch.runtime.resilience import committed_snapshots

    m = _build(F, "mlp", 2)
    cm = _compile(F, m, "adam")
    cm.init(seed=0)
    x, y = _data("mlp", 32)
    hist = cm.fit(x, y, epochs=epochs, verbose=False, checkpoint_dir=root,
                  checkpoint_every_steps=2, resume=resume)
    return {"losses": [h["loss"] for h in hist], "iteration": cm._iteration,
            "snapshots": [(st, man["format"], man.get("pipeline"))
                          for st, _, man in committed_snapshots(root)]}


# ------------------------------------------------------------ references
def _jax_pipelined(kind, sched, opt, n=64, epochs=2, reg=False):
    """JAX's PipelinedModel, 2 stages on {"data": 2}: (merged initial
    params, losses, cuts, the last stage's state, forward of the first
    batch)."""
    import jax

    import flexflow_tpu as J

    m = _build(J, kind, 2, sched, reg=reg, mesh={"data": 2},
               log_level="warning")
    cm = _compile(J, m, opt)
    cm.init(seed=0)
    params = jax.device_get(cm.merged_params())
    x, y = _data(kind, n)
    hist = cm.fit(x, y, epochs=epochs, verbose=False)
    st = {k: np.asarray(v) for k, v in cm.stage_state[-1].items()}
    fwd = np.asarray(cm.forward(x[0][:8])) if kind != "gpt2" else None
    return params, [h["loss"] for h in hist], list(cm.cuts), st, fwd


def _port_sequential(kind, opt, params, n=64, epochs=2, dropout=0.0,
                     reg=False):
    """The port's sequential accum_steps=4 run at world 1, in this
    process: (losses, state)."""
    _reset_guids()
    m = _build(F, kind, 1, dropout=dropout, reg=reg)
    cm = _compile(F, m, opt)
    if params is None:
        cm.init(seed=0)
    else:
        cm.load_params(params_from_jax(params))
    x, y = _data(kind, n)
    hist = cm.fit(x, y, epochs=epochs, verbose=False)
    return [h["loss"] for h in hist], {k: v.detach().numpy()
                                       for k, v in cm.state.items()}


def _same_history(outs):
    assert outs[0]["losses"] == outs[1]["losses"]
    assert [o["stage"] for o in outs] == [0, 1]
    assert not set(outs[0]["layers"]) & set(outs[1]["layers"])


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("kind,opt", [("mlp", "sgd"), ("mlp", "adam"),
                                      ("gpt2", "adam")])
def test_schedules_match_jax_and_the_sequential_run(kind, opt):
    """Both schedules train to JAX's pipelined losses and to the port's
    sequential accum loop's (1e-5), 1F1B equals GPipe bitwise, the cuts
    are JAX's, and forward and evaluate agree with JAX's."""
    n = 32 if kind == "gpt2" else 64  # GPT-2: 2 updates an epoch
    params, jl, jcuts, _, jfwd = _jax_pipelined(kind, "1f1b", opt, n)
    seq, _ = _port_sequential(kind, opt, params, n)
    g = ranks.shared(2, MOD)
    gp = g.run("rank_fit", kind, "gpipe", opt, params, n)
    fb = g.run("rank_fit", kind, "1f1b", opt, params, n)
    for outs in (gp, fb):
        _same_history(outs)
        assert outs[0]["type"] == "PipelinedModel"
        assert outs[0]["cuts"] == jcuts
    assert fb[0]["losses"] == gp[0]["losses"]
    for r in (0, 1):
        for k, v in fb[r]["weights"].items():
            assert np.array_equal(v, gp[r]["weights"][k]), k
    np.testing.assert_allclose(fb[0]["losses"], jl, rtol=RTOL)
    np.testing.assert_allclose(fb[0]["losses"], seq, rtol=RTOL)
    if jfwd is not None:
        for o in fb:
            np.testing.assert_allclose(o["forward"], jfwd, rtol=1e-4,
                                       atol=1e-5)
        assert fb[0]["eval"] == fb[1]["eval"]


def test_dropout_draws_the_sequential_runs_masks():
    """GPT-2 at dropout 0.1: microbatch m of update i draws from
    fold_in(fold_in(key(seed + 17), i), m) in F and in its recompute, and
    the masks fold the layer guid, so the pipelined run's losses are the
    sequential run's."""
    seq, _ = _port_sequential("gpt2", "adam", None, 32, dropout=0.1)
    g = ranks.shared(2, MOD)
    for sched in ("1f1b", "gpipe"):
        outs = g.run("rank_fit", "gpt2", sched, "adam", None, 32, 2, 0.1)
        _same_history(outs)
        np.testing.assert_allclose(outs[0]["losses"], seq, rtol=RTOL)


def test_batchnorm_state_chains_under_both_schedules():
    """Batch norm in the last stage: its B runs from the live state, so
    the running stats chain through the M microbatches as the sequential
    loop's do (JAX's and the port's), under gpipe and 1f1b."""
    params, jl, _, jst, _ = _jax_pipelined("bn", "1f1b", "sgd", epochs=1)
    seq, sst = _port_sequential("bn", "sgd", params, epochs=1)
    assert sst, "no running state"
    g = ranks.shared(2, MOD)
    for sched in ("gpipe", "1f1b"):
        outs = g.run("rank_fit", "bn", sched, "sgd", params, 64, 1)
        last = outs[1]
        assert "bn" in last["layers"]
        for k, v in sst.items():
            np.testing.assert_allclose(last["state"][k], v, rtol=1e-6,
                                       err_msg=f"{sched}:{k}")
            np.testing.assert_allclose(last["state"][k], jst[k], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{sched}:{k}")
        np.testing.assert_allclose(outs[0]["losses"], jl, rtol=RTOL)


def test_regularizer_loss_reported_from_every_stage():
    """An l2 penalty on stage 0's weight reaches the reported loss of
    every rank, as the sequential loop and JAX's pipeline report it."""
    params, jl, _, _, _ = _jax_pipelined("mlp", "1f1b", "sgd", reg=True)
    seq, _ = _port_sequential("mlp", "sgd", params, reg=True)
    outs = ranks.shared(2, MOD).run("rank_fit", "mlp", "1f1b", "sgd",
                                    params, 64, 2, 0.0, True)
    _same_history(outs)
    assert "up" in outs[0]["layers"]
    np.testing.assert_allclose(outs[0]["losses"], seq, rtol=RTOL)
    np.testing.assert_allclose(outs[0]["losses"], jl, rtol=RTOL)
    assert seq[-1] > 1.0  # the penalty is material: parity is not vacuous


def test_boundary_hop_survives_a_transient_fault():
    """A fault plan failing each rank's second hop once: the hop is
    retried under the retry policy (the fault fires before the send is
    posted) and the run's losses are the clean run's, bit for bit."""
    g = ranks.shared(2, MOD)
    clean = g.run("rank_fit", "mlp", "1f1b", "adam", None, 32, 1)
    hit = g.run("rank_fit", "mlp", "1f1b", "adam", None, 32, 1, 0.0, False,
                "pipe/boundary_hop@2*1")
    for o in hit:
        assert o["fired"] == {"pipe/boundary_hop": 1}
    assert hit[0]["losses"] == clean[0]["losses"]


def test_warm_cache_skips_the_cut_search(tmp_path):
    """The cut search's result is stored with its pipeline block under the
    pipelined compile's key: a second compile hits it and runs no DP
    (JAX's headline contract for the cache)."""
    outs = ranks.shared(2, MOD).run("rank_cached_compile",
                                    str(tmp_path / "cache"))
    for o in outs:
        assert o["searched"] and o["cold"]["calls"] > 0
        assert o["events"] == ["miss", "hit"]
        assert o["warm"].get("calls", 0) == 0
        assert o["warm"].get("expansions", 0) == 0
        assert o["pipelines"][0] == o["pipelines"][1]
        assert o["pipelines"][0]["stages"] == 2


def test_durable_snapshots_resume_the_same_trajectory(tmp_path):
    """fit with checkpoint_dir commits "pipeline" snapshots (every rank its
    stage's part, rank 0 the manifest); a relaunch with resume="auto"
    continues from the newest and ends where an uninterrupted run ends."""
    g = ranks.shared(2, MOD)
    root = str(tmp_path / "root")
    full = g.run("rank_durable", str(tmp_path / "full"), 3, "")
    first = g.run("rank_durable", root, 2, "")
    again = g.run("rank_durable", root, 3, "auto")
    for o in first:
        assert o["snapshots"] and all(
            f == "pipeline" and p["stages"] == 2
            for _, f, p in o["snapshots"])
    assert again[0]["iteration"] == full[0]["iteration"]
    assert again[0]["losses"][:2] == first[0]["losses"]
    np.testing.assert_allclose(again[0]["losses"], full[0]["losses"],
                               rtol=1e-6)
    assert again[0]["losses"] == again[1]["losses"]
