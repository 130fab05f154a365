"""Pipeline parallelism on the port at world 4: four gloo ranks spawned on
the CPU, held against the JAX package's `PipelinedModel` on its CPU mesh
of the same size and against the port's own runs.

Mirrors tests/test_pipeline.py: four stages of one rank with disjoint
weights and `per_stage_param_bytes` (`:115`); two stages of {"data": 2}
with zero1 inside each stage (`:136`), whose moments are sharded over the
stage's data axis; the cross-mesh and stage-count-elastic restore (a
snapshot of 2 stages x {"data": 2} under zero1 restored onto 4 stages of
one rank, which then trains on the saving run's trajectory), with the
legacy stage-keyed schema refused (`:151`, `:188`); and an imported
strategy whose cuts are listed out of order (`:413`). JAX's initial
weights reach the port through `convert.params_from_jax`. Tolerances,
f32: 1e-5 relative on losses against JAX and across stage partitions
(float reassociation), 1e-6 between the port's zero1 and plain runs.
"""

import json
import os

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


def _mlp(pkg, cfg, batch=8):
    m = pkg.FFModel(cfg)
    t = m.create_tensor([batch, 64], name="x")
    h = m.dense(t, 256, activation="gelu", name="up")
    h = m.dense(h, 64, name="down")
    h = m.dense(h, 128, activation="relu", name="mid")
    m.dense(h, 8, name="head")
    return m


def _data(n=64):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 64)).astype(np.float32)
    return [x], rng.integers(0, 8, size=(n,)).astype(np.int32)


def _compile(pkg, stages, accum, mesh, zero="off", **kw):
    cfg = pkg.FFConfig(batch_size=8, only_data_parallel=True, seed=3,
                       pipeline_stages=stages, accum_steps=accum,
                       zero_sharding=zero, mesh_shape=dict(mesh), **kw)
    m = _mlp(pkg, cfg)
    extra = {"device": "cpu"} if pkg is F else {}
    return m.compile(pkg.AdamOptimizer(alpha=0.01),
                     "sparse_categorical_crossentropy", [], **extra)


def _jax(stages, accum, mesh, zero="off", epochs=2):
    import jax

    import flexflow_tpu as J

    cm = _compile(J, stages, accum, mesh, zero, log_level="warning")
    cm.init(seed=0)
    params = jax.device_get(cm.merged_params())
    x, y = _data()
    hist = cm.fit(x, y, epochs=epochs, verbose=False)
    return params, [h["loss"] for h in hist], list(cm.cuts)


# ------------------------------------------------------------- rank code
def rank_fit(stages, accum, mesh, zero, params, epochs=2, strategy=""):
    cm = _compile(F, stages, accum, mesh, zero,
                  import_strategy_file=strategy)
    cm.load_params(params_from_jax(params))
    x, y = _data()
    hist = cm.fit(x, y, epochs=epochs, verbose=False)
    mu = cm.opt_state["mu"]
    return {"losses": [h["loss"] for h in hist], "stage": cm.stage,
            "cuts": list(cm.cuts), "layers": sorted(cm.params),
            "bounds": [b.owner.name for b in cm.boundaries],
            "stage_layers": [[l.name for l in seg]
                             for seg in cm.stage_layers],
            "mem": cm.memory_stats(),
            "mu_placements": {l: str(ws["kernel"].placements)
                              for l, ws in mu.items()
                              if hasattr(ws["kernel"], "placements")}}


def rank_restore(params, ckdir):
    """Two stages of {"data": 2} under zero1: an epoch, a snapshot, and
    the next epoch (the reference); then four stages of one rank restore
    the snapshot and run that epoch; then the legacy schema."""
    from flexflow_tpu_torch.runtime.checkpoint import CheckpointMismatchError

    x, y = _data()
    cm2 = _compile(F, 2, 4, {"data": 4}, "zero1")
    cm2.load_params(params_from_jax(params))
    cm2.fit(x, y, epochs=1, verbose=False)
    cm2.save_checkpoint(ckdir)
    ref = cm2.fit(x, y, epochs=1, verbose=False)[0]["loss"]
    saved_iter = cm2._iteration - 2
    cm4 = _compile(F, 4, 4, {"data": 4})
    cm4.init(seed=123)
    cm4.load_checkpoint(ckdir)
    restored_iter = cm4._iteration
    resumed = cm4.fit(x, y, epochs=1, verbose=False)[0]["loss"]
    import torch.distributed as dist

    if dist.get_rank() == 0:
        meta_path = os.path.join(ckdir, "meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        del meta["opt_schema"]  # a checkpoint of the stage-keyed schema
        with open(meta_path, "w") as f:
            json.dump(meta, f)
    dist.barrier()
    try:
        cm4.load_checkpoint(ckdir)
        legacy = "restored"
    except CheckpointMismatchError as e:
        legacy = str(e)
    return {"ref": ref, "resumed": resumed, "saved_iter": saved_iter,
            "restored_iter": restored_iter, "legacy": legacy,
            "files": sorted(os.listdir(os.path.join(ckdir, "tree")))}


# ------------------------------------------------------------------ tests
def test_four_stages_hold_disjoint_weights():
    """S = 4 at world 4: JAX's losses (1e-5), each rank holds only its
    stage's layers, and the stages' bytes add up to the model's."""
    params, jl, jcuts = _jax(4, 8, {"data": 4})
    outs = ranks.shared(4, MOD).run("rank_fit", 4, 8, {"data": 4}, "off",
                                    params)
    assert [o["stage"] for o in outs] == [0, 1, 2, 3]
    for o in outs[1:]:
        assert o["losses"] == outs[0]["losses"]
    np.testing.assert_allclose(outs[0]["losses"], jl, rtol=RTOL)
    assert outs[0]["cuts"] == jcuts
    names = [set(o["layers"]) for o in outs]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not names[i] & names[j]
    full = sum(int(np.prod(v.shape)) * 4 for ws in params.values()
               for v in ws.values())
    mem = outs[0]["mem"]
    assert sum(mem["per_stage_param_bytes"]) == full
    assert mem["actual_param_bytes_per_device"] <= full / 2
    for o in outs[1:]:
        assert o["mem"]["per_stage_param_bytes"] == \
            mem["per_stage_param_bytes"]


def test_zero1_shards_moments_inside_each_stage():
    """Two stages of {"data": 2} under zero1: JAX's losses on {"data": 4}
    (1e-5) and the plain run's (1e-6); each stage's moments are sharded
    over its data axis, so a rank holds half the moment bytes."""
    params, jl, _ = _jax(2, 4, {"data": 4}, "zero1")
    g = ranks.shared(4, MOD)
    z = g.run("rank_fit", 2, 4, {"data": 4}, "zero1", params)
    off = g.run("rank_fit", 2, 4, {"data": 4}, "off", params)
    assert [o["stage"] for o in z] == [0, 0, 1, 1]
    for o in z[1:]:
        assert o["losses"] == z[0]["losses"]
    np.testing.assert_allclose(z[0]["losses"], jl, rtol=RTOL)
    np.testing.assert_allclose(z[0]["losses"], off[0]["losses"], atol=1e-6)
    mz, mo = z[0]["mem"], off[0]["mem"]
    assert mz["zero_sharding"] == "zero1" and mo["zero_sharding"] == "off"
    # the two moments halve on each rank; Adam's int32 count stays whole
    zo, oo = (m["actual_opt_state_bytes_per_device"] for m in (mz, mo))
    assert 2 * (zo - 4) == oo - 4
    assert zo - 4 == mz["actual_param_bytes_per_device"]
    assert any("Shard" in p for p in z[0]["mu_placements"].values())


def test_cross_mesh_and_stage_count_elastic_restore(tmp_path):
    """A snapshot of 2 stages x {"data": 2} under zero1 restores onto 4
    stages of one rank (another stage count, cut set and stage mesh),
    which trains the next epoch on the saving run's trajectory (1e-5);
    each stage wrote its file; the legacy schema is refused."""
    import jax

    import flexflow_tpu as J

    jcm = _compile(J, 2, 4, {"data": 4}, "zero1", log_level="warning")
    jcm.init(seed=0)
    params = jax.device_get(jcm.merged_params())
    outs = ranks.shared(4, MOD).run("rank_restore", params,
                                    str(tmp_path / "ck"))
    for o in outs:
        assert o["files"] == ["stage-0.pt", "stage-1.pt"]
        assert o["restored_iter"] == o["saved_iter"] == 2
        assert o["resumed"] == pytest.approx(o["ref"], rel=RTOL)
        assert "legacy" in o["legacy"]


def test_unsorted_imported_cuts_are_normalized(tmp_path):
    """A strategy file listing four stages' cuts out of order trains as
    the sorted one does: stages and boundaries pair in topo order."""
    import jax

    import flexflow_tpu as J

    jcm = _compile(J, 4, 8, {"data": 4}, log_level="warning")
    jcm.init(seed=0)
    params = jax.device_get(jcm.merged_params())
    st = dict(jcm.strategy.to_json())
    st["pipeline"] = dict(st["pipeline"],
                          cuts=sorted(st["pipeline"]["cuts"], reverse=True))
    path = str(tmp_path / "s.json")
    with open(path, "w") as f:
        json.dump(st, f)
    g = ranks.shared(4, MOD)
    got = g.run("rank_fit", 4, 8, {"data": 4}, "off", params, 1, path)
    ref = g.run("rank_fit", 4, 8, {"data": 4}, "off", params, 1)
    assert got[0]["cuts"] == sorted(st["pipeline"]["cuts"])
    o = got[0]
    for b in range(3):  # boundary b is an output of stage b
        assert o["bounds"][b] in o["stage_layers"][b]
    assert got[0]["losses"] == ref[0]["losses"]
