"""The port over a mesh on the CPU: ranks spawned on gloo, held against
the JAX package on the same mesh shape (JAX's `build_mesh` takes the
first N of the suite's 8 virtual CPU devices).

Mirrors tests/test_hybrid_parallel.py (the DP+TP transformer block, a
hybrid training step, the explicit parallel ops, the sharded embedding)
at world 4 over {"data": 2, "model": 2}, and tests/test_multihost.py:104
(a two-process fit whose ranks agree) at world 2 over {"data": 2}. The
port loads the JAX initial weights (`convert.params_from_jax`).
Tolerances: 1e-5 relative (and 1e-5 absolute, for values near zero)
against JAX in f32; bitwise across ranks. One group of ranks per world
size serves every case of the file (tests/_torch_port_ranks.py), each
case under a watchdog. The config and refusal checks at the end need no
group.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import _torch_port_ranks as ranks
import flexflow_tpu_torch as F
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.parallel import templates as T

MOD = __name__
RTOL = ATOL = 1e-5
HYBRID = {"data": 2, "model": 2}


@pytest.fixture(scope="module", autouse=True)
def _close_groups():
    yield
    ranks.close_all()


# ----------------------------------------------------------- model builds
def build_block(pkg, cfg, b=16, s=8, d=64):
    """tests/test_hybrid_parallel.py's block, in either package."""
    m = pkg.FFModel(cfg)
    x = m.create_tensor([b, s, d], name="x")
    att = m.multihead_attention(x, x, x, d, 4, name="mha")
    h = m.add(att, x)
    h = m.layer_norm(h, name="ln1")
    up = m.dense(h, 4 * d, activation="gelu", name="ffn_up")
    down = m.dense(up, d, name="ffn_down")
    h = m.add(down, h)
    m.dense(m.layer_norm(h, name="ln2"), 16, name="head")
    return m


def build_parallel_ops(pkg, cfg):
    m = pkg.FFModel(cfg)
    x = m.create_tensor([8, 16], name="x")
    t = m.repartition(x, dim=1, axis="model")
    t = m.dense(t, 16, name="d1")
    t = m.combine(t, dim=1, axis="model")
    t = m.replicate(t)
    m.dense(t, 4, name="d2")
    return m


def build_embedding(pkg, cfg):
    m = pkg.FFModel(cfg)
    ids = m.create_tensor([32, 4], "int32", name="ids")
    emb = m.embedding(ids, 1024, 64, aggr="sum", name="table")
    m.dense(emb, 2, name="head")
    return m


def build_mlp2(pkg, cfg):
    """tests/_multihost_worker.py's model."""
    m = pkg.FFModel(cfg)
    x = m.create_tensor([32, 16], name="x")
    h = m.dense(x, 64, activation="relu", name="fc1")
    m.dense(h, 4, name="head")
    return m


BUILDS = {"block": build_block, "parallel_ops": build_parallel_ops,
          "embedding": build_embedding, "mlp2": build_mlp2}


def apply_templates(pkg_templates, cm, m, which):
    if "tp" in which:
        pkg_templates.apply_tensor_parallel_attention(
            cm.strategy, m.get_layer_by_name("mha"), "model")
        pkg_templates.apply_tensor_parallel_linear_pair(
            cm.strategy, m.get_layer_by_name("ffn_up"),
            m.get_layer_by_name("ffn_down"), "model")
    if "emb" in which:
        pkg_templates.apply_sharded_embedding(
            cm.strategy, m.get_layer_by_name("table"), "model", dim=0)


def _cfg(pkg, mesh, batch, **kw):
    return pkg.FFConfig(batch_size=batch, mesh_shape=dict(mesh),
                        only_data_parallel=True, seed=7, **kw)


# ------------------------------------------------------------- rank code
def _port(kind, mesh, batch, which, params, lr=0.01):
    m = BUILDS[kind](F, _cfg(F, mesh, batch))
    cm = m.compile(F.SGDOptimizer(lr=lr), "sparse_categorical_crossentropy",
                   [], device="cpu")
    apply_templates(T, cm, m, which)
    cm._build_steps()
    cm.load_params(params_from_jax(params))
    return m, cm


def _locals(cm):
    return {f"{l}.{w}": t.to_local().detach().numpy().copy()
            for l, ws in cm.params.items() for w, t in ws.items()}


def _fulls(cm):
    return {f"{l}.{w}": cm.get_weight(l, w)
            for l, ws in sorted(cm.params.items()) for w in sorted(ws)}


def rank_forward(kind, mesh, batch, which, params, x):
    m, cm = _port(kind, mesh, batch, which, params)
    y = cm.forward(x).detach().numpy()
    return {"y": y, "local": {k: v.shape for k, v in _locals(cm).items()},
            "placements": {f"{l}.{w}": str(t.placements)
                           for l, ws in cm.params.items()
                           for w, t in ws.items()}}


def rank_fit(kind, mesh, batch, which, params, x, y, epochs, lr):
    m, cm = _port(kind, mesh, batch, which, params, lr=lr)
    hist = cm.fit(x, y, epochs=epochs, verbose=False)
    return {"losses": [h["loss"] for h in hist], "full": _fulls(cm),
            "local": _locals(cm),
            "replicated": sorted(f"{l}.{w}" for l, ws in cm.params.items()
                                 for w, t in ws.items()
                                 if all(p.is_replicate()
                                        for p in t.placements))}


def rank_multihost(params, xv, yv, ckdir):
    """tests/_multihost_worker.py's flow: fit, evaluate, forward, a
    checkpoint round trip, set/get_weight."""
    import torch.distributed as dist

    m, cm = _port("mlp2", {"data": 2}, 32, "", params, lr=0.05)
    assert cm.mesh is not None and dist.get_world_size() == 2
    hist = cm.fit(xv, yv, epochs=2, verbose=False)
    losses = [h["loss"] for h in hist]
    ev = cm.evaluate(xv, yv)
    out = cm.forward(xv[:32])
    local_rows = cm.infer(cm.params, cm.state, [xv[:32]])[0].to_local()
    cm.save_checkpoint(ckdir)
    before = cm.get_weight("fc1", "kernel")
    cm.init(seed=99)
    cm.load_checkpoint(ckdir)
    after = cm.get_weight("fc1", "kernel")
    cm.set_weight("head", "kernel", np.zeros((64, 4), np.float32))
    return {"losses": losses, "eval": ev["loss"], "out": tuple(out.shape),
            "local_rows": tuple(local_rows.shape),
            "restored": bool(np.array_equal(before, after)),
            "head": float(np.abs(cm.get_weight("head", "kernel")).sum()),
            "fc1": before}


# ------------------------------------------------------------ JAX side
def _jax(kind, mesh, batch, which, lr=0.01):
    import jax

    import flexflow_tpu as J
    from flexflow_tpu.parallel import templates as JT

    m = BUILDS[kind](J, _cfg(J, mesh, batch))
    cm = m.compile(J.SGDOptimizer(lr=lr), "sparse_categorical_crossentropy",
                   [])
    apply_templates(JT, cm, m, which)
    cm._build_steps()
    cm.init(seed=3)
    return m, cm, jax.device_get(cm.params)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


# ------------------------------------------------------------------ tests
def test_dp_tp_transformer_block_matches_jax():
    """The DP+TP block (attention by heads, the column/row FFN pair) at
    world 4 over {"data": 2, "model": 2}: its forward equals JAX's on the
    same mesh, every rank holds the same output, and the weights are
    sharded over the model axis."""
    x = np.random.default_rng(0).normal(size=(16, 8, 64)).astype(np.float32)
    jm, jcm, params = _jax("block", HYBRID, 16, "tp")
    want = np.asarray(jm.forward(x))
    outs = ranks.shared(4, MOD).run("rank_forward", "block", HYBRID, 16,
                                    "tp", params, x)
    for o in outs:
        _close(o["y"], want, "forward")
        assert np.array_equal(o["y"], outs[0]["y"])
        assert o["local"]["ffn_up.kernel"] == (64, 128)   # 256 / 2
        assert o["local"]["ffn_down.kernel"] == (128, 64)
        assert o["local"]["mha.wq"] == (64, 32)           # 4 heads / 2
        assert o["local"]["mha.wo"] == (32, 64)
        assert o["local"]["ln1.gamma"] == (64,)
    assert "Shard(dim=1)" in outs[0]["placements"]["ffn_up.kernel"]


def test_hybrid_training_step_matches_jax():
    """Two epochs of SGD on the DP+TP block at world 4: the losses and
    the final weights equal JAX's on the same mesh, and the replicated
    weights are bitwise equal on every rank."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 8, 64)).astype(np.float32)
    y = np.random.default_rng(2).integers(0, 16, size=(32, 8)).astype(
        np.int32)
    jm, jcm, params = _jax("block", HYBRID, 16, "tp")
    jhist = jcm.fit(x, y, epochs=2, verbose=False)
    outs = ranks.shared(4, MOD).run("rank_fit", "block", HYBRID, 16, "tp",
                                    params, x, y, 2, 0.01)
    for o in outs:
        np.testing.assert_allclose(o["losses"], [h["loss"] for h in jhist],
                                   rtol=RTOL)
        for name, v in o["full"].items():
            layer, w = name.split(".")
            _close(v, np.asarray(jcm.get_weight(layer, w)), name)
    assert {"ln1.gamma", "head.kernel", "mha.bo"} <= set(outs[0]["replicated"])
    for r in outs[1:]:
        assert r["losses"] == outs[0]["losses"]
        for name in outs[0]["replicated"]:
            assert np.array_equal(r["local"][name], outs[0]["local"][name])


def test_explicit_parallel_ops_match_jax():
    """repartition -> dense -> combine -> replicate -> dense at world 4:
    the redistributions leave the values as JAX computes them."""
    x = np.random.default_rng(3).normal(size=(8, 16)).astype(np.float32)
    jm, jcm, params = _jax("parallel_ops", HYBRID, 8, "")
    want = np.asarray(jm.forward(x))
    outs = ranks.shared(4, MOD).run("rank_forward", "parallel_ops", HYBRID,
                                    8, "", params, x)
    for o in outs:
        _close(o["y"], want, "parallel ops")


def test_sharded_embedding_matches_jax():
    """The DLRM-style embedding sharded over its entries at world 4: each
    rank holds 1024 / 2 rows of the table, and the lookup's sum equals
    JAX's."""
    ids = np.random.default_rng(5).integers(0, 1024, size=(32, 4)).astype(
        np.int32)
    jm, jcm, params = _jax("embedding", HYBRID, 32, "emb")
    want = np.asarray(jm.forward(ids))
    outs = ranks.shared(4, MOD).run("rank_forward", "embedding", HYBRID, 32,
                                    "emb", params, ids)
    for o in outs:
        assert o["local"]["table.kernel"] == (512, 64)
        _close(o["y"], want, "embedding")


def test_two_process_fit_ranks_agree(tmp_path):
    """tests/test_multihost.py:104 on the port: two ranks over
    {"data": 2} fit, evaluate, forward, round-trip a checkpoint and set a
    weight; both see the same losses (JAX's within 1e-5) and hold the
    same weights bitwise."""
    rng = np.random.default_rng(0)
    xv = rng.normal(size=(64, 16)).astype(np.float32)
    w = rng.normal(size=(16, 4)).astype(np.float32)
    yv = np.argmax(xv @ w, axis=1).astype(np.int32)
    jm, jcm, params = _jax("mlp2", {"data": 2}, 32, "", lr=0.05)
    jhist = jcm.fit(xv, yv, verbose=False, epochs=2)
    outs = ranks.shared(2, MOD).run("rank_multihost", params, xv, yv,
                                    str(tmp_path / "ck"))
    for o in outs:
        np.testing.assert_allclose(o["losses"], [h["loss"] for h in jhist],
                                   rtol=RTOL)
        assert o["losses"][-1] < o["losses"][0]
        assert np.isfinite(o["eval"])
        assert o["out"] == (32, 4) and o["local_rows"] == (16, 4)
        assert o["restored"] and o["head"] == 0.0
    assert outs[0]["losses"] == outs[1]["losses"]
    assert np.array_equal(outs[0]["fc1"], outs[1]["fc1"])
    assert os.path.isdir(tmp_path / "ck")


# ------------------------------------------------ config, refusals, launch
def test_unported_holds_only_the_pipeline_schedule_and_serve_objective():
    """--pipeline-schedule and --serve-objective are ported: the
    mechanism for unported flags is gone and both parse into fields."""
    from flexflow_tpu_torch import config

    assert not hasattr(config, "_UNPORTED")
    c = F.FFConfig.parse_args(["--pipeline-schedule", "gpipe",
                               "--serve-objective", "throughput"])
    assert (c.pipeline_schedule, c.serve_objective) == ("gpipe",
                                                        "throughput")


@pytest.mark.parametrize("argv", [
    [], ["--mesh", "data=2,model=4", "--nodes", "2",
         "--workers-per-node", "4", "--zero-sharding", "zero2"]])
def test_mesh_flags_parse_into_jax_fields(argv):
    from flexflow_tpu import FFConfig as JFFConfig

    jcfg, pcfg = JFFConfig.parse_args(argv), F.FFConfig.parse_args(argv)
    for f in ("mesh_shape", "num_nodes", "workers_per_node",
              "zero_sharding"):
        assert getattr(pcfg, f) == getattr(jcfg, f), f


def test_machine_larger_than_the_world_raises_jax_message():
    """A compile whose machine needs more devices than the world has
    raises JAX's `build_mesh` message; a named mesh without a process
    group says how to start one."""
    from flexflow_tpu.parallel.machine import MachineSpec as JMachineSpec
    from flexflow_tpu.parallel.machine import build_mesh as jbuild_mesh

    with pytest.raises(ValueError) as je:
        jbuild_mesh(JMachineSpec(mesh_axes={"data": 16}))
    m = build_mlp2(F, _cfg(F, {"data": 2}, 32))
    with pytest.raises(ValueError) as pe:
        m.compile(F.SGDOptimizer(), "sparse_categorical_crossentropy", [],
                  device="cpu")
    pat = r"mesh \{'data': \d+\} needs \d+ devices, have \d+"
    assert re.fullmatch(pat, str(je.value)) and re.fullmatch(pat,
                                                             str(pe.value))
    m = build_mlp2(F, _cfg(F, {"data": 1}, 32))
    with pytest.raises(RuntimeError, match="init_distributed"):
        m.compile(F.SGDOptimizer(), "sparse_categorical_crossentropy", [],
                  device="cpu")


_LAUNCHED = """
import numpy as np, torch.distributed as dist
import flexflow_tpu_torch as F
from torch.distributed.tensor import DTensor
cfg = F.get_launch_config()
m = F.FFModel(cfg)
h = m.dense(m.create_tensor([8, 16], name="x"), 4, name="d")
cm = m.compile(F.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", [])
rng = np.random.default_rng(0)
hist = cm.fit(rng.normal(size=(16, 16)).astype(np.float32),
              rng.integers(0, 4, size=(16,)).astype(np.int32), verbose=False)
assert isinstance(cm.params["d"]["kernel"], DTensor)
print("LAUNCHED", dist.get_world_size(), cm.mesh.mesh_dim_names,
      cm._iteration, np.isfinite(hist[-1]["loss"]))
"""


def test_launcher_with_a_mesh_runs_the_distributed_path(tmp_path):
    """`python -m flexflow_tpu_torch --mesh data=1 script.py`, one process
    without torchrun: the launcher starts a world-1 group and the script's
    compile runs over the mesh."""
    script = tmp_path / "train.py"
    script.write_text(_LAUNCHED)
    env = dict(os.environ, FLEXFLOW_PLATFORM="cpu")
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-m", "flexflow_tpu_torch", "-b",
                          "8", "--mesh", "data=1", str(script)],
                         cwd=os.path.dirname(F.__path__[0]), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LAUNCHED 1 ('data',) 2 True" in out.stdout
