"""The port faults that ROADMAP Queue 3 listed, each against the JAX
package on the CPU:

1. `FFConfig.parse_args` knows every option string of the JAX parser,
   with the same choices; `--lr` reaches `learning_rate` and the
   compile's default optimizer, as in JAX; `--serve-objective`, the
   last flag that raised, parses as JAX's; a flag neither package knows
   is ignored.
2. The unfused sparse cross-entropy takes an out-of-range label as JAX
   does (lse minus the label's logit by `take_along_axis`'s rules: a
   negative label counts from the end, one outside [-v, v) reads NaN),
   with and without `from_logits`.
3. `CompiledModel.profile_report()` prints one line per failed async
   checkpoint write, JAX's line (`report_failed_writes`).
4. `FFModel.compile(..., comp_mode=, outputs=)`: the outputs given are
   the model's, the first of them the one the loss reads, and the forward
   and the SGD losses from them equal JAX's (f32, 1e-5 relative).
5. `FFModel.fit(..., steps_per_dispatch=K)` reaches `CompiledModel.fit`:
   K updates a dispatch, the `step_stats` and losses JAX's give.

`--serve` is a plain field, as in JAX, and no longer an unported flag;
so is `--pipeline-schedule`, with JAX's default "1f1b".

6. The ring rounds once: in bf16 at P = 4 the port's ring (its per-step
   functions for 4 ranks, `ring_lockstep_fwd`/`_bwd`, the chunk steps the
   per-rank ring runs) equals JAX's `ring_attention` on a CPU mesh of 4
   devices within one rounding, 2**-8 of the largest value, for out, dQ,
   dK and dV; and the collective matmul's backward takes its partial
   products in f32.
7. MeasuredCost times the routes the compiled program runs: the
   compile's `enable_fusion` reaches it (attribution, the profile
   report, the measured search), and its store keeps the two apart.
8. `allow_tensor_op_math_conversion=False` is the model's own: TF32 is
   off while its steps and forward run, as JAX sets its precision per
   program, and the process's settings are as they were outside them
   (a later model compiled with True runs under those).
"""

import ast
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.losses import compute_loss as jcompute_loss
import flexflow_tpu_torch
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.losses import compute_loss

PKG = pathlib.Path(flexflow_tpu_torch.__file__).parent


def _options(parser):
    return {o: tuple(a.choices) if a.choices else None
            for a in parser._actions for o in a.option_strings}


def test_parser_knows_every_jax_option_with_its_choices():
    jopts, popts = _options(JFFConfig.build_parser()), _options(
        FFConfig.build_parser())
    assert set(jopts) <= set(popts)
    assert {o: popts[o] for o in jopts} == jopts


def test_lr_reaches_the_default_optimizer_as_in_jax():
    argv = ["--lr", "0.5", "--wd", "0.001", "--iterations", "7"]
    jcfg, pcfg = JFFConfig.parse_args(argv), FFConfig.parse_args(argv)
    for f in ("learning_rate", "weight_decay", "iterations"):
        assert getattr(pcfg, f) == getattr(jcfg, f)
    assert pcfg.learning_rate == 0.5

    def compiled(model_cls, cfg, **kw):
        m = model_cls(cfg)
        m.dense(m.create_tensor([4, 3], name="x"), 2, name="d")
        return m.compile(None, "mean_squared_error", [], **kw)
    jcfg.mesh_shape, jcfg.log_level = {"data": 1}, "warning"
    jopt = compiled(JFFModel, jcfg).optimizer
    popt = compiled(FFModel, pcfg, device="cpu").optimizer
    assert type(popt).__name__ == type(jopt).__name__ == "SGDOptimizer"
    assert popt.lr == jopt.lr == 0.5


@pytest.mark.parametrize("argv,item", [
    (["--serve-objective", "latency"], 9),
    (["--serve-objective", "throughput"], 9)])
def test_unported_flags_raise_naming_their_item(argv, item):
    """The last flag that raised (`--serve-objective`, item 9) is ported:
    it parses into JAX's field and value, and nothing raises."""
    jcfg, pcfg = JFFConfig.parse_args(argv), FFConfig.parse_args(argv)
    assert pcfg.serve_objective == jcfg.serve_objective == argv[1]
    assert FFConfig().serve_objective == JFFConfig().serve_objective \
        == "latency"


@pytest.mark.parametrize("argv", [
    [], ["--telemetry-dir", "t", "--telemetry-max-mb", "3",
         "--no-health-sentinels", "--halt-on-nonfinite", "--profiling",
         "--profile-dir", "p", "--profile-ops"]])
def test_item4_flags_parse_into_jax_fields(argv):
    """The telemetry, sentinel and attribution flags parse into the JAX
    package's fields, with its defaults."""
    jcfg, pcfg = JFFConfig.parse_args(argv), FFConfig.parse_args(argv)
    for f in ("telemetry_dir", "telemetry_max_mb", "health_sentinels",
              "halt_on_nonfinite", "profiling", "profile_dir",
              "profile_ops"):
        assert getattr(pcfg, f) == getattr(jcfg, f), f


@pytest.mark.parametrize("argv", [
    [], ["--serve-watch-dir", "snaps", "--no-serve-reqtrace",
         "--kv-host-pages", "24", "--kv-prefetch-ahead", "3",
         "--serve-trace-out", "t.jsonl"], ["--serve-reqtrace"]])
def test_item5_serving_flags_parse_into_jax_fields(argv):
    """The tiered cache's, hot-swap's and tracing's flags parse into the
    JAX package's fields, with its defaults (tracing on)."""
    jcfg, pcfg = JFFConfig.parse_args(argv), FFConfig.parse_args(argv)
    for f in ("serve_watch_dir", "serve_reqtrace", "kv_host_pages",
              "kv_prefetch_ahead", "serve_trace_out"):
        assert getattr(pcfg, f) == getattr(jcfg, f), f
        assert getattr(FFConfig(), f) == getattr(JFFConfig(), f), f


def test_choices_exit_as_in_jax_and_unknown_flags_are_ignored():
    for parse in (JFFConfig.parse_args, FFConfig.parse_args):
        with pytest.raises(SystemExit) as e:
            parse(["--zero-sharding", "1"])
        assert e.value.code == 2
    assert FFConfig.parse_args(["--no-such-flag", "3", "-b", "4"]).batch_size \
        == JFFConfig.parse_args(["--no-such-flag", "3", "-b", "4"]).batch_size \
        == 4


@pytest.mark.parametrize("from_logits", [True, False])
@pytest.mark.parametrize("bad", [-100, -1, 12, 5])
def test_sparse_ce_out_of_range_labels_match_jax(bad, from_logits):
    """ROADMAP's probe: (4, 10) logits, labels [1, 2, 3, x]: JAX's loss,
    NaN included (f32, 1e-6 relative where finite)."""
    x = np.random.default_rng(0).standard_normal((4, 10)).astype(np.float32)
    if not from_logits:
        x = np.abs(x) / np.abs(x).sum(-1, keepdims=True)
    y = np.array([1, 2, 3, bad], np.int32)
    want = float(jcompute_loss("sparse_categorical_crossentropy",
                               jnp.asarray(x), jnp.asarray(y),
                               from_logits=from_logits))
    got = float(compute_loss("sparse_categorical_crossentropy",
                             torch.from_numpy(x), torch.from_numpy(y),
                             from_logits=from_logits))
    if np.isnan(want):
        assert np.isnan(got)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isnan(want) == (bad in (-100, 12))


# the features an unported-path error names, each looked up in the text of
# the ROADMAP Queue 1 item the error names
FEATURES = ("multi-GPU", "pipeline", "MCMC", "taskgraph", "learned",
            "serving_optimize", "MoE", "fork-join", "compiler/passes")


def _queue1_items():
    """{n: text of ROADMAP Queue 1 item n}, each without its sentences
    that point at another item ("... (item 9)")."""
    text = (PKG.parent / "ROADMAP.md").read_text()
    q1 = text[text.index("### Queue 1"):text.index("### Queue 2")]
    items = {}
    for m in re.finditer(r"^(\d+)\. (.*?)(?=^\d+\. |\Z)", q1, re.S | re.M):
        own = [sent for sent in re.split(r"(?<=[.;])\s+", m.group(2))
               if not re.search(r"item \d", sent)]
        items[int(m.group(1))] = " ".join(own).lower()
    return items


def _unported_raises():
    """(file:line, message) of every NotImplementedError in the port whose
    message names a ROADMAP item."""
    out = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Raise)
                    and isinstance(node.exc, ast.Call)
                    and getattr(node.exc.func, "id", "")
                    == "NotImplementedError"):
                continue
            msg = "".join(c.value for c in ast.walk(node.exc)
                          if isinstance(c, ast.Constant)
                          and isinstance(c.value, str))
            if re.search(r"item \d", msg):
                out.append((f"{path.relative_to(PKG)}:{node.lineno}", msg))
    return out


def test_unported_errors_name_the_roadmap_item_of_their_feature():
    """Every NotImplementedError that names a ROADMAP Queue 1 item names
    the item whose text lists its feature; since the fleet and the
    handoff over a mesh run (the last of item 9), none is left."""
    items = _queue1_items()
    raises = _unported_raises()
    # items 8 and 9 are ported whole: no path of the port is left unported
    assert raises == []
    for where, msg in raises:
        n = int(re.search(r"item (\d+)", msg).group(1))
        assert n != 8, f"{where}: item 8 is ported, yet {msg!r}"
        feats = [f for f in FEATURES if f.lower() in msg.lower()]
        assert feats, f"{where}: no known feature in {msg!r}"
        for f in feats:
            assert f.lower() in items[n], \
                f"{where} names item {n} for {f!r}, which that item lacks"


def test_serve_flag_is_a_plain_field_as_in_jax():
    for argv in ([], ["--serve"]):
        assert FFConfig.parse_args(argv).serve \
            == JFFConfig.parse_args(argv).serve == bool(argv)
    assert FFConfig().serve is JFFConfig().serve is False


def _mlp(model_cls, cfg_cls, **cfg):
    """x (8, 6) -> mid (8, 4) -> last (8, 3), both dense, named."""
    m = model_cls(cfg_cls(batch_size=8, **cfg))
    x = m.create_tensor([8, 6], name="x")
    mid = m.dense(x, 4, activation="relu", name="mid")
    m.dense(mid, 3, name="last")
    return m, mid


def test_profile_report_prints_each_failed_write(capsys):
    from flexflow_tpu.runtime import checkpoint as jckpt
    from flexflow_tpu_torch.runtime import checkpoint as pckpt

    m, _ = _mlp(FFModel, FFConfig)
    cm = m.compile(None, "sparse_categorical_crossentropy", [], device="cpu")
    cm.init(seed=0)
    fails = [{"path": "/ckpt/a", "error": "OSError('disk full')"},
             {"path": "/ckpt/b", "error": "RuntimeError('x')"}]
    with pckpt._PENDING_LOCK:
        pckpt._FAILED.extend(fails)
    with jckpt._PENDING_LOCK:
        jckpt._FAILED.extend(fails)
    try:
        want = jckpt.report_failed_writes()
        assert pckpt.report_failed_writes() == want and len(want) == 2
        rows = cm.profile_report()
        out = capsys.readouterr().out.splitlines()
    finally:
        with pckpt._PENDING_LOCK:
            del pckpt._FAILED[-2:]
        with jckpt._PENDING_LOCK:
            del jckpt._FAILED[-2:]
    assert out[-2:] == want
    assert {r["layer"] for r in rows} == {"mid", "last"}


def _train_pair(outputs_of, steps=3, **fit_kw):
    """The MLP in both packages, compiled under SGD(0.1) with `outputs`
    picked by `outputs_of(mid)`, the port given JAX's initial weights;
    then `fit` over 4 batches for `steps` epochs in each."""
    from flexflow_tpu import SGDOptimizer as JSGD
    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch.convert import params_from_jax
    import jax

    jm, jmid = _mlp(JFFModel, JFFConfig, mesh_shape={"data": 1},
                    log_level="warning")
    pm, pmid = _mlp(FFModel, FFConfig)
    jcm = jm.compile(JSGD(lr=0.1), "sparse_categorical_crossentropy", [],
                     comp_mode="training", outputs=outputs_of(jmid))
    pcm = pm.compile(SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
                     [], comp_mode="training", outputs=outputs_of(pmid),
                     device="cpu")
    jcm.init(seed=0)
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    y = rng.integers(0, 3, size=(32,)).astype(np.int32)
    fwd = (np.asarray(jcm.forward(x[:8])), pcm.forward(x[:8]).numpy())
    jh = jm.fit(x, y, epochs=steps, verbose=False, sync_every=0, **fit_kw)
    ph = pm.fit(x, y, epochs=steps, verbose=False, sync_every=0, **fit_kw)
    return (jcm, pcm), fwd, ([h["loss"] for h in jh], [h["loss"] for h in ph])


def test_compile_outputs_are_the_models_outputs_as_in_jax():
    """outputs=[mid]: the forward returns mid's (8, 4) and the loss reads
    it (4 classes of logits; labels < 3), as in JAX; the default is the
    last layer's (8, 3)."""
    (jcm, pcm), (jf, pf), (jl, pl) = _train_pair(lambda mid: [mid])
    assert pf.shape == jf.shape == (8, 4)
    assert [t.owner.name for t in pcm.outputs] == ["mid"]
    np.testing.assert_allclose(pf, jf, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    (_, pcm), (jf, pf), _ = _train_pair(lambda mid: None, steps=1)
    assert pf.shape == jf.shape == (8, 3)
    assert [t.owner.name for t in pcm.outputs] == ["last"]


def test_fit_passes_steps_per_dispatch_through_as_in_jax():
    """FFModel.fit(steps_per_dispatch=2): 4 batches an epoch make 2
    dispatches of 2 updates (4 over the 2 epochs), the step_stats and
    losses JAX's give."""
    (jcm, pcm), _, (jl, pl) = _train_pair(lambda mid: None, steps=2,
                                          steps_per_dispatch=2)
    assert pcm.step_stats == jcm.step_stats
    assert pcm.step_stats["dispatches"] == 4
    np.testing.assert_allclose(pl, jl, rtol=1e-5)


_MESH_STRATEGIES = r'''
import socket, sys
import numpy as np
import flexflow_tpu_torch as F
from flexflow_tpu_torch.parallel import templates as T
from flexflow_tpu_torch.runtime.distributed import init_distributed

with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
init_distributed(f"localhost:{port}", 1, 0, backend="gloo")
rng = np.random.default_rng(0)


def run(mesh, build, place, unguarded=None):
    m = F.FFModel(F.FFConfig(batch_size=8, mesh_shape=mesh,
                             only_data_parallel=True))
    x = build(m)
    cm = m.compile(F.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
                   [], device="cpu")
    place(cm, m)
    cm._build_steps()
    cm.init(seed=0)
    if unguarded is not None:
        # past the compile's guard: the lowering raises, it does not fall
        # back to the layer's usual path
        unguarded(cm)
    xs = rng.normal(size=(8,) + tuple(x.shape[1:])).astype(np.float32)
    ys = rng.integers(0, 4, size=(8,) + tuple(m.layers[-1].outputs[0]
                                           .spec.shape[1:-1])).astype(np.int32)
    return float(cm.fit(xs, ys, epochs=1, verbose=False)[0]["loss"])


def attn(m):
    x = m.create_tensor([8, 16, 32], name="x")
    m.dense(m.multihead_attention(x, x, x, 32, 2, causal=True, name="mha"),
            4, name="head")
    return x


def sp(cm, m):
    cm.strategy.op_shardings["mha"].attrs["seq_parallel"] = (
        "model" if sys.argv[1] == "unguarded" else sys.argv[1])


def sp_nope(cm):
    cm.strategy.op_shardings["mha"].attrs["seq_parallel"] = "nope"


def ep_nope(cm):
    gb = next(l.name for l in cm.model.layers
              if l.op_type.value == "group_by")
    sh = cm.strategy.op_shardings[gb]
    sh.outputs[0] = ["nope"] + list(sh.outputs[0][1:])


def moe(m):
    x = m.create_tensor([8, 16], name="x")
    m.dense(m.moe(x, num_exp=4, num_select=2, expert_hidden_size=16,
                  name="moe"), 4, name="head")
    return x


def ep(cm, m):
    T.apply_expert_parallel(cm.strategy, [l for l in m.layers if
                                          l.op_type.value in
                                          ("group_by", "experts")], "expert")


def fj(m):
    x = m.create_tensor([8, 16], name="x")
    br = lambda mm, t: mm.dense(t, 16, activation="relu", name="mid")
    m.dense(m.fork_join(x, [br], name="fj"), 4, name="head")
    return x


def inter(cm, m):
    T.apply_branch_placement(cm.strategy, m.get_layer_by_name("fj"), "model")


def inter_nope(cm):
    cm.strategy.op_shardings["fj"].attrs["placement"] = "nope"


if sys.argv[1] == "unguarded":
    for case in ((attn, sp, sp_nope), (moe, ep, ep_nope),
                 (fj, inter, inter_nope)):
        try:
            run({"model": 1} if case[0] is not moe else {"expert": 1}, *case)
            print("RAN", case[2].__name__)
        except ValueError as e:
            print("RAISED", case[2].__name__, e)
    sys.exit(0)
print("LOSSES", run({"model": 1}, attn, sp), run({"expert": 1}, moe, ep),
      run({"model": 1}, fj, inter))
'''


@pytest.mark.parametrize("axis", ["model", "nope", "unguarded"])
def test_seq_parallel_ep_and_inter_compile_over_a_mesh(tmp_path, axis):
    """A strategy with `seq_parallel`, `ep:` or `inter:` compiles and
    trains over a mesh (a world-1 gloo group, one process) instead of
    raising NotImplementedError; an attention ring over an axis the mesh
    lacks raises ValueError naming that guard. Past the guard (the axis
    changed after the compile) each lowering raises ValueError naming
    the missing axis instead of taking its usual path."""
    import os
    import subprocess
    import sys

    script = tmp_path / "mesh_strategies.py"
    script.write_text(_MESH_STRATEGIES)
    env = dict(os.environ, FLEXFLOW_PLATFORM="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(PKG.parent), os.environ.get("PYTHONPATH", "")]))
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, str(script), axis],
                         cwd=str(PKG.parent), env=env, capture_output=True,
                         text=True, timeout=120)
    if axis == "unguarded":
        assert out.returncode == 0, out.stderr[-3000:]
        said = [l for l in out.stdout.splitlines() if l.startswith(("RAN",
                                                                     "RAISED"))]
        assert [l.split()[:2] for l in said] == [
            ["RAISED", n] for n in ("sp_nope", "ep_nope", "inter_nope")], \
            out.stdout[-3000:]
        assert all("mesh has no axis 'nope'" in l for l in said), said
        return
    if axis == "nope":
        assert out.returncode != 0
        assert "sequence-parallel attention over 'nope': the mesh has no " \
               "such axis" in out.stderr, out.stderr[-2000:]
        return
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("LOSSES")]
    assert line and all(np.isfinite(float(v)) for v in line[0].split()[1:])


@pytest.mark.parametrize("argv", [[], ["--pipeline-schedule", "gpipe"],
                                  ["--pipeline-schedule", "1f1b"]])
def test_pipeline_schedule_is_a_plain_field_as_in_jax(argv):
    assert FFConfig.parse_args(argv).pipeline_schedule \
        == JFFConfig.parse_args(argv).pipeline_schedule
    assert FFConfig().pipeline_schedule == JFFConfig().pipeline_schedule \
        == "1f1b"


# ------------------------------------------- 6. the ring rounds once
RING_SHAPE = (1, 2, 256, 64)  # b, h, s, d: 64 rows a rank at P = 4
ONE_ROUNDING = 2.0 ** -8


def _ring_inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=RING_SHAPE).astype(np.float32) for _ in range(4)]


def _jax_ring_bf16(arrs, p, causal):
    """JAX's ring over a "model" axis of p CPU devices in bf16: (out, dq,
    dk, dv) as f32 arrays."""
    import jax

    from flexflow_tpu.kernels.ring_attention import ring_attention
    from flexflow_tpu.parallel.machine import MachineSpec, build_mesh

    mesh = build_mesh(MachineSpec(mesh_axes={"model": p}))

    @jax.jit
    def run(q, k, v, do):
        out, pull = jax.vjp(lambda *a: ring_attention(
            *a, mesh, "model", causal=causal), q, k, v)
        return (out, *pull(do))

    return [np.asarray(t.astype(jnp.float32))
            for t in run(*(jnp.asarray(a, jnp.bfloat16) for a in arrs))]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_bf16_rounds_once_as_jax(devices, causal):
    from flexflow_tpu_torch.kernels import ring_attention as R

    p = 4
    arrs = _ring_inputs(20)
    want = _jax_ring_bf16(arrs, p, causal)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    qs, ks, vs, dos = (t.chunk(p, dim=2) for t in (q, k, v, do))
    scale = 1.0 / RING_SHAPE[-1] ** 0.5
    outs, lses = R.ring_lockstep_fwd(qs, ks, vs, causal, scale)
    dq, dk, dv = R.ring_lockstep_bwd(qs, ks, vs, outs, lses, dos, causal,
                                     scale)
    got = [torch.cat(t, 2) for t in (outs, dq, dk, dv)]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= ONE_ROUNDING, f"{name}: {err:.3e} > one rounding"
    # the plain version of the whole ring rounds the same way
    o2, l2 = R.ring_plain_fwd(q, k, v, p, causal, scale)
    g2 = R.ring_plain_bwd(q, k, v, o2, l2, do, p, causal, scale)
    for name, g, w in zip(("out", "dq", "dk", "dv"), (o2, *g2), want):
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= ONE_ROUNDING, f"plain {name}: {err:.3e}"


def test_collective_matmul_backward_products_in_f32():
    from flexflow_tpu_torch.kernels import collective_matmul as C

    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        torch.bfloat16) for s in ((16, 32), (32, 8)))
    got = C._mm_f32(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, a.float() @ b.float())


# ------------------------------------ more faults found against JAX
# 7. `set_weight` of one fork-join branch over a mesh (it raised): each
#    rank writes its block of the stacked weight, nothing is gathered.
# 8. A pipelined model's `op_attribution` and `profile_report` report every
#    stage (they reported the rank's own); a pipelined fit takes
#    `checkpoint_every_secs` (it raised), rank 0's clock deciding for every
#    rank; a SIGTERM on one rank drains every rank, pipelined and on the
#    flat mesh fit alike (it drained the signalled rank alone).
# 9. `compile_serving` with `search_budget > 0` on one device serves as
#    with 0 (it raised): JAX searches only on a machine of several devices.
import _torch_port_ranks as ranks  # noqa: E402

RANKS_MOD = "_torch_port_repair_ranks"


@pytest.fixture(scope="module", autouse=True)
def _close_rank_groups():
    yield
    ranks.close_all()


def test_set_weight_of_a_placed_branch_over_a_mesh_matches_jax():
    """Over {"model": 2}, each rank holding one branch's block of the
    stacked weights: `set_weight("fj", "b1.mid.kernel", v)` writes rank
    1's block alone and `get_weight` of both branches equals JAX's after
    the same write, bitwise in f32."""
    import jax

    import _torch_port_repair_ranks as R
    from flexflow_tpu import SGDOptimizer as JSGDOptimizer
    from flexflow_tpu_torch.convert import params_from_jax

    jm = R.fat_fork_join(__import__("flexflow_tpu"),
                         JFFConfig(batch_size=32, mesh_shape={"data": 1},
                                   only_data_parallel=True,
                                   log_level="warning"))
    jcm = jm.compile(JSGDOptimizer(lr=0.01), "mean_squared_error", [])
    jcm.init(seed=0)
    params = params_from_jax(jax.device_get(jcm.params))
    value = np.random.default_rng(5).normal(size=(16, 64)).astype(np.float32)
    jcm.set_weight("fj", "b1.mid.kernel", value)
    want = {b: np.asarray(jcm.get_weight("fj", f"{b}.mid.kernel"))
            for b in ("b0", "b1")}
    outs = ranks.shared(2, RANKS_MOD).run("rank_set_branch", params, value)
    for r, o in enumerate(outs):
        assert np.array_equal(o["b1"], want["b1"])
        assert np.array_equal(o["b0"], want["b0"])
        assert o["local"] == (1, 16, 64)
        assert o["local_changed"] == (r == 1)


def test_pipelined_reports_carry_every_stage_as_jax():
    """At world 2 (a stage a rank) `op_attribution` and `profile_report`
    return every stage's rows, tagged with their stage, on both ranks:
    the (stage, layer, op, candidate) rows of JAX's PipelinedModel on
    {"data": 2}; the attributed times sum to the update's time."""
    import flexflow_tpu as J

    jm = J.FFModel(JFFConfig(batch_size=8, only_data_parallel=True, seed=3,
                             pipeline_stages=2, accum_steps=2,
                             mesh_shape={"data": 2}, log_level="warning"))
    t = jm.create_tensor([8, 64], name="x")
    h = jm.dense(t, 256, activation="gelu", name="up")
    h = jm.dense(h, 64, name="down")
    h = jm.dense(h, 128, activation="relu", name="mid")
    jm.dense(h, 8, name="head")
    jcm = jm.compile(J.AdamOptimizer(alpha=0.01),
                     "sparse_categorical_crossentropy", [])
    jcm.init(seed=0)
    import _torch_port_repair_ranks as R
    jcm.fit(*R._mlp_data(), epochs=1, verbose=False)
    jatt = jcm.op_attribution(source="measure", print_table=False)
    jprof = jcm.profile_report(print_table=False)
    want_att = sorted((r["stage"], r["layer"], r["op"], r["candidate"])
                      for r in jatt["rows"])
    want_prof = sorted((r["stage"], r["layer"], r["op"], r["candidate"])
                       for r in jprof)
    outs = ranks.shared(2, RANKS_MOD).run("rank_pipeline_reports")
    assert [o["stage"] for o in outs] == [0, 1]
    for o in outs:
        assert o["attribution"] == want_att
        assert {s for s, *_ in o["attribution"]} == {0, 1}
        assert sorted(o["profile"]) == want_prof
        assert [s for s, *_ in o["profile"]] == sorted(
            s for s, *_ in o["profile"])
        assert o["attributed_total"] == pytest.approx(o["step_time"])
    assert outs[0]["attribution"] == outs[1]["attribution"]


@pytest.mark.parametrize("flat", [False, True])
def test_time_triggered_snapshots_fire_on_the_same_update(tmp_path, flat):
    """`checkpoint_every_secs=1` with rank 0's clock 1000x fast and rank
    1's real: both ranks snapshot the same updates (rank 0's clock
    decides), periodic ones among them, and the newest snapshots commit;
    the pipelined fit takes the time trigger at all."""
    root = str(tmp_path / "root")
    a, b = ranks.shared(2, RANKS_MOD).run("rank_time_trigger", root, flat)
    assert a["saved"] == b["saved"]
    assert len(a["saved"]) >= 2 and a["saved"][0] < a["iteration"]
    assert a["losses"] == b["losses"]
    # the root keeps the newest `keep_checkpoints` (3) snapshots
    assert a["snapshots"] == b["snapshots"] == sorted(set(a["saved"]))[-3:]


@pytest.mark.parametrize("flat", [False, True])
def test_sigterm_on_one_rank_drains_every_rank(tmp_path, flat):
    """SIGTERM to rank 1 alone after its second update: both ranks drain
    at the same update with a committed snapshot and exit cleanly
    (`Preempted`, code 0), pipelined and on the flat mesh fit."""
    root = str(tmp_path / "root")
    a, b = ranks.shared(2, RANKS_MOD).run("rank_sigterm_one_rank", root,
                                          flat, timeout=60)
    assert a["ended"] == b["ended"] == "preempted code 0"
    assert a["iteration"] == b["iteration"] == 2
    assert a["snapshots"] == b["snapshots"] == [2]


def test_compile_serving_search_budget_on_one_device_serves_as_zero():
    """One device searches nothing (JAX `engine.py:187-189`): with
    `search_budget=16` both programs take the data-parallel strategy and
    serve the tokens `search_budget=0` serves."""
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2
    from flexflow_tpu_torch.search import dp
    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            Request, compile_serving,
                                            gpt2_prompt_inputs,
                                            gpt2_step_inputs)

    streams = {}
    for budget in (0, 16):
        m = FFModel(FFConfig(search_budget=budget, max_batch_slots=4,
                             kv_page_size=4, max_decode_len=6))
        build_gpt2(m, GPT2Config(vocab=256, seq=16, d_model=64, heads=4,
                                 layers=1, dropout=0.1), batch=8)
        e0 = dp.SEARCH_STATS.get("expansions", 0)
        eng = compile_serving(m, device="cpu")
        assert dp.SEARCH_STATS.get("expansions", 0) == e0
        assert eng.prefill_strategy.name == eng.decode_strategy.name \
            == "data_parallel"
        eng.init(seed=0)
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=[int(t) for t in
                                       rng.integers(1, 256, size=3)],
                        max_new_tokens=4) for i in range(6)]
        sched = ContinuousBatchingScheduler(eng, eng.params,
                                            gpt2_prompt_inputs,
                                            gpt2_step_inputs)
        streams[budget] = {r.rid: r.tokens for r in sched.run(reqs)}
    assert streams[16] == streams[0] and len(streams[0]) == 6


def test_class_sharded_loss_takes_no_functional_all_gather():
    """Over {"data": 1, "model": 2} the H100 preset's search splits the
    quickstart MLP's head over its classes. The trainer makes the logits'
    class dim whole by c10d for the loss (the gradient sliced back) and
    reads them back by c10d for the metrics: DTensor's functional
    all-gather, which gloo on the card's torch crashes on CUDA tensors,
    never runs, and the losses are the one-device fit's (1e-6 relative:
    the rows' sums taken in another grouping)."""
    from _torch_port_repair_ranks import quickstart_mlp

    rng = np.random.default_rng(0)
    xs = rng.normal(size=(256, 64)).astype(np.float32)
    ys = xs[:, :10].argmax(1).astype(np.int32)
    want = [h["loss"] for h in quickstart_mlp(FFConfig(
        batch_size=64)).fit(xs, ys, epochs=2, verbose=False)]
    outs = ranks.shared(2, RANKS_MOD).run("rank_class_sharded_fit", xs, ys)
    for o in outs:
        assert o == outs[0]
        assert o["head"][1] in ("model", ["model"]) and o["gathers"] == 0
        np.testing.assert_allclose(o["losses"], want, rtol=1e-6)
        assert o["losses"][-1] < o["losses"][0]


def test_measured_costs_follow_the_compiles_fusion(monkeypatch, tmp_path):
    """MeasuredCost times the routes the compiled program runs: with
    `enable_fusion=False` (`--no-fusion`) the attribution's, the profile
    report's and the measured search's op timings take the attention's
    einsum path, as the train step does. (On the card the flash wrapper
    raises on a shape it does not cover, such as the GPT-2 twin's head
    dim 16: the measurement raised where the fit ran.) Its store keeps
    the two apart."""
    from flexflow_tpu_torch import SGDOptimizer
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2
    from flexflow_tpu_torch.ops import attention_ops
    from flexflow_tpu_torch.parallel.machine import MachineSpec
    from flexflow_tpu_torch.search.candidates import layer_candidates
    from flexflow_tpu_torch.search.measure import MeasuredCost

    def flash(*a, **k):
        raise AssertionError("the flash wrapper ran")
    monkeypatch.setattr(attention_ops, "flash_attention_qkv", flash)
    m = FFModel(FFConfig(batch_size=8, enable_fusion=False))
    build_gpt2(m, GPT2Config(vocab=64, seq=16, d_model=64, heads=4,
                             layers=1, dropout=0.0), batch=8)
    cm = m.compile(SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy",
                   [], device="cpu")
    cm.init(seed=0)
    rep = cm.op_attribution(step_time_s=1e-3, source="measure",
                            print_table=False)
    assert any(r["op"] == "multihead_attention" for r in rep["rows"])
    assert cm.profile_report(print_table=False)
    attn = [l for l in m.layers if l.op_type.value == "multihead_attention"]
    machine = MachineSpec(mesh_axes={"data": 1}, chip="cpu-sim")
    cand = layer_candidates(attn[0], machine, {8})[0]
    plain = MeasuredCost(machine, repeats=1, warmup=0, windows=1,
                         device="cpu", compute_dtype="float32",
                         enable_fusion=False, cache_dir=str(tmp_path))
    assert plain.op_time(attn[0], cand) > 0
    assert plain.cache_path.endswith("-float32-nofusion.json")
    fused = MeasuredCost(machine, repeats=1, warmup=0, windows=1,
                         device="cpu", compute_dtype="float32",
                         cache_dir=str(tmp_path))
    assert fused.cache_path.endswith("-float32.json")
    with pytest.raises(AssertionError, match="flash wrapper ran"):
        fused.op_time(attn[0], cand)


def test_tf32_off_only_inside_the_strict_models_programs(monkeypatch):
    from flexflow_tpu_torch import SGDOptimizer

    cuda_mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    monkeypatch.setattr(cuda_mm, "allow_tf32", True)
    monkeypatch.setattr(cudnn, "allow_tf32", True)

    def flags():
        return cuda_mm.allow_tf32, cudnn.allow_tf32

    seen = {}

    def build(allow):
        m = FFModel(FFConfig(batch_size=8,
                             allow_tensor_op_math_conversion=allow))
        x = m.create_tensor([8, 16], name="x")
        m.dense(m.dense(x, 32, activation="relu"), 4)
        cm = m.compile(SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
                       [], device="cpu")
        cm.init(seed=0)
        fwd = cm.forward_fn

        def watched(*a, **k):
            seen.setdefault(allow, set()).add(flags())
            return fwd(*a, **k)
        cm.forward_fn = watched
        return cm

    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 16)).astype(np.float32)
    y = rng.integers(0, 4, size=(16,)).astype(np.int32)
    strict = build(False)
    assert flags() == (True, True)
    strict.fit(x, y, epochs=1, verbose=False)
    strict.evaluate(x, y)
    strict.forward(x[:8])
    assert flags() == (True, True)
    build(True).fit(x, y, epochs=1, verbose=False)
    assert seen == {False: {(False, False)}, True: {(True, True)}}
