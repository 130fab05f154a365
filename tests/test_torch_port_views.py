"""`CompiledModel.parallel_view` / `weight_view` and the package's exports,
against the JAX package, on the CPU.

One model in both packages (an up projection, a fork-join of two
congruent branches on stacked storage, a head) compiles with the same
strategy: JAX's search on {"data": 2, "model": 2}, exported to a file
both import. At world 1 ({"data": 1}) and over a gloo world-4 mesh
({"data": 2, "model": 2}) against JAX's CPU mesh of the same shape, every
layer output's view and every weight's, the stacked alias
"b{i}.{sub}.{w}" included, have JAX's dims (size, degree, axes), shard
shape and replica axes. The exports of `flexflow_tpu/__init__.py` and
`__version__` resolve in the port, `compile_serving` lazily.

The rest of JAX's public surface holds against JAX's on the same inputs
(PerfMetrics' `update`, `pending_updates`, `train_correct` and
`materialize`'s bool, `total_devices`, `has_weights`, `has_op_def`,
`total_degree`, `shard_bytes`, `memo.stats_line`, `predict_step_time`,
`np_dtype`, `native.available`, ...), and a walk over every module of the
JAX package finds each public class, function and class attribute in the
port's module of the same path, but for the names listed in JAX_ONLY
with the reason each exists only because of JAX.
"""

import subprocess
import sys

import pytest

import _torch_port_ranks as ranks

MOD = __name__
MESH = {"data": 2, "model": 2}


@pytest.fixture(scope="module", autouse=True)
def _close_groups():
    yield
    ranks.close_all()


def _model(pkg, **cfg):
    m = pkg.FFModel(pkg.FFConfig(batch_size=8, **cfg))
    x = m.create_tensor([8, 32], name="x")
    h = m.dense(x, 64, activation="relu", name="up")

    def branch(act):
        def build(mm, t):
            return mm.dense(mm.dense(t, 128, activation=act, name="mid"),
                            64, name="out")
        return build
    t = m.fork_join(h, [branch("relu"), branch("gelu")], join="add",
                    name="fj")
    m.dense(t, 8, name="head")
    return m


def _view(pt):
    return {"dims": [(d.size, d.degree, tuple(d.axes)) for d in pt.dims],
            "shard": tuple(pt.shard_shape),
            "replicas": tuple(pt.replica_axes)}


def _views(cm, model):
    out = {}
    for layer in model.layers:
        for i in range(len(layer.outputs)):
            out[f"{layer.name}:out{i}"] = _view(cm.parallel_view(layer.name,
                                                                 i))
        for w in layer.weight_specs:
            out[f"{layer.name}.{w}"] = _view(cm.weight_view(layer.name, w))
    for b in (0, 1):
        for w in ("mid.kernel", "out.bias"):
            out[f"fj.b{b}.{w}"] = _view(cm.weight_view("fj", f"b{b}.{w}"))
    return out


def _port_views(mesh, path):
    import flexflow_tpu_torch as F

    m = _model(F, mesh_shape=dict(mesh), import_strategy_file=path)
    cm = m.compile(F.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy",
                   [], device="cpu")
    return _views(cm, m)


def rank_views(path):
    return _port_views(MESH, path)


@pytest.fixture(scope="module")
def strategy_file(tmp_path_factory):
    import flexflow_tpu as J

    path = str(tmp_path_factory.mktemp("views") / "strategy.json")
    m = _model(J, mesh_shape=dict(MESH), search_budget=8,
               export_strategy_file=path, strategy_cache=False,
               log_level="warning")
    m.compile(J.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy", [])
    return path


def _jax_views(mesh, path):
    import flexflow_tpu as J

    m = _model(J, mesh_shape=dict(mesh), import_strategy_file=path,
               log_level="warning")
    cm = m.compile(J.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy",
                   [])
    return _views(cm, m)


def test_views_match_jax_at_world_1(strategy_file):
    """On one device ({"data": 1}) every view is JAX's: the strategy's
    axes are not on the machine, so every degree is 1."""
    want = _jax_views({"data": 1}, strategy_file)
    assert _port_views({}, strategy_file) == want
    assert all(d[1] == 1 for v in want.values() for d in v["dims"])


def test_views_match_jax_over_a_world_4_mesh(strategy_file):
    """Over {"data": 2, "model": 2} on four gloo ranks: every output's and
    weight's view is JAX's on its CPU mesh, some of them sharded, and the
    stacked alias drops the stacked dim and its sharding."""
    want = _jax_views(MESH, strategy_file)
    assert any(d[1] > 1 for v in want.values() for d in v["dims"])
    for got in ranks.shared(4, MOD).run("rank_views", strategy_file):
        assert got == want
    assert want["fj.b0.mid.kernel"]["dims"] == \
        want["fj.stk.mid.kernel"]["dims"][1:]


def test_exports_resolve_as_in_jax():
    """The names `flexflow_tpu/__init__.py` exports, `__version__` and the
    lazy `compile_serving`, which plain `import flexflow_tpu_torch` does
    not load."""
    import flexflow_tpu as J

    import flexflow_tpu_torch as F
    from flexflow_tpu_torch.core.tensor import Tensor, TensorSpec
    from flexflow_tpu_torch.dtype import DataType
    from flexflow_tpu_torch.ops.op_type import OperatorType
    from flexflow_tpu_torch.serving.engine import compile_serving

    assert set(J.__all__) <= set(F.__all__)
    assert F.__version__ == J.__version__
    assert (F.DataType, F.Tensor, F.TensorSpec, F.OperatorType) == \
        (DataType, Tensor, TensorSpec, OperatorType)
    assert F.compile_serving is compile_serving
    for name in J.__all__:
        assert getattr(F, name) is not None, name
    with pytest.raises(AttributeError):
        F.no_such_name
    code = ("import sys, flexflow_tpu_torch as F; "
            "print(any(k.startswith('flexflow_tpu_torch.serving') "
            "for k in sys.modules)); F.compile_serving; "
            "print(any(k.startswith('flexflow_tpu_torch.serving') "
            "for k in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["False", "True"]


# ------------------------------------------------ the rest of JAX's surface
def _both(fn):
    import flexflow_tpu as J

    import flexflow_tpu_torch as F
    return fn(J), fn(F)


def test_perf_metrics_update_pending_and_train_correct_as_in_jax():
    """`update` adds host values now, `pending_updates` counts the queued
    deferred ones, `materialize` returns whether anything was pending and
    `train_correct` is the accuracy sum, as JAX's."""
    import jax.numpy as jnp
    import torch

    from flexflow_tpu.metrics import PerfMetrics as JPerfMetrics
    from flexflow_tpu_torch.metrics import PerfMetrics

    def run(pm, scalar):
        seen = [pm.materialize()]
        pm.update(4, {"accuracy": 0.75, "loss": 1.5})
        for i in range(3):
            pm.update_deferred(8, {"accuracy": scalar(0.5 + 0.125 * i),
                                   "loss": scalar(1.0 - 0.25 * i)})
        seen += [pm.pending_updates, pm.train_correct, pm.pending_updates,
                 pm.materialize(), pm.train_all, sorted(pm.sums.items())]
        return seen

    want = run(JPerfMetrics(fold_after=2), lambda v: jnp.float32(v))
    got = run(PerfMetrics(fold_after=2), lambda v: torch.tensor(v))
    assert got == want and want[:5] == [False, 1, 18, 0, False]


def test_total_devices_has_weights_and_has_op_def_as_in_jax():
    import flexflow_tpu as J

    import flexflow_tpu_torch as F
    from flexflow_tpu.ops import has_op_def as jhas
    from flexflow_tpu_torch.ops import OperatorType, has_op_def
    from flexflow_tpu_torch.runtime.distributed import world_size

    mesh = {"data": 2, "model": 2}
    assert F.FFConfig(mesh_shape=mesh).total_devices == \
        J.FFConfig(mesh_shape=mesh).total_devices == 4
    # without a mesh: the world's devices, one a rank (JAX: its devices)
    assert F.FFConfig().total_devices == world_size() == 1
    jm, pm = _model(J), _model(F)
    assert [(l.name, l.has_weights) for l in pm.layers] == \
        [(l.name, l.has_weights) for l in jm.layers]
    assert any(l.has_weights for l in pm.layers)
    for jt in type(jm.layers[0].op_type):
        assert has_op_def(OperatorType(jt.value)) == jhas(jt), jt
    for jl, pl in zip(jm.layers, pm.layers):
        assert pl.outputs[0].dims == jl.outputs[0].dims


def test_total_degree_and_shard_bytes_as_in_jax(strategy_file):
    import flexflow_tpu as J

    import flexflow_tpu_torch as F

    def views(pkg, mesh, **kw):
        m = _model(pkg, mesh_shape=mesh, import_strategy_file=strategy_file)
        cm = m.compile(pkg.SGDOptimizer(lr=0.01),
                       "sparse_categorical_crossentropy", [], **kw)
        return [(v.total_degree, v.shard_bytes) for v in
                [cm.parallel_view(l.name) for l in m.layers]
                + [cm.weight_view(l.name, w) for l in m.layers
                   for w in l.weight_specs]]

    want = views(J, {"data": 1})
    assert views(F, {}, device="cpu") == want and len(want) > 8


def test_stats_line_and_predict_step_time_as_in_jax():
    """`memo.stats_line` is JAX's line over the port's tables (JAX's
    function on the same counters); `predict_step_time` prices an MLP as
    JAX's does on the same machine preset."""
    import flexflow_tpu as J

    import flexflow_tpu_torch as F
    from flexflow_tpu.parallel.machine import MachineSpec as JMachineSpec
    from flexflow_tpu.search import memo as jmemo
    from flexflow_tpu.search.optimize import \
        predict_step_time as jpredict_step_time
    from flexflow_tpu_torch.parallel.machine import MachineSpec
    from flexflow_tpu_torch.search import memo
    from flexflow_tpu_torch.search.optimize import predict_step_time

    def mlp(pkg):
        m = pkg.FFModel(pkg.FFConfig(batch_size=64))
        x = m.create_tensor([64, 256], name="x")
        m.dense(m.dense(x, 512, activation="relu", name="fc1"), 10,
                name="head")
        return m

    memo.clear()
    assert memo.stats_line() == "memo: empty"
    got = predict_step_time(mlp(F), MachineSpec(mesh_axes={"data": 4},
                                                chip="cpu-sim"))
    want = jpredict_step_time(mlp(J), JMachineSpec(mesh_axes={"data": 4},
                                                   chip="cpu-sim"))
    assert got == pytest.approx(want, rel=1e-9) and got > 0
    line = memo.stats_line()
    saved = (jmemo._TABLES, jmemo._HITS, jmemo._MISSES, jmemo._ENABLED)
    try:
        jmemo._TABLES, jmemo._HITS, jmemo._MISSES = \
            memo._TABLES, memo._HITS, memo._MISSES
        jmemo._ENABLED = memo._ENABLED
        assert line == jmemo.stats_line() and "hits (" in line
    finally:
        jmemo._TABLES, jmemo._HITS, jmemo._MISSES, jmemo._ENABLED = saved


def test_np_dtype_native_available_and_the_small_names(monkeypatch):
    import numpy as np

    from flexflow_tpu.dtype import DataType as JDataType
    from flexflow_tpu.search.pcg import PCG as JPCG
    from flexflow_tpu_torch import native
    from flexflow_tpu_torch.compiler import compile as pcompile
    from flexflow_tpu_torch.dtype import DataType
    from flexflow_tpu_torch.ops.registry import LoweringCtx
    from flexflow_tpu_torch.search import cost_model
    from flexflow_tpu_torch.search.pcg import PCG
    from flexflow_tpu_torch.serving.kv_cache import KVCacheSpec

    for jd in JDataType:
        d = DataType(jd.value)
        if d is DataType.BF16:  # numpy has no bfloat16: host arrays are f32
            assert d.np_dtype is np.float32
            assert np.dtype(jd.np_dtype).name == "bfloat16"
        else:
            assert d.np_dtype is jd.np_dtype, d
    assert native.available() is True  # this machine has a C++ compiler

    def no_compiler():
        raise RuntimeError("no host C++ compiler")
    monkeypatch.setattr(native, "load", no_compiler)
    assert native.available() is False
    assert cost_model.KVCacheSpec is KVCacheSpec
    ctx = LoweringCtx(rng=3)
    layer = _model(__import__("flexflow_tpu_torch")).layers[0]
    assert ctx.rng_for(layer) == ctx.layer_key(layer)
    import flexflow_tpu as J

    import flexflow_tpu_torch as F
    jcfg, pcfg = J.FFConfig(), F.FFConfig()
    assert (pcfg.log_level, pcfg.allow_tensor_op_math_conversion) == \
        (jcfg.log_level, jcfg.allow_tensor_op_math_conversion)
    with pytest.raises(ValueError, match="unknown log_level"):
        pcompile.apply_log_level(F.FFConfig(log_level="loud"))
    # the PCG's dot text is JAX's, its node ids (guids) aside
    import re

    jm, pm = _model(J), _model(F)
    jp, pp = JPCG.from_model(jm), PCG.from_model(pm)
    jp.pins[jp.layers[0].name] = pp.pins[pp.layers[0].name] = "dp"
    assert re.sub(r"n\d+", "n", pp.to_dot()) == \
        re.sub(r"n\d+", "n", jp.to_dot())
    assert pcompile.compile_serving.__module__ == pcompile.__name__


# JAX's public names with no counterpart in the port, and why
JAX_ONLY = {
    # an optax transformation: the port's optimizers are its own kernels
    "flexflow_tpu.optimizers.Optimizer.to_optax": "optax",
    "flexflow_tpu.optimizers.SGDOptimizer.to_optax": "optax",
    "flexflow_tpu.optimizers.AdamOptimizer.to_optax": "optax",
    # jax.numpy dtypes: the port's are torch_dtype
    "flexflow_tpu.dtype.DataType.jnp_dtype": "jax.numpy",
    # PartitionSpecs: the port's layouts are DTensor placements
    "flexflow_tpu.parallel.sharding.dims_to_pspec": "PartitionSpec",
    "flexflow_tpu.parallel.sharding.OpSharding.output_pspec": "PartitionSpec",
    "flexflow_tpu.parallel.sharding.OpSharding.weight_pspec": "PartitionSpec",
    "flexflow_tpu.parallel.sharding.Strategy.input_pspec": "PartitionSpec",
    # NamedShardings: the port's are input_placements / label_placements
    "flexflow_tpu.compiler.compile.CompiledModel.input_sharding":
        "NamedSharding",
    "flexflow_tpu.compiler.compile.CompiledModel.label_sharding":
        "NamedSharding",
    # XLA's buffer donation: the port updates params in place
    "flexflow_tpu.config.FFConfig.donate_state": "XLA donation",
    # a closure over a JAX PRNG key folding in topo indices (threefry);
    # the port draws from one torch.Generator (initializers.init_params)
    "flexflow_tpu.compiler.compile.build_init_fn": "JAX PRNG",
    # the JAX native core's compiled CPython extension; the port loads
    # its library by ctypes (native/__init__.py)
    "flexflow_tpu.native._native": "CPython extension",
    # a field JAX's compile fills and no lowering reads, in JAX either:
    # the batch matmul reads its layer's own `seq_length` param
    "flexflow_tpu.ops.registry.LoweringCtx.seq_length": "unread",
}


def test_every_public_name_of_jax_has_a_counterpart():
    """Every public class and function a module of the JAX package
    defines, and every public attribute of such a class, exists in the
    port's module of the same path, but for JAX_ONLY."""
    import importlib
    import inspect
    import pkgutil

    import flexflow_tpu

    missing, seen = [], 0
    for mi in pkgutil.walk_packages(flexflow_tpu.__path__, "flexflow_tpu."):
        if mi.name in JAX_ONLY:
            continue
        jm = importlib.import_module(mi.name)
        pm = importlib.import_module(
            "flexflow_tpu_torch" + mi.name[len("flexflow_tpu"):])
        for n, obj in vars(jm).items():
            if n.startswith("_") or not (inspect.isclass(obj)
                                         or inspect.isfunction(obj)):
                continue
            if getattr(obj, "__module__", None) != mi.name:
                continue
            seen += 1
            qual = f"{mi.name}.{n}"
            if qual in JAX_ONLY:
                continue
            if not hasattr(pm, n):
                missing.append(qual)
                continue
            if inspect.isclass(obj):
                missing += [f"{qual}.{a}" for a in vars(obj)
                            if not a.startswith("_")
                            and f"{qual}.{a}" not in JAX_ONLY
                            and not hasattr(getattr(pm, n), a)]
    assert missing == [] and seen > 300, (seen, missing)
