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
