"""The port's native host core (flexflow_tpu_torch/native) against the
JAX package's (tests/test_native.py) and the Python reference paths, on
the CPU.

`batch_gather` must equal numpy's fancy index bitwise (and the JAX
package's native gather), the native topological order the Python walk's
and the JAX package's order by layer name. The library is built into
build/flexflow_tpu_torch/, and a failed build raises with the compiler's
output. The loader and `core.graph.topo_order` keep the Python paths (the
native ones measured slower on the card's host), so a fit calls nothing
native.
"""

import numpy as np
import pytest

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import native as jnative
from flexflow_tpu.core.graph import topo_order as jtopo_order
from flexflow_tpu.runtime.dataloader import SingleDataLoader as JLoader
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer, native
from flexflow_tpu_torch.core import graph
from flexflow_tpu_torch.kernels._build import BUILD_DIR
from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader


def test_builds_into_the_build_dir():
    native.load()
    path = native.library_path()
    assert path.exists() and path.parent == BUILD_DIR
    assert path.name.startswith("libff_native_")


def test_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    bad = tmp_path / "native.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)native core failed.*error"):
        native.load()


@pytest.mark.parametrize("shape,dtype", [
    ((100, 17), np.float32), ((64, 3, 8, 8), np.float32), ((50,), np.int32),
    ((32, 5), np.int64), ((40, 6), np.float16), ((30, 4), np.uint8)])
def test_batch_gather_equals_numpy_and_jax(shape, dtype):
    rng = np.random.default_rng(0)
    arr = (rng.normal(size=shape) * 100).astype(dtype)
    idx = rng.integers(0, shape[0], size=37)
    n0 = native.gathers
    got = native.batch_gather(arr, idx)
    assert native.gathers == n0 + 1
    assert got.dtype == arr.dtype and got.tobytes() == arr[idx].tobytes()
    assert got.tobytes() == jnative.batch_gather(arr, idx).tobytes()


def test_batch_gather_refuses_what_it_does_not_take():
    arr = np.zeros((4, 2), np.float32)
    with pytest.raises(IndexError):
        native.batch_gather(arr, np.asarray([0, 4]))
    with pytest.raises(IndexError):
        native.batch_gather(arr, np.asarray([-1]))
    assert native.batch_gather(arr, np.asarray([], np.int64)).shape == (0, 2)
    strided = np.zeros((8, 4), np.float32)[:, ::2]
    assert not native.gather_applies(strided)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.batch_gather(strided, [0])
    with pytest.raises(ValueError, match="1-D"):
        native.batch_gather(arr, np.zeros((2, 2), np.int64))


def test_loader_draws_jax_s_batches_without_the_native_gather():
    """The loader's batches are the JAX loader's (same seed, same shuffle,
    same rows; the JAX loader gathers contiguous arrays natively, strided
    ones by numpy's index), and the port's gathers by numpy's index."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 7)).astype(np.float32)
    s = rng.normal(size=(64, 8)).astype(np.float32)[:, ::2]
    y = rng.integers(0, 3, size=(64,)).astype(np.int32)
    n0 = native.gathers
    got = list(SingleDataLoader([x, s], y, batch_size=16, seed=1).epoch())
    assert native.gathers == n0 and len(got) == 4
    want = list(JLoader([x, s], y, batch_size=16, seed=1).epoch())
    for (bx, by), (jx, jy) in zip(got, want):
        for a, b in zip(bx, jx):
            assert a.tobytes() == np.asarray(b).tobytes()
        assert by.tobytes() == np.asarray(jy).tobytes()


def _random_dag(ffm, ffc, n_layers, seed):
    rng = np.random.default_rng(seed)
    m = ffm(ffc(batch_size=4))
    ts = [m.create_tensor([4, 16], name="x")]
    for i in range(n_layers):
        src = ts[rng.integers(0, len(ts))]
        if rng.random() < 0.3 and len(ts) > 2:
            other = ts[rng.integers(0, len(ts))]
            if other.shape == src.shape:
                ts.append(m.add(src, other, name=f"add{i}"))
                continue
        ts.append(m.dense(src, 16, name=f"fc{i}"))
    return m


@pytest.mark.parametrize("seed", range(5))
def test_native_topo_order_equals_python_and_jax(seed):
    """On a 40-layer random DAG in reversed input order, the native walk
    gives the Python walk's order and the JAX package's, by name, and it
    is the shuffled input order that makes it differ from the input."""
    pm = _random_dag(FFModel, FFConfig, 40, seed)
    jm = _random_dag(JFFModel, JFFConfig, 40, seed)
    layers = list(reversed(pm.layers))
    jlayers = list(reversed(jm.layers))
    n0 = native.topo_orders
    got = [l.name for l in native.topo_order(layers)]
    assert native.topo_orders == n0 + 1
    assert got == [l.name for l in graph.topo_order(layers)]
    assert native.topo_orders == n0 + 1
    assert got == [l.name for l in jtopo_order(jlayers)]
    assert got != [l.name for l in layers] and len(got) == len(layers)


def test_native_topo_order_raises_on_a_cycle():
    assert list(native.topo_order_indices(3, [(0, 1), (1, 2)])) == [0, 1, 2]
    with pytest.raises(ValueError, match="cycle"):
        native.topo_order_indices(3, [(0, 1), (1, 2), (2, 1)])


def test_gpt2_graph_native_order_and_a_fit_without_the_native_core():
    """A GPT-2 tiny graph orders natively as the Python walk does; a CPU
    compile and fit call nothing native."""
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2

    gc = GPT2Config.tiny(seq=16)
    gc.layers = 4
    m = FFModel(FFConfig(batch_size=4))
    build_gpt2(m, gc, batch=4)
    assert [l.name for l in native.topo_order(m.layers)] == \
        [l.name for l in graph.topo_order(m.layers)]
    mlp = FFModel(FFConfig(batch_size=8))
    x = mlp.create_tensor([8, 12], name="x")
    mlp.dense(mlp.dense(x, 16, activation="relu"), 3)
    n0 = (native.gathers, native.topo_orders)
    cm = mlp.compile(SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy",
                     [], device="cpu")
    cm.init(seed=0)
    rng = np.random.default_rng(0)
    hist = cm.fit(rng.normal(size=(32, 12)).astype(np.float32),
                  rng.integers(0, 3, size=(32,)).astype(np.int32), epochs=1,
                  verbose=False)
    assert (native.gathers, native.topo_orders) == n0
    assert np.isfinite(hist[0]["loss"])
