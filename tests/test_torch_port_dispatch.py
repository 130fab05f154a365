"""fit's dispatch pipeline in the PyTorch port against the JAX package, on
the CPU: `prefetch_multi`'s groups, `make_multi_step(K)` on a 2-layer
GPT-2 and on a small batch-norm model, `fit(steps_per_dispatch=K)`'s
history and `step_stats` (with K forced to 1 under a per-batch callback),
and the device keys and masks that let a CUDA graph of K steps draw each
step's dropout.

Each comparison feeds the same numpy inputs and the JAX CompiledModel's
initial weights (`convert.params_from_jax`) to both packages. Tolerance:
f32, 1e-5 relative (the same f32 math in another summation order, over
at most 8 updates); the port's K-step dispatch against K single steps of
its own with the same keys is bitwise (the same ops in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import AdamOptimizer as JAdamOptimizer
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.runtime import dataloader as jdataloader
from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch import random as ff_random
from flexflow_tpu_torch.convert import (opt_state_from_jax, params_from_jax,
                                        params_to_numpy)
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.tensor import Tensor
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.optimizers import (bias_corrections,
                                           device_bias_corrections)
from flexflow_tpu_torch.runtime import dataloader

K = 3
RTOL = 1e-5
ATOL = 1e-7   # a param near 0 after an update of a few ulps


@pytest.fixture(autouse=True)
def _guids_in_step():
    """Leave both packages' guid counters equal after each test (a layer's
    default name and its dropout key fold them in)."""
    yield
    from flexflow_tpu.core.layer import Layer as JLayer
    from flexflow_tpu.core.tensor import Tensor as JTensor

    for a, b in ((JLayer, Layer), (JTensor, Tensor)):
        a._next_guid[0] = b._next_guid[0] = max(a._next_guid[0],
                                                b._next_guid[0])


def _assert_trees_close(ptree, jtree, what):
    jt = jax.device_get(jtree)
    for l, ws in params_to_numpy(ptree).items():
        for w, a in ws.items():
            np.testing.assert_allclose(a, np.asarray(jt[l][w], np.float32),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {l}.{w}")


def _bitwise(a, b) -> bool:
    return all(torch.equal(a[l][w], b[l][w]) for l in a for w in a[l])


# ------------------------------------------------------------ the models
GPT_KW = dict(vocab=256, seq=64, d_model=64, heads=2, layers=2)
GPT_BATCH = 2


def _gpt_pair(dropout=0.0):
    """JAX and port GPT-2 (2 layers) from the JAX initial weights, SGD
    with momentum (Adam would turn the key bias's zero gradient into full
    steps, see test_torch_port_train.py)."""
    jm = JFFModel(JFFConfig(batch_size=GPT_BATCH, mesh_shape={"data": 1},
                            only_data_parallel=True, log_level="warning"))
    jbuild_gpt2(jm, JGPT2Config(**GPT_KW, dropout=dropout), batch=GPT_BATCH)
    jcm = jm.compile(JSGDOptimizer(lr=0.05, momentum=0.9),
                     "sparse_categorical_crossentropy", [])
    jcm.init(seed=0)
    pcm = _gpt_port(dropout)
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))
    return jcm, pcm


def _gpt_port(dropout=0.0):
    pm = FFModel(FFConfig(batch_size=GPT_BATCH))
    build_gpt2(pm, GPT2Config(**GPT_KW, dropout=dropout), batch=GPT_BATCH)
    return pm.compile(SGDOptimizer(lr=0.05, momentum=0.9),
                      "sparse_categorical_crossentropy", [], device="cpu")


def _gpt_groups(seed, n_groups):
    """n_groups stacked (K, b, seq) groups of ids, positions and labels."""
    rng = np.random.default_rng(seed)
    shape = (n_groups, K, GPT_BATCH, GPT_KW["seq"])
    ids = rng.integers(0, GPT_KW["vocab"], size=shape).astype(np.int32)
    pos = np.broadcast_to(np.arange(GPT_KW["seq"], dtype=np.int32),
                          shape).copy()
    labels = rng.integers(0, GPT_KW["vocab"], size=shape).astype(np.int32)
    return ids, pos, labels


def tiny_bn(m, batch=4):
    """conv 3x3 -> batch norm with relu -> global mean -> dense: the
    batch-norm running stats as the non-trainable state."""
    x = m.create_tensor([batch, 3, 8, 8], name="image")
    t = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="conv", use_bias=False)
    t = m.batch_norm(t, relu=True, name="bn")
    t = m.mean(t, axes=[2, 3], name="gap")
    m.dense(t, 10, name="fc")


def _bn_pair(**cfg):
    jm = JFFModel(JFFConfig(batch_size=4, mesh_shape={"data": 1},
                            only_data_parallel=True, log_level="warning",
                            **cfg))
    tiny_bn(jm)
    jcm = jm.compile(JAdamOptimizer(alpha=1e-2),
                     "sparse_categorical_crossentropy", ["accuracy"])
    jcm.init(seed=0)
    pm = FFModel(FFConfig(batch_size=4, **cfg))
    tiny_bn(pm)
    pcm = pm.compile(AdamOptimizer(alpha=1e-2),
                     "sparse_categorical_crossentropy", ["accuracy"],
                     device="cpu")
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))
    return jcm, pcm


def _bn_data(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3, 8, 8), scale=0.5).astype(np.float32)
    return x, rng.integers(0, 10, size=(n,)).astype(np.int32)


# ------------------------------------------------------- prefetch_multi
def _batches():
    """8 batches of (4, 2) and one ragged (3, 2) at index 5."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(9):
        n = 3 if i == 5 else 4
        out.append(([rng.normal(size=(n, 2)).astype(np.float32)],
                    rng.integers(0, 9, size=(n,)).astype(np.int32)))
    return out


@pytest.mark.parametrize("k", [1, 3])
def test_prefetch_multi_groups_match_jax(k):
    """Groups of k stacked to (k, ...), the partial group before a ragged
    batch and the epoch's tail flushed singly as "1": the same items in
    the same order as the JAX prefetcher's."""
    want = [(kind, [np.asarray(a) for a in dx], np.asarray(dy))
            for kind, dx, dy in jdataloader.prefetch_multi(
                iter(_batches()), k, [None], None)]
    got = [(kind, [a.numpy() for a in dx], dy.numpy())
           for kind, dx, dy in dataloader.prefetch_multi(
               iter(_batches()), k, "cpu")]
    assert [w[0] for w in want] == [g[0] for g in got]
    if k == 3:
        assert [g[0] for g in got] == ["k", "1", "1", "1", "k"]
    for (_, wx, wy), (_, gx, gy) in zip(want, got):
        np.testing.assert_array_equal(gx[0], wx[0])
        np.testing.assert_array_equal(gy, wy)
    # prefetch_to_device is the k = 1 case, untagged
    singles = list(dataloader.prefetch_to_device(iter(_batches()), "cpu"))
    assert len(singles) == 9
    np.testing.assert_array_equal(singles[5][0][0].numpy(),
                                  _batches()[5][0][0])


def test_prefetch_multi_forwards_worker_error_after_queued_items():
    def boom():
        yield from _batches()[:4]
        raise KeyError("loader broke")

    for gen in (jdataloader.prefetch_multi(boom(), K, [None], None),
                dataloader.prefetch_multi(boom(), K, "cpu")):
        kinds = []
        with pytest.raises(KeyError, match="loader broke"):
            for kind, _, _ in gen:
                kinds.append(kind)
        assert kinds == ["k"]


# ------------------------------------------------------- make_multi_step
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_multi_step_gpt2(dropout):
    """Two dispatches of make_multi_step(K) from the same weights: at
    dropout 0 the mean losses and params equal JAX's at 1e-5; at any
    dropout they equal 2K single `train_step`s of the port fed the keys
    fold_in(base, i) bitwise (step i of a dispatch at i0 draws
    fold_in(base, i0 + i))."""
    ids, pos, labels = _gpt_groups(1, 2)
    base = ff_random.key(11)
    # a dropout key folds in the layer's guid: build both with the same
    guids = Layer._next_guid[0], Tensor._next_guid[0]
    pcm = _gpt_port(dropout)
    pcm.init(seed=0)
    Layer._next_guid[0], Tensor._next_guid[0] = guids
    ref = _gpt_port(dropout)
    ref.load_params({l: {w: t.detach() for w, t in ws.items()}
                     for l, ws in pcm.params.items()})
    multi = pcm.make_multi_step(K)
    means = []
    for d in range(2):
        (pcm.params, pcm.opt_state, pcm.state, loss, _) = multi(
            pcm.params, pcm.opt_state, pcm.state,
            [torch.from_numpy(ids[d]), torch.from_numpy(pos[d])],
            torch.from_numpy(labels[d]), base, d * K)
        means.append(loss)
    singles = []
    for d in range(2):
        for i in range(K):
            (ref.params, ref.opt_state, ref.state, loss, _) = ref.train_step(
                ref.params, ref.opt_state, ref.state,
                [ids[d, i], pos[d, i]], labels[d, i],
                ff_random.fold_in(base, d * K + i))
            singles.append(loss)
    assert _bitwise(pcm.params, ref.params)
    for d in range(2):
        s = singles[d * K]
        for x in singles[d * K + 1:(d + 1) * K]:
            s = s + x
        assert torch.equal(means[d], s / K)
    if dropout:
        return
    jcm, pcm = _gpt_pair()
    jmulti = jcm.make_multi_step(K, donate=False)
    jbase = jax.random.PRNGKey(0)
    for d in range(2):
        (jcm.params, jcm.opt_state, jcm.state, jl, _) = jmulti(
            jcm.params, jcm.opt_state, jcm.state, [ids[d], pos[d]],
            labels[d], jbase, jnp.int32(d * K))
        (pcm.params, pcm.opt_state, pcm.state, pl, _) = pcm.make_multi_step(
            K)(pcm.params, pcm.opt_state, pcm.state,
               [torch.from_numpy(ids[d]), torch.from_numpy(pos[d])],
               torch.from_numpy(labels[d]), base, d * K)
        np.testing.assert_allclose(float(pl), float(jl), rtol=RTOL)
    _assert_trees_close(pcm.params, jcm.params, "params")
    _assert_trees_close(pcm.opt_state["trace"], params_to_numpy(
        opt_state_from_jax(jax.device_get(jcm.opt_state))["trace"]),
        "momentum")


def test_multi_step_batch_norm_matches_jax():
    """make_multi_step(K) under Adam on the batch-norm model: mean loss,
    mean accuracy, params, Adam's count and the running stats against
    JAX's after two dispatches; `_get_multi` returns one program per K."""
    jcm, pcm = _bn_pair()
    x, y = _bn_data(2, 2 * K * 4)
    xs = x.reshape(2, K, 4, 3, 8, 8)
    ys = y.reshape(2, K, 4)
    jmulti = jcm.make_multi_step(K, donate=False)
    assert pcm._get_multi(K) is pcm._get_multi(K)
    for d in range(2):
        (jcm.params, jcm.opt_state, jcm.state, jl, jm) = jmulti(
            jcm.params, jcm.opt_state, jcm.state, [xs[d]], ys[d],
            jax.random.PRNGKey(0), jnp.int32(d * K))
        (pcm.params, pcm.opt_state, pcm.state, pl, pmv) = pcm._get_multi(K)(
            pcm.params, pcm.opt_state, pcm.state, [torch.from_numpy(xs[d])],
            torch.from_numpy(ys[d]), 0, d * K)
        np.testing.assert_allclose(float(pl), float(jl), rtol=RTOL)
        np.testing.assert_allclose(float(pmv["accuracy"]),
                                   float(jm["accuracy"]), rtol=RTOL)
    _assert_trees_close(pcm.params, jcm.params, "params")
    assert int(pcm.opt_state["count"]) == 2 * K
    js = jax.device_get(jcm.state)
    assert set(pcm.state) == set(js) == {"bn/mean", "bn/var"}
    for k, v in pcm.state.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(js[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


# ---------------------------------------------------------------- fit
@pytest.mark.parametrize("k,accum", [(K, 1), (2, 2)])
def test_fit_steps_per_dispatch_matches_jax(k, accum):
    """One fit epoch over 8 batches with steps_per_dispatch=k and
    dispatch_ahead 2: the history, the params and `step_stats`
    (dispatches, host syncs, barriers, fused steps) equal JAX's."""
    jcm, pcm = _bn_pair(dispatch_ahead=2)
    x, y = _bn_data(4, 32)
    jh = jcm.fit(x, y, epochs=1, verbose=False, steps_per_dispatch=k,
                 accum_steps=accum)
    ph = pcm.fit(x, y, epochs=1, verbose=False, steps_per_dispatch=k,
                 accum_steps=accum)
    assert pcm.step_stats == jcm.step_stats
    updates = 8 // accum
    assert pcm.step_stats["fused_steps"] == updates // k * k
    assert pcm.step_stats["dispatches"] == updates // k + updates % k
    for key in ("loss", "accuracy", "dispatches", "host_syncs", "samples"):
        np.testing.assert_allclose(ph[0][key], jh[0][key], rtol=RTOL,
                                   err_msg=key)
    _assert_trees_close(pcm.params, jcm.params, "params")
    assert pcm._iteration == jcm._iteration == updates


def test_per_batch_callback_forces_one_step_a_dispatch():
    """A callback with on_batch_end reads every update's loss: K is forced
    to 1 and every update is a host sync, in both packages."""
    class Seen:
        def __init__(self):
            self.rows = []

        def on_batch_end(self, it, logs):
            self.rows.append((it, logs["loss"]))

    jcm, pcm = _bn_pair()
    x, y = _bn_data(5, 32)
    jc, pc = Seen(), Seen()
    jcm.fit(x, y, epochs=1, verbose=False, steps_per_dispatch=K,
            callbacks=[jc])
    pcm.fit(x, y, epochs=1, verbose=False, steps_per_dispatch=K,
            callbacks=[pc])
    assert pcm.step_stats == jcm.step_stats == {
        "dispatches": 8, "host_syncs": 8, "barriers": 0, "fused_steps": 0}
    assert [i for i, _ in pc.rows] == [i for i, _ in jc.rows] == \
        list(range(1, 9))
    np.testing.assert_allclose([l for _, l in pc.rows],
                               [l for _, l in jc.rows], rtol=RTOL)


# ------------------------------------------------------ keys and masks
def test_device_fold_in_is_bitwise_the_host_one():
    rng = np.random.default_rng(7)
    keys = [int(k) for k in rng.integers(0, 2 ** 63, size=64)] + [
        2 ** 64 - 1, 2 ** 63, 0]
    data = [0, 1, 2 ** 31, 2 ** 40 + 3]
    for k in keys:
        dk = ff_random.device_key(k, "cpu")
        assert ff_random.host_key(dk) == k
        for d in data:
            want = ff_random.fold_in(k, d)
            for got in (ff_random.fold_in(dk, d),
                        ff_random.fold_in(dk, torch.tensor(d)),
                        ff_random.fold_in(k, torch.tensor(d))):
                assert got.dtype == torch.int64 and got.dim() == 0
                assert ff_random.host_key(got) == want
        # a vector of steps at once (the K-step graph folds i0 + i)
        steps = torch.arange(5) + 7
        vec = ff_random.fold_in(dk, steps)
        assert [ff_random.host_key(v) for v in vec] == \
            [ff_random.fold_in(k, 7 + i) for i in range(5)]


def test_same_key_draws_the_same_mask():
    """A host key and its device copy draw the same mask bit for bit; the
    keep rate is within 5 sigma of the binomial; masks of neighbouring
    keys agree where two independent draws would."""
    base = ff_random.key(3)
    shape, keep = (64, 1024), 0.9
    n = 64 * 1024
    a = ff_random.bernoulli_mask(ff_random.fold_in(base, 0), shape, keep,
                                 "cpu")
    b = ff_random.bernoulli_mask(
        ff_random.fold_in(ff_random.device_key(base, "cpu"),
                          torch.tensor(0)), shape, keep, "cpu")
    assert a.dtype == torch.bool and a.shape == shape
    assert torch.equal(a, b)
    sd = (n * keep * (1 - keep)) ** 0.5
    assert abs(int(a.sum()) - n * keep) <= 5 * sd
    c = ff_random.bernoulli_mask(ff_random.fold_in(base, 1), shape, keep,
                                 "cpu")
    agree = keep ** 2 + (1 - keep) ** 2
    assert abs(int((a == c).sum()) - n * agree) <= 5 * (
        n * agree * (1 - agree)) ** 0.5


def test_device_bias_corrections_equal_numpy_f32():
    """Adam's bias corrections computed from the device count equal the
    host's numpy f32 values (`bias_corrections`) at every count up to
    3000 on the CPU. (On the card chip_smoke reads the same check.)"""
    for b1, b2 in ((0.9, 0.999), (0.8, 0.95)):
        cache = {}
        for c in range(1, 3001):
            sc = device_bias_corrections(
                b1, b2, torch.tensor(c, dtype=torch.int32), cache)
            assert (float(sc[0]), float(sc[1])) == bias_corrections(b1, b2, c)
