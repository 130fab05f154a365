"""The Keras frontend of the port (flexflow_tpu_torch/keras/) against the
JAX package's (flexflow_tpu/keras/) on the CPU:

- a functional CNN and a functional model with merges build the same
  layer list in both packages; with JAX's initial weights carried over
  (`convert.params_from_jax`) `predict` and the first SGD and Adam losses
  of `fit` match (f32, 1e-5 relative); a Sequential model with dropout
  builds the same layers and predicts the same;
- an L2 kernel regularizer's term is in the loss (JAX's, and the
  unregularized loss plus coeff x |W|^2, 1e-5 relative);
- the datasets' synthetic data, `pad_sequences`, `Tokenizer` and the
  callbacks give JAX's arrays and states.
"""

import itertools

import jax
import numpy as np
import pytest

import flexflow_tpu.keras as jkeras
import flexflow_tpu_torch.keras as pkeras
from flexflow_tpu_torch.convert import params_from_jax

PKGS = {"jax": jkeras, "port": pkeras}
BATCH = 16


def _fresh(k):
    k.layers._uid = itertools.count()
    return k.layers


def _cnn(k):
    L = _fresh(k)
    inp = L.Input(shape=(3, 32, 32))
    t = L.Conv2D(16, (5, 5), padding=(2, 2), activation="relu")(inp)
    t = L.MaxPooling2D((2, 2), (2, 2))(t)
    t = L.Flatten()(t)
    t = L.Dense(32, activation="relu")(t)
    return k.models.Model(inp, L.Activation("softmax")(L.Dense(10)(t)))


def _merges(k):
    L = _fresh(k)
    inp = L.Input(shape=(16,))
    a = L.Dense(16, activation="relu")(inp)
    b = L.Dense(16, activation="relu")(inp)
    d = L.Dense(16)(L.concatenate([a, b], axis=-1))
    return k.models.Model(inp, L.Dense(2)(L.Add()([d, a])))


def _sequential(k):
    L = _fresh(k)
    return k.models.Sequential([L.Dense(32, activation="relu",
                                        input_shape=(16,)),
                                L.Dropout(0.1), L.Dense(2)])


def _data(which):
    if which == "cnn":
        (x, y), _ = jkeras.datasets.cifar10.load_data(BATCH)
        return (x / 255.0).astype(np.float32), y.astype(np.int32).reshape(-1)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BATCH, 16)).astype(np.float32)
    return x, (x.sum(1) > 0).astype(np.int32)


def _pair(build, opt):
    """The model built in both packages, compiled at BATCH, the port on
    JAX's initial weights."""
    out = {}
    for pkg, k in PKGS.items():
        m = build(k)
        if pkg == "jax":
            m.ffconfig_overrides = {"mesh_shape": {"data": 1},
                                    "log_level": "warning"}
        m.compile(optimizer=opt(k), loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"],
                  **({"device": "cpu"} if pkg == "port" else {}))
        m._build(BATCH)
        out[pkg] = m
    jcm = out["jax"].ffmodel.compiled
    jcm.init(seed=0)
    out["port"].ffmodel.compiled.load_params(
        params_from_jax(jax.device_get(jcm.params)))
    return out


def _layers(m):
    return [(l.name, l.op_type.value, [tuple(t.shape) for t in l.outputs])
            for l in m.ffmodel.layers]


@pytest.mark.parametrize("which,build,opt", [
    ("cnn", _cnn, lambda k: k.optimizers.SGD(learning_rate=0.05)),
    ("merges", _merges, lambda k: k.optimizers.Adam(learning_rate=1e-3))])
def test_functional_model_trains_as_in_jax(which, build, opt):
    models = _pair(build, opt)
    assert _layers(models["port"]) == _layers(models["jax"])
    x, y = _data(which)
    got, want = (models[p].predict(x) for p in ("port", "jax"))
    assert got.shape == (BATCH, 10 if which == "cnn" else 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    losses = {p: [h["loss"] for h in m.fit(x, y, batch_size=BATCH, epochs=3,
                                           verbose=False)]
              for p, m in models.items()}
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    ev = models["port"].evaluate(x, y)
    np.testing.assert_allclose(ev["loss"], models["jax"].evaluate(x, y)["loss"],
                               rtol=1e-5)


def test_sequential_with_dropout_builds_and_predicts_as_in_jax():
    models = _pair(_sequential, lambda k: k.optimizers.get("adam"))
    assert _layers(models["port"]) == _layers(models["jax"])
    assert [l[1] for l in _layers(models["port"])] == \
        ["linear", "dropout", "linear"]
    x, _ = _data("seq")
    np.testing.assert_allclose(models["port"].predict(x[:10]),
                               models["jax"].predict(x[:10]), rtol=1e-5,
                               atol=1e-6)


def test_regularizer_term_is_in_the_loss():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BATCH, 16)).astype(np.float32)
    y = rng.normal(size=(BATCH, 8)).astype(np.float32)

    def build(reg):
        def b(k):
            L = _fresh(k)
            m = k.models.Sequential()
            m.add(L.Input(shape=(16,)))
            m.add(L.Dense(8, kernel_regularizer=(
                k.regularizers.l2(0.5) if reg else None), name="d"))
            return m
        return b

    first = {}
    for reg in (True, False):
        models = {}
        for pkg, k in PKGS.items():
            m = build(reg)(k)
            if pkg == "jax":
                m.ffconfig_overrides = {"mesh_shape": {"data": 1},
                                        "log_level": "warning"}
            m.compile(optimizer=k.optimizers.SGD(learning_rate=0.05),
                      loss="mean_squared_error", metrics=[],
                      **({"device": "cpu"} if pkg == "port" else {}))
            m._build(BATCH)
            models[pkg] = m
        jcm = models["jax"].ffmodel.compiled
        jcm.init(seed=0)
        w = np.asarray(jax.device_get(jcm.params["d"]["kernel"]))
        models["port"].ffmodel.compiled.load_params(
            params_from_jax(jax.device_get(jcm.params)))
        first[reg] = {p: m.fit(x, y, batch_size=BATCH, epochs=1,
                               verbose=False)[0]["loss"]
                      for p, m in models.items()}
        np.testing.assert_allclose(first[reg]["port"], first[reg]["jax"],
                                   rtol=1e-5)
    np.testing.assert_allclose(first[True]["port"],
                               first[False]["port"] + 0.5 * float((w * w).sum()),
                               rtol=1e-5)


@pytest.mark.parametrize("name,kw", [
    ("cifar10", {"num_samples": 64}), ("mnist", {"num_samples": 32}),
    ("reuters", {"num_samples": 40, "num_words": 200, "maxlen": 90})])
def test_datasets_make_jax_synthetic_data(name, kw):
    with pytest.warns(UserWarning, match="not found locally"):
        got = getattr(pkeras.datasets, name).load_data(**kw)
    with pytest.warns(UserWarning):
        want = getattr(jkeras.datasets, name).load_data(**kw)
    for (gx, gy), (wx, wy) in zip(got, want):
        if isinstance(gx, list):
            assert gx == wx
        else:
            np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("kw", [
    {}, {"maxlen": 2}, {"maxlen": 2, "truncating": "post", "padding": "post"},
    {"maxlen": 4, "value": 9}, {"dtype": "float32", "padding": "post"}])
def test_pad_sequences_gives_jax_arrays(kw):
    from flexflow_tpu.keras.preprocessing import pad_sequences as jpad
    from flexflow_tpu_torch.keras.preprocessing import pad_sequences

    seqs = [[1, 2, 3], [4, 5], [6], []]
    got, want = pad_sequences(seqs, **kw), jpad(seqs, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["binary", "count", "freq", "tfidf"])
def test_tokenizer_gives_jax_arrays(mode):
    from flexflow_tpu.keras.preprocessing import text as jtext
    from flexflow_tpu_torch.keras.preprocessing import text

    texts = ["The cat sat, on the mat!", "the cat ran", "the dog dog"]
    tks = []
    for mod in (text, jtext):
        tk = mod.Tokenizer(num_words=10, oov_token="<oov>")
        tk.fit_on_texts(texts)
        tks.append(tk)
    seqs = tks[0].texts_to_sequences(["the cat", "a dog dog"])
    assert seqs == tks[1].texts_to_sequences(["the cat", "a dog dog"])
    np.testing.assert_array_equal(tks[0].sequences_to_matrix(seqs, mode),
                                  tks[1].sequences_to_matrix(seqs, mode))
    assert tks[0].to_json() == tks[1].to_json()
    assert text.hashing_trick("a b c", 7) == jtext.hashing_trick("a b c", 7)


def test_callbacks_behave_as_in_jax():
    for k in PKGS.values():
        ep, vm = (k.callbacks.EpochVerifyMetrics(0.5),
                  k.callbacks.VerifyMetrics(0.5))
        for acc in (0.4, 0.6, 0.45):
            ep.on_epoch_end(0, {"accuracy": acc})
            vm.on_epoch_end(0, {"accuracy": acc})
        assert ep.reached and vm.last == 0.45
        with pytest.raises(AssertionError, match="below target"):
            vm.on_train_end()
    assert pkeras.losses.SPARSE_CATEGORICAL_CROSSENTROPY.value == \
        jkeras.losses.SPARSE_CATEGORICAL_CROSSENTROPY.value
    assert pkeras.metrics.ACCURACY.value == jkeras.metrics.ACCURACY.value
