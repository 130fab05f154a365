"""Dropout, the rng and per-layer remat in the PyTorch port against the JAX
package, on the CPU.

The port draws its masks from its own keys (flexflow_tpu_torch/random.py),
which cannot match threefry's bits; to compare the two packages on the
same numbers, the port's lowering is fed the masks the JAX lowering draws,
`jax.random.bernoulli(fold_in(rng, guid), keep, shape)`, through the test
hook `GraphForward.mask_hook` (or `LoweringCtx.mask_hook` for one op).
GPT-2 at tiny widths (vocab 64, seq 16, d_model 32, 2 heads) with dropout
0.1 trains in both packages on the same weights (`convert.py`), in f32:
plain steps, `accum_steps=2` (microbatch j draws from `fold_in(rng, j)`)
and remat "full"/"dots" from a strategy file that the JAX package wrote.
Remat leaves the port's loss and gradients bitwise unchanged. The port's
own masks are checked for their keep rate, their 1/keep scale and their
dependence on the key alone.
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
from flexflow_tpu.losses import compute_loss as jcompute_loss
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.ops import get_op_def as jget_op_def
from flexflow_tpu.ops.registry import LoweringCtx as JLoweringCtx
from flexflow_tpu.parallel.sharding import Strategy as JStrategy
from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch import random as ff_random
from flexflow_tpu_torch.compiler import compile as port_compile
from flexflow_tpu_torch.compiler import lowering
from flexflow_tpu_torch.convert import params_from_jax, params_to_numpy
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.ops import get_op_def
from flexflow_tpu_torch.ops.registry import LoweringCtx
from flexflow_tpu_torch.parallel.sharding import Strategy

B, SEQ, VOCAB, RATE = 2, 16, 64, 0.1
KW = dict(vocab=VOCAB, seq=SEQ, d_model=32, heads=2, layers=2, dropout=RATE)
# f32, the same masks: the two packages differ by summation order only
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
# the key bias `bk` has a zero gradient in exact arithmetic (the softmax
# cancels it): both packages hold rounding noise there
ZERO_GRAD = "bk"


def _batch(seed, n=B):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, size=(n, SEQ)).astype(np.int32)
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (n, 1))
    return [ids, pos], rng.integers(0, VOCAB, size=(n, SEQ)).astype(np.int32)


def _pair(jopt, opt, **cfg):
    """GPT-2 tiny with dropout 0.1 in both packages, the port on the JAX
    initial weights, with the JAX masks fed to the port (see _feed)."""
    jm = JFFModel(JFFConfig(batch_size=B, mesh_shape={"data": 1},
                            only_data_parallel=True, log_level="warning",
                            **cfg))
    jbuild_gpt2(jm, JGPT2Config(**KW), batch=B)
    jcm = jm.compile(jopt, "sparse_categorical_crossentropy", [])
    jcm.init(seed=0)
    pm = FFModel(FFConfig(batch_size=B, **cfg))
    build_gpt2(pm, GPT2Config(**KW), batch=B)
    pcm = pm.compile(opt, "sparse_categorical_crossentropy", [], device="cpu")
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))
    return jm, jcm, pcm


def _feed(jm, pcm, keys):
    """Hook the port's draws to JAX's: `keys` maps each port key the run
    uses to the JAX key of the same run. Returns the hook's call log."""
    guid = {l.name: l.guid for l in jm.layers}
    calls = []

    def hook(layer, rng, shape, keep):
        calls.append(layer.name)
        m = jax.random.bernoulli(jax.random.fold_in(keys[rng],
                                                     guid[layer.name]),
                                 keep, shape)
        return torch.from_numpy(np.array(m))

    pcm.forward_fn.mask_hook = hook
    return calls


def _jax_value_and_grads(jcm, inputs, labels, jkey):
    def loss_fn(p):
        outs, _ = jcm.forward_fn(p, jcm.state, [jnp.asarray(x) for x in inputs],
                                 True, jkey)
        return jcompute_loss(jcm.loss_type, outs[0].astype(jnp.float32),
                             jnp.asarray(labels))

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(jcm.params)
    return float(loss), jax.device_get(g)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_grads_close(pg, jg):
    for layer, ws in pg.items():
        for w, g in ws.items():
            if w == ZERO_GRAD:
                continue
            got = g.detach().numpy()
            assert _rel_l2(got, jg[layer][w]) <= GRAD_REL_L2, (layer, w)


def _assert_bitwise(a, b):
    """Two (loss, grads) results of the port: bitwise equal."""
    assert float(a[0]) == float(b[0])
    for layer, ws in a[1].items():
        for w, g in ws.items():
            assert torch.equal(g, b[1][layer][w]), (layer, w)


# ------------------------------------------------------------ single ops
def _one_layer(pkg_model, build):
    m = pkg_model
    build(m)
    return m.layers[-1]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_dropout_op_matches_jax_on_its_mask(dt):
    """The dropout lowering, fed JAX's mask: where(mask, x / keep, 0) in
    x's dtype, bitwise; the identity in inference."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 32)).astype(np.float32)
    jl = _one_layer(JFFModel(JFFConfig()), lambda m: m.dropout(
        m.create_tensor([4, 8, 32], name="x"), rate=0.25))
    pl = _one_layer(FFModel(FFConfig()), lambda m: m.dropout(
        m.create_tensor([4, 8, 32], name="x"), rate=0.25))
    jkey = jax.random.PRNGKey(7)
    jx = jnp.asarray(x).astype(dt)
    want = jget_op_def(jl.op_type).lower(
        jl, [jx], {}, JLoweringCtx(training=True, rng=jkey))[0]
    mask = np.asarray(jax.random.bernoulli(jax.random.fold_in(jkey, jl.guid),
                                           0.75, x.shape))
    ctx = LoweringCtx(training=True, rng=ff_random.key(7),
                      mask_hook=lambda *a: torch.from_numpy(mask.copy()))
    px = torch.from_numpy(x).to(getattr(torch, dt))
    got = get_op_def(pl.op_type).lower(pl, [px], {}, ctx)[0]
    assert got.dtype == px.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert get_op_def(pl.op_type).lower(pl, [px], {}, LoweringCtx())[0] is px


@pytest.mark.parametrize("fusion", [True, False])
def test_attention_prob_dropout_matches_jax_on_its_mask(fusion):
    """Attention with dropout 0.1 in training takes the einsum path with
    fusion on or off (the kernel has no dropout), and applies JAX's probs
    mask: the output agrees with the JAX lowering's in f32."""
    rng = np.random.default_rng(1)
    d, h = 32, 2

    def build(m):
        t = m.create_tensor([B, SEQ, d], name="x")
        m.multihead_attention(t, t, t, d, h, dropout=RATE, causal=True)
    jl = _one_layer(JFFModel(JFFConfig()), build)
    pl = _one_layer(FFModel(FFConfig()), build)
    x = rng.standard_normal((B, SEQ, d)).astype(np.float32)
    w = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.2
         for k, s in pl.weight_specs.items()}
    jkey = jax.random.PRNGKey(3)
    jx = jnp.asarray(x)
    want = jget_op_def(jl.op_type).lower(
        jl, [jx, jx, jx], {k: jnp.asarray(v) for k, v in w.items()},
        JLoweringCtx(training=True, rng=jkey, enable_fusion=fusion))[0]
    shapes = []

    def hook(layer, r, shape, keep):
        shapes.append(shape)
        return torch.from_numpy(np.array(jax.random.bernoulli(
            jax.random.fold_in(jkey, jl.guid), keep, shape)))

    ctx = LoweringCtx(training=True, rng=ff_random.key(3),
                      enable_fusion=fusion, mask_hook=hook)
    px = torch.from_numpy(x)
    got = get_op_def(pl.op_type).lower(
        pl, [px, px, px], {k: torch.from_numpy(v) for k, v in w.items()},
        ctx)[0]
    assert shapes == [(B, h, SEQ, SEQ)]     # the probs, on the einsum path
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_impl_flash_with_dropout_raises_as_in_jax():
    def build(m):
        t = m.create_tensor([B, SEQ, 32], name="x")
        m.multihead_attention(t, t, t, 32, 2, dropout=RATE, impl="flash")
    jl = _one_layer(JFFModel(JFFConfig()), build)
    pl = _one_layer(FFModel(FFConfig()), build)
    x = np.zeros((B, SEQ, 32), np.float32)
    w = {k: np.zeros(s.shape, np.float32) for k, s in pl.weight_specs.items()}
    with pytest.raises(NotImplementedError) as je:
        jget_op_def(jl.op_type).lower(
            jl, [jnp.asarray(x)] * 3, {k: jnp.asarray(v) for k, v in w.items()},
            JLoweringCtx(training=True, rng=jax.random.PRNGKey(0)))
    with pytest.raises(NotImplementedError) as pe:
        get_op_def(pl.op_type).lower(
            pl, [torch.from_numpy(x)] * 3,
            {k: torch.from_numpy(v) for k, v in w.items()},
            LoweringCtx(training=True, rng=0))
    assert str(pe.value) == str(je.value)


# ------------------------------------------------------------ own masks
def test_own_masks_keep_rate_scale_and_key():
    """The port's masks: the keep rate within 5 sigma of the binomial, kept
    elements scaled by exactly 1/keep, the same (key, layer) drawing the
    same mask, another step's key another mask."""
    pl = _one_layer(FFModel(FFConfig()), lambda m: m.dropout(
        m.create_tensor([64, 1024], name="x"), rate=RATE))
    x = torch.ones(64, 1024)
    op = get_op_def(pl.op_type)

    def run(k):
        return op.lower(pl, [x], {}, LoweringCtx(training=True, rng=k))[0]
    base = ff_random.key(0)
    a = run(ff_random.fold_in(base, 0))
    n, keep = x.numel(), 1.0 - RATE
    kept = int((a != 0).sum())
    assert abs(kept - n * keep) <= 5 * (n * keep * RATE) ** 0.5
    assert set(torch.unique(a).tolist()) == {0.0, float(torch.tensor(1.0) / keep)}
    assert torch.equal(run(ff_random.fold_in(base, 0)), a)
    assert not torch.equal(run(ff_random.fold_in(base, 1)), a)
    # the key decides alone: torch's global RNG is neither read nor moved
    state = torch.random.get_rng_state()
    torch.manual_seed(123)
    assert torch.equal(run(ff_random.fold_in(base, 0)), a)
    torch.random.set_rng_state(state)
    with pytest.raises(ValueError, match="needs an rng"):
        op.lower(pl, [x], {}, LoweringCtx(training=True))


def test_keys_are_fixed_64_bit_mixes():
    k = ff_random.key(5)
    assert 0 <= k < 2 ** 64 and k == ff_random.key(5) != ff_random.key(6)
    assert ff_random.fold_in(k, 1) == ff_random.fold_in(k, 1)
    assert len({ff_random.fold_in(k, i) for i in range(1000)}) == 1000


# ------------------------------------------------------- whole train step
@pytest.fixture(scope="module")
def adam_pair():
    return _pair(JAdamOptimizer(alpha=1e-3), AdamOptimizer(alpha=1e-3))


def test_train_step_with_dropout_matches_jax(adam_pair):
    """One Adam train step with dropout 0.1 in both packages, the port fed
    JAX's masks: the same loss; and the gradients of the same step agree
    (a different key draws other masks: another loss)."""
    jm, jcm, pcm = adam_pair
    inputs, labels = _batch(0)
    jkey, pkey = jax.random.PRNGKey(11), ff_random.key(11)
    calls = _feed(jm, pcm, {pkey: jkey})
    jl, jg = _jax_value_and_grads(jcm, inputs, labels, jkey)
    pl, _, _, pg = pcm.value_and_grads(pcm.params, pcm.state, inputs, labels,
                                       pkey)
    assert sorted(set(calls)) == ["embed_drop", "h0_attn", "h1_attn"]
    np.testing.assert_allclose(float(pl), jl, rtol=LOSS_RTOL)
    _assert_grads_close(pg, jg)
    jk2 = jax.random.PRNGKey(12)
    assert abs(_jax_value_and_grads(jcm, inputs, labels, jk2)[0] - jl) > 1e-4


def test_accum_step_with_dropout_matches_jax():
    """accum_steps=2 with dropout under SGD(0.1) in both packages: each
    microbatch j draws from fold_in(rng, j), so with JAX's masks fed the
    loss and the updated params agree."""
    jm, jcm, pcm = _pair(JSGDOptimizer(lr=0.1), SGDOptimizer(lr=0.1),
                         accum_steps=2)
    (i0, p0), l0 = _batch(1)
    (i1, p1), l1 = _batch(2)
    inputs, labels = [np.stack([i0, i1]), np.stack([p0, p1])], np.stack([l0, l1])
    jkey, pkey = jax.random.PRNGKey(5), ff_random.key(5)
    _feed(jm, pcm, {ff_random.fold_in(pkey, j): jax.random.fold_in(jkey, j)
                    for j in range(2)})
    (jcm.params, jcm.opt_state, jcm.state, jl, _) = jcm.train_step(
        jcm.params, jcm.opt_state, jcm.state, inputs, labels, jkey)
    (pcm.params, pcm.opt_state, pcm.state, pl, _) = pcm.train_step(
        pcm.params, pcm.opt_state, pcm.state, inputs, labels, pkey)
    np.testing.assert_allclose(float(pl), float(jl), rtol=LOSS_RTOL)
    jp, pp = jax.device_get(jcm.params), params_to_numpy(pcm.params)
    for layer, ws in pp.items():
        for w, a in ws.items():
            np.testing.assert_allclose(a, np.asarray(jp[layer][w]), atol=1e-6,
                                       err_msg=f"{layer}.{w}")


# ------------------------------------------------------------------ remat
def test_remat_leaves_the_port_bitwise_unchanged(adam_pair):
    """remat "full" and "dots" on every layer: the same loss and gradients,
    bit for bit, as remat off (the recompute draws the same masks); every
    layer ran under the checkpoint."""
    _, _, pcm = adam_pair
    pcm.forward_fn.mask_hook = None
    inputs, labels = _batch(3)
    key = ff_random.key(21)
    pcm.forward_fn.remat = {}
    ref = pcm.value_and_grads(pcm.params, pcm.state, inputs, labels, key)
    ran = []
    real = lowering._checkpointed

    def counted(fn, policy, *args):
        ran.append(policy)
        return real(fn, policy, *args)

    for pol in ("full", "dots"):
        pcm.forward_fn.remat = {l.name: pol for l in pcm.model.layers}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lowering, "_checkpointed", counted)
            got = pcm.value_and_grads(pcm.params, pcm.state, inputs, labels,
                                      key)
        _assert_bitwise((got[0], got[3]), (ref[0], ref[3]))
    assert ran == ["full"] * len(pcm.model.layers) + \
        ["dots"] * len(pcm.model.layers)
    pcm.forward_fn.remat = {}


def test_strategy_file_from_jax_applies_remat(tmp_path):
    """A strategy JSON written by the JAX package's `Strategy.save` with a
    per-layer remat map ("dots" on the attention layers, "full" on the MLP
    layers) is imported by both packages: the map reaches the port's
    lowering, its loss and gradients equal the port's without remat
    bitwise, and JAX's with the same map within the f32 tolerance."""
    names = [f"h{i}_{s}" for i in range(KW["layers"])
             for s in ("attn", "mlp_up", "mlp_down")]
    rmap = {n: ("dots" if n.endswith("attn") else "full") for n in names}
    path = str(tmp_path / "strategy.json")
    JStrategy(name="remat_test", mesh_axes={"data": 1}, remat=rmap).save(path)
    loaded = Strategy.load(path)
    assert loaded.remat == rmap and loaded.name == "remat_test"
    assert loaded.to_json() == JStrategy.load(path).to_json()
    jm, jcm, pcm = _pair(JAdamOptimizer(), AdamOptimizer(),
                         import_strategy_file=path)
    assert pcm.forward_fn.remat == rmap == jcm.strategy.remat
    inputs, labels = _batch(4)
    jkey, pkey = jax.random.PRNGKey(9), ff_random.key(9)
    _feed(jm, pcm, {pkey: jkey})
    jl, jg = _jax_value_and_grads(jcm, inputs, labels, jkey)
    got = pcm.value_and_grads(pcm.params, pcm.state, inputs, labels, pkey)
    np.testing.assert_allclose(float(got[0]), jl, rtol=LOSS_RTOL)
    _assert_grads_close(got[3], jg)
    pcm.forward_fn.remat = {}
    ref = pcm.value_and_grads(pcm.params, pcm.state, inputs, labels, pkey)
    _assert_bitwise((got[0], got[3]), (ref[0], ref[3]))


def test_remat_alias_and_export(tmp_path):
    """cfg.remat maps to "full" on every layer (after the export, as in
    JAX); the exported file is the JAX package's format."""
    path = str(tmp_path / "out.json")
    m = FFModel(FFConfig(batch_size=B, remat=True, export_strategy_file=path))
    build_gpt2(m, GPT2Config(**KW), batch=B)
    cm = m.compile(AdamOptimizer(), device="cpu")
    assert cm.forward_fn.remat == {l.name: "full" for l in m.layers}
    assert JStrategy.load(path).remat is None
    assert Strategy.load(path).name == "data_parallel"


def test_remat_knobs_checked_as_in_jax():
    for kw in (dict(remat=True, remat_search=True),
               dict(remat_policies="none,bogus")):
        with pytest.raises(ValueError) as pe:
            FFConfig(**kw)
        with pytest.raises(ValueError) as je:
            JFFConfig(**kw)
        assert str(pe.value) == str(je.value)
    assert FFConfig(remat_policies="dots").remat_policy_list() == \
        JFFConfig(remat_policies="dots").remat_policy_list()
    # on the one-device machine nothing is searched and no layer is
    # rematerialized, as in JAX
    m = FFModel(FFConfig(batch_size=B, remat_search=True))
    build_gpt2(m, GPT2Config(**KW), batch=B)
    cm = m.compile(AdamOptimizer(), device="cpu")
    assert cm.forward_fn.remat == {} and not cm.strategy.remat


def test_remat_and_checkpoint_flags_parse_as_in_jax():
    argv = ["--remat", "--remat-policies", "none,full", "--import", "a.json",
            "--export", "b.json", "--no-async-checkpoint", "--checkpoint-dir",
            "ck", "--checkpoint-every-steps", "5", "--checkpoint-every-secs",
            "2.5", "--resume", "auto", "--keep-checkpoints", "2"]
    got, want = FFConfig.parse_args(argv), JFFConfig.parse_args(argv)
    fields = ("remat", "remat_search", "remat_policies",
              "import_strategy_file", "export_strategy_file",
              "async_checkpoint", "checkpoint_dir", "checkpoint_every_steps",
              "checkpoint_every_secs", "resume", "keep_checkpoints")
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f
    for f in fields:
        assert getattr(FFConfig(), f) == getattr(JFFConfig(), f), f


def test_fit_steps_with_the_iteration_key(adam_pair):
    """fit's step i draws from fold_in(key(seed + 17), iteration), the
    iteration counting updates across fits."""
    _, _, pcm = adam_pair
    pcm.forward_fn.mask_hook = None
    seen = []
    real = port_compile.CompiledModel.train_step

    def spy(self, *a):
        seen.append(a[-1])
        return real(self, *a)

    x, y = _batch(6, n=2 * B)
    it0 = pcm._iteration
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_compile.CompiledModel, "train_step", spy)
        pcm.fit(x, y, epochs=1, verbose=False)
    base = ff_random.key(pcm.cfg.seed + 17)
    assert seen == [ff_random.fold_in(base, it0 + i) for i in range(2)]
    assert pcm._iteration == it0 + 2
