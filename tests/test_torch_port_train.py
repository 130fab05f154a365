"""The PyTorch port's training slice against the JAX package, on the CPU.

`GPT2Config.tiny()` (seq 128, head_dim 64, vocab 5120) with dropout 0 is
built in both packages; the JAX CompiledModel's initial weights move into
the port with `params_from_jax`. Both take 20 Adam `train_step`s on one
batch, then one `fit` epoch: the losses, the final params and the fit
history must agree within the stated tolerances. On the JAX side seq 128
reaches the Pallas flash kernels (forward and backward), vocab 5120 the
fused cross-entropy kernels and Adam the fused optimizer kernel, all in
interpret mode; the port runs their plain versions on the CPU. The
padded vocab under SGD and gradient accumulation are in
tests/test_torch_port_train_sgd.py.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flexflow_tpu import AdamOptimizer as JAdamOptimizer
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.metrics import PerfMetrics as JPerfMetrics
from flexflow_tpu.metrics import compute_metrics as jcompute_metrics
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.runtime.dataloader import \
    SingleDataLoader as JSingleDataLoader
from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
from flexflow_tpu_torch.convert import (opt_state_from_jax, params_from_jax,
                                        params_to_numpy)
from flexflow_tpu_torch.kernels import flash_attention, fused_ce, fused_optim
from flexflow_tpu_torch.metrics import PerfMetrics, compute_metrics
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader

jflash = importlib.import_module("flexflow_tpu.kernels.flash_attention")

# Adam at GPT-2's training step size (bench.py's alpha=1e-4)
BATCH, STEPS, LR = 4, 20, 1e-4
# f32: the same f32 math in another summation order, 20 steps deep. bf16:
# activations round to bf16 at the same points, but a last-bit difference
# in an f32 sum can round a bf16 value the other way, and the embedding
# gradient is a bf16 scatter-add in both packages, summed in another order.
LOSS_RTOL = {"float32": 1e-4, "bfloat16": 2e-3}
PARAM_ATOL = {"float32": 2e-5, "bfloat16": 2e-3}
PARAM_REL_L2 = {"float32": 2e-5, "bfloat16": 2e-3}
MOMENT_REL_L2 = {"float32": 1e-5, "bfloat16": 3e-2}
# The attention key bias `bk` adds the same q.bk to every score of a row,
# which the softmax cancels: its gradient is zero in exact arithmetic and
# rounding noise in either package. Adam scales that noise to steps of up
# to ~lr, in directions the two packages draw differently, so `bk` is held
# only to Adam's step bound and left out of the moment comparison.
ZERO_GRAD = "bk"
ZERO_GRAD_ATOL = 2 * STEPS * LR


def _gpt2_kw():
    return dict(vocab=5120, seq=128, d_model=256, heads=4, layers=2,
                dropout=0.0)


def _data(seed, n, vocab=5120):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(n, 128)).astype(np.int32)
    pos = np.tile(np.arange(128, dtype=np.int32), (n, 1))
    labels = rng.integers(0, vocab, size=(n, 128)).astype(np.int32)
    return [ids, pos], labels


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def trained(request):
    """Both models after STEPS train steps on one batch: (dtype, jax cm,
    port cm, jax losses, port losses, jax params, port params). The JAX
    flash wrapper counts the traces that reached its Pallas kernel."""
    dt = request.param
    assert GPT2Config.tiny().vocab == _gpt2_kw()["vocab"]
    calls = {"flash": 0}
    real = jflash.flash_attention_qkv

    def counted(*a, **kw):
        out = real(*a, **kw)
        calls["flash"] += 1
        return out

    jcfg = JFFConfig(batch_size=BATCH, compute_dtype=dt, mesh_shape={"data": 1},
                     only_data_parallel=True, log_level="warning")
    jm = JFFModel(jcfg)
    jbuild_gpt2(jm, JGPT2Config(**_gpt2_kw()), batch=BATCH)
    jcm = jm.compile(JAdamOptimizer(alpha=LR),
                     "sparse_categorical_crossentropy", [])
    jcm.init(seed=0)
    pm = FFModel(FFConfig(batch_size=BATCH, compute_dtype=dt))
    build_gpt2(pm, GPT2Config(**_gpt2_kw()), batch=BATCH)
    pcm = pm.compile(AdamOptimizer(alpha=LR),
                     "sparse_categorical_crossentropy", [], device="cpu")
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))

    inputs, labels = _data(0, BATCH)
    key = jax.random.PRNGKey(0)
    jl, pl = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jflash, "flash_attention_qkv", counted)
        for _ in range(STEPS):
            (jcm.params, jcm.opt_state, jcm.state, loss, _) = jcm.train_step(
                jcm.params, jcm.opt_state, jcm.state, inputs, labels, key)
            jl.append(float(loss))
            (pcm.params, pcm.opt_state, pcm.state, loss, _) = pcm.train_step(
                pcm.params, pcm.opt_state, pcm.state, inputs, labels)
            pl.append(float(loss))
    assert calls["flash"] > 0      # traced through the Pallas kernel
    return (dt, jcm, pcm, np.array(jl), np.array(pl),
            jax.device_get(jcm.params), params_to_numpy(pcm.params))


def test_losses_match_jax_at_every_step(trained):
    dt, _, _, jl, pl, _, _ = trained
    assert np.all(np.isfinite(pl)) and pl[-1] < pl[0]
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL[dt])


def _rel_l2(got, want, skip=None) -> float:
    keys = [(l, w) for l in got for w in got[l] if w != skip]
    num = sum(float(((got[l][w] - np.asarray(want[l][w], np.float32)) ** 2)
                    .sum()) for l, w in keys)
    den = sum(float((np.asarray(want[l][w], np.float32) ** 2).sum())
              for l, w in keys)
    return (num / den) ** 0.5


def test_final_params_match_jax(trained):
    dt, _, _, _, _, jp, pp = trained
    for layer, ws in pp.items():
        for w, a in ws.items():
            b = np.asarray(jp[layer][w], np.float32)
            assert a.shape == b.shape
            atol = ZERO_GRAD_ATOL if w == ZERO_GRAD else PARAM_ATOL[dt]
            np.testing.assert_allclose(a, b, atol=atol, err_msg=f"{layer}.{w}")
    assert _rel_l2(pp, jp) <= PARAM_REL_L2[dt]


def test_moments_carry_across(trained):
    """`opt_state_from_jax` carries the JAX Adam state across: the same
    count, and moments close to the port's own after the same steps."""
    dt, jcm, pcm, *_ = trained
    carried = opt_state_from_jax(jax.device_get(jcm.opt_state))
    assert carried["count"] == pcm.opt_state["count"] == STEPS
    for m in ("mu", "nu"):
        assert _rel_l2(params_to_numpy(pcm.opt_state[m]),
                       params_to_numpy(carried[m]),
                       skip=ZERO_GRAD) <= MOMENT_REL_L2[dt]


def test_fit_epoch_matches_jax(trained):
    """One fit epoch from the trained state, same seed in both packages:
    the shuffled loaders feed the same batches, so the history loss
    agrees; the loss stays on the device until the epoch ends."""
    dt, jcm, pcm, *_ = trained
    x, y = _data(1, 4 * BATCH)
    jh = jcm.fit(x, y, epochs=1, verbose=False)
    ph = pcm.fit(x, y, epochs=1, verbose=False, sync_every=0)
    np.testing.assert_allclose(ph[0]["loss"], jh[0]["loss"],
                               rtol=LOSS_RTOL[dt])
    assert pcm.step_stats == {"dispatches": 4, "host_syncs": 0,
                              "barriers": 0, "fused_steps": 0}
    assert ph[0]["dispatches"] == 4.0 and ph[0]["samples"] == 4 * BATCH
    pcm.fit(x, y, epochs=1, verbose=False, sync_every=2)
    assert pcm.step_stats == {"dispatches": 4, "host_syncs": 2,
                              "barriers": 0, "fused_steps": 0}


def test_dataloaders_draw_the_same_batches():
    x, y = _data(2, 11)
    j = JSingleDataLoader(x, y, 4, shuffle=True, seed=3)
    p = SingleDataLoader(x, y, 4, shuffle=True, seed=3)
    for _ in range(3):
        jb, pb = list(j.epoch()), list(p.epoch())
        assert len(jb) == len(pb) == 2
        for (jx, jy), (px, py) in zip(jb, pb):
            np.testing.assert_array_equal(py, jy)
            for a, b in zip(px, jx):
                np.testing.assert_array_equal(a, b)


def test_cpu_training_launches_no_kernel():
    """On the CPU every wrapper ran its plain version: no launch counted."""
    assert (flash_attention.launches, flash_attention.launches_dq,
            flash_attention.launches_dkv, fused_optim.launches) == (0, 0, 0, 0)
    assert (fused_ce.launches_fwd, fused_ce.launches_bwd,
            fused_optim.launches_sgd, fused_optim.launches_sgd_plain) == \
        (0, 0, 0, 0)


def _small_model(dropout=0.0, **cfg):
    m = FFModel(FFConfig(batch_size=2, **cfg))
    build_gpt2(m, GPT2Config(vocab=64, seq=16, d_model=32, heads=2, layers=1,
                             dropout=dropout), batch=2)
    return m


def _small_batch():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 64, size=(2, 16)).astype(np.int32)
    return ([ids, np.tile(np.arange(16, dtype=np.int32), (2, 1))],
            rng.integers(0, 64, size=(2, 16)).astype(np.int32))


def _dropout_pair(fusion, impl=None):
    """GPT-2 at the small widths with dropout 0.1 in both packages (f32,
    Adam), the port on the JAX weights and fed the JAX masks; with `impl`,
    one attention layer of that impl over a float input instead."""
    cfgs = dict(batch_size=2, enable_fusion=fusion)
    jm = JFFModel(JFFConfig(mesh_shape={"data": 1}, only_data_parallel=True,
                            log_level="warning", **cfgs))
    pm = FFModel(FFConfig(**cfgs))
    for m, gc, build in ((jm, JGPT2Config, jbuild_gpt2),
                         (pm, GPT2Config, build_gpt2)):
        if impl is None:
            build(m, gc(vocab=64, seq=16, d_model=32, heads=2, layers=1,
                        dropout=0.1), batch=2)
            continue
        # named layers: default names carry each package's process-wide
        # guid counter, which other test files in the process move apart
        t = m.create_tensor([2, 16, 32], name="x")
        t = m.multihead_attention(t, t, t, 32, 2, dropout=0.1, causal=True,
                                  impl=impl, name="mha")
        m.dense(t, 64, name="head")
    jcm = jm.compile(JAdamOptimizer(), "sparse_categorical_crossentropy", [])
    jcm.init(seed=0)
    pcm = pm.compile(AdamOptimizer(), device="cpu")
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))
    guid = {l.name: l.guid for l in jm.layers}
    jkey = jax.random.PRNGKey(1)

    def hook(layer, rng, shape, keep):
        return torch.from_numpy(np.array(jax.random.bernoulli(
            jax.random.fold_in(jkey, guid[layer.name]), keep, shape)))
    pcm.forward_fn.mask_hook = hook
    return jcm, pcm, jkey


@pytest.mark.parametrize("fusion", [True, False])
def test_dropout_in_training_raises(fusion):
    """GPT-2 with dropout 0.1 trains in the port (with fusion on too: the
    attention takes the einsum path under dropout, as in JAX). Fed the
    masks JAX draws, one train step's loss and the gradients agree with
    the JAX CompiledModel's in f32 (rtol 1e-5; gradients to 1e-4 relative
    L2, the key bias `bk` left out: its gradient is rounding noise). What
    still raises is what raises in JAX: `impl="flash"` with dropout."""
    from flexflow_tpu.losses import compute_loss as jcompute_loss

    from flexflow_tpu_torch import random as ff_random

    jcm, pcm, jkey = _dropout_pair(fusion)
    inputs, labels = _small_batch()
    pkey = ff_random.key(1)
    _, _, _, g = pcm.value_and_grads(pcm.params, pcm.state, inputs, labels,
                                     pkey)

    def jloss(p):
        outs, _ = jcm.forward_fn(p, jcm.state, [jnp.asarray(x) for x in inputs],
                                 True, jkey)
        return jcompute_loss(jcm.loss_type, outs[0].astype(jnp.float32),
                             jnp.asarray(labels))
    jg = jax.device_get(jax.jit(jax.grad(jloss))(jcm.params))
    for layer, ws in g.items():
        for w, t in ws.items():
            want = np.asarray(jg[layer][w])
            if w != ZERO_GRAD:
                assert (np.linalg.norm(t.numpy() - want)
                        <= 1e-4 * np.linalg.norm(want)), (layer, w)
    (jcm.params, jcm.opt_state, jcm.state, jl, _) = jcm.train_step(
        jcm.params, jcm.opt_state, jcm.state, inputs, labels, jkey)
    (pcm.params, pcm.opt_state, pcm.state, pl, _) = pcm.train_step(
        pcm.params, pcm.opt_state, pcm.state, inputs, labels, pkey)
    assert np.isfinite(float(pl))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    jcm, pcm, jkey = _dropout_pair(fusion, impl="flash")
    x = np.random.default_rng(2).standard_normal((2, 16, 32)).astype(
        np.float32)
    with pytest.raises(NotImplementedError) as je:
        jcm.train_step(jcm.params, jcm.opt_state, jcm.state, [x], labels,
                       jkey)
    with pytest.raises(NotImplementedError) as pe:
        pcm.train_step(pcm.params, pcm.opt_state, pcm.state, [x], labels,
                       pkey)
    assert str(pe.value) == str(je.value)


def test_weights_evaluate_and_forward():
    """get_weight/set_weight round-trip through the f32 master weights;
    set_weight replaces the tensor; evaluate and forward run in inference
    mode; with accum_steps 2 the train step refuses a batch without the
    leading (2, ...) microbatch dim."""
    m = _small_model()
    cm = m.compile(AdamOptimizer(), "sparse_categorical_crossentropy",
                   ["accuracy"], device="cpu")
    cm.init(seed=0)
    w = m.get_weight("lm_head")
    assert w.dtype == np.float32 and w.shape == (32, 64)
    old = cm.params["lm_head"]["kernel"]
    m.set_weight("lm_head", "kernel", w * 2)
    assert cm.params["lm_head"]["kernel"] is not old
    np.testing.assert_array_equal(m.get_weight("lm_head"), w * 2)
    with pytest.raises(ValueError, match="shape"):
        m.set_weight("lm_head", "kernel", w[:3])
    inputs, labels = _small_batch()
    out = m.forward(*inputs)
    assert out.shape == (2, 16, 64) and not out.requires_grad
    res = m.eval(inputs, labels)
    assert set(res) >= {"loss", "accuracy"} and np.isfinite(res["loss"])
    acm = _small_model(accum_steps=2).compile(AdamOptimizer(), device="cpu")
    acm.init(seed=0)
    with pytest.raises(ValueError, match="accum_steps=2"):
        acm.train_step(acm.params, acm.opt_state, acm.state, inputs, labels)
    stacked = [np.stack([x, x]) for x in inputs]
    *_, loss, _ = acm.train_step(acm.params, acm.opt_state, acm.state,
                                 stacked, np.stack([labels, labels]))
    assert bool(torch.isfinite(loss))


def test_metrics_and_deferred_sums_match_jax():
    """compute_metrics (accuracy, sparse CE, and MSE, RMSE and MAE against
    dense targets) and PerfMetrics' deferred sums, folded on the device
    every 3 updates, against the JAX package's (the same f32 device terms,
    summed on the host in float64)."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 16, 50)).astype(np.float32)
    labels = rng.integers(0, 50, size=(4, 16)).astype(np.int32)
    labels[0, :8] = logits[0, :8].argmax(-1)     # some hits
    names = ["accuracy", "sparse_categorical_crossentropy"]
    got = compute_metrics(names, torch.from_numpy(logits),
                          torch.from_numpy(labels))
    want = jcompute_metrics(names, jnp.asarray(logits), jnp.asarray(labels))
    for k in names:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    # the regression metrics against dense targets of the logits' shape
    dense = rng.standard_normal(logits.shape).astype(np.float32)
    reg = ["mean_squared_error", "root_mean_squared_error",
           "mean_absolute_error"]
    got = compute_metrics(reg, torch.from_numpy(logits),
                          torch.from_numpy(dense))
    want = jcompute_metrics(reg, jnp.asarray(logits), jnp.asarray(dense))
    for k in reg:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    pm, jpm = PerfMetrics(fold_after=3), JPerfMetrics(fold_after=3)
    for i in range(7):
        v = rng.standard_normal(2).astype(np.float32)
        pm.update_deferred(i + 1, {"a": torch.tensor(v[0]),
                                   "b": torch.tensor(v[1])})
        jpm.update_deferred(i + 1, {"a": jnp.asarray(v[0]),
                                    "b": jnp.asarray(v[1])})
    got, want = pm.summary(), jpm.summary()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_fused_optimizer_off_takes_the_same_steps():
    """`fused_optimizer="off"` runs the optimizer's own update, "auto" the
    fused update's plain version (on the CPU): the same Adam steps, up to
    the order of f32 roundings (and `bk`, held to Adam's step bound)."""
    inputs, labels = _small_batch()
    runs = []
    for mode in ("auto", "off"):
        cm = _small_model(fused_optimizer=mode).compile(
            AdamOptimizer(alpha=1e-2, weight_decay=0.01), device="cpu")
        assert (cm.fopt_plan is None) == (mode == "off")
        cm.init(seed=0)
        for _ in range(3):
            (cm.params, cm.opt_state, cm.state, _, _) = cm.train_step(
                cm.params, cm.opt_state, cm.state, inputs, labels)
        runs.append(params_to_numpy(cm.params))
    for layer, ws in runs[0].items():
        for w, a in ws.items():
            atol = 2 * 3 * 1e-2 if w == ZERO_GRAD else 1e-6
            np.testing.assert_allclose(a, runs[1][layer][w], rtol=1e-5,
                                       atol=atol, err_msg=f"{layer}.{w}")


def test_training_flags_parse_as_in_jax():
    argv = ["-b", "8", "-e", "3", "--sync-every", "4", "--accum-steps", "2",
            "--fused-loss", "off", "--fused-optimizer", "on", "--no-fusion",
            "--compute-dtype", "bfloat16"]
    got, want = FFConfig.parse_args(argv), JFFConfig.parse_args(argv)
    for field in ("batch_size", "epochs", "sync_every", "accum_steps",
                  "fused_loss", "fused_optimizer", "enable_fusion",
                  "compute_dtype"):
        assert getattr(got, field) == getattr(want, field), field
    defaults, jdefaults = FFConfig(), JFFConfig()
    for field in ("batch_size", "epochs", "sync_every", "accum_steps",
                  "fused_loss", "fused_optimizer"):
        assert getattr(defaults, field) == getattr(jdefaults, field), field
