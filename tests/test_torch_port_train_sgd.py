"""The PyTorch port's padded-vocab SGD and gradient accumulation against
the JAX package, on the CPU.

`GPT2Config.tiny()` with vocab 5000 and `vocab_pad_to=128` (an lm_head of
5120 columns, the shape of GPT-2's padded vocab) takes 20
SGD-with-momentum steps in both packages, and one `fit` epoch with
`accum_steps=2` under SGD without momentum: the fused SGD kernels' path
(`_sgd_kernel`, `_sgd_plain_kernel`) and the fused cross-entropy over
padded columns. The tolerances and the data are
tests/test_torch_port_train.py's.
"""

import importlib

import jax
import numpy as np
import pytest

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.runtime.dataloader import \
    group_microbatches as jgroup_microbatches
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.convert import (opt_state_from_jax, params_from_jax,
                                        params_to_numpy)
from flexflow_tpu_torch.kernels import fused_ce
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.runtime.dataloader import group_microbatches
from test_torch_port_train import (BATCH, LOSS_RTOL, MOMENT_REL_L2,
                                   PARAM_ATOL, PARAM_REL_L2, STEPS,
                                   ZERO_GRAD, _data, _gpt2_kw, _rel_l2)

jfused_ce = importlib.import_module("flexflow_tpu.kernels.fused_ce")


# ------------------------------------------- padded vocab, SGD, accum_steps
PAD_KW = dict(_gpt2_kw(), vocab=5000, vocab_pad_to=128)   # lm_head 5120
SGD_LR = 1e-2


def _padded_pair(dt, jopt, opt, **cfg):
    """GPT-2 tiny with its vocab of 5000 padded to 5120 lm_head columns,
    compiled in both packages with `cfg`; the port takes the JAX initial
    weights."""
    jm = JFFModel(JFFConfig(batch_size=BATCH, compute_dtype=dt,
                            mesh_shape={"data": 1}, only_data_parallel=True,
                            log_level="warning", **cfg))
    jbuild_gpt2(jm, JGPT2Config(**PAD_KW), batch=BATCH)
    jcm = jm.compile(jopt, "sparse_categorical_crossentropy", [])
    jcm.init(seed=0)
    pm = FFModel(FFConfig(batch_size=BATCH, compute_dtype=dt, **cfg))
    build_gpt2(pm, GPT2Config(**PAD_KW), batch=BATCH)
    pcm = pm.compile(opt, "sparse_categorical_crossentropy", [], device="cpu")
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))
    assert tuple(pcm.params["lm_head"]["kernel"].shape) == (256, 5120)
    return jcm, pcm


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def sgd_trained(request):
    """STEPS SGD(1e-2, momentum 0.9) train steps of the padded model on one
    batch in both packages: (dtype, jax cm, port cm, jax losses, port
    losses, calls). `calls` counts the traces of the JAX
    `fused_cross_entropy` and the port Function's forward and backward
    (their plain versions on the CPU)."""
    dt = request.param
    jcm, pcm = _padded_pair(dt, JSGDOptimizer(lr=SGD_LR, momentum=0.9),
                            SGDOptimizer(lr=SGD_LR, momentum=0.9))
    calls = {"jax": 0, "fwd": 0, "bwd": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    inputs, labels = _data(3, BATCH, vocab=PAD_KW["vocab"])
    key = jax.random.PRNGKey(0)
    jl, pl = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfused_ce, "fused_cross_entropy",
                   counting("jax", jfused_ce.fused_cross_entropy))
        mp.setattr(fused_ce, "_fwd_plain", counting("fwd", fused_ce._fwd_plain))
        mp.setattr(fused_ce, "_bwd_plain", counting("bwd", fused_ce._bwd_plain))
        for _ in range(STEPS):
            (jcm.params, jcm.opt_state, jcm.state, loss, _) = jcm.train_step(
                jcm.params, jcm.opt_state, jcm.state, inputs, labels, key)
            jl.append(float(loss))
            (pcm.params, pcm.opt_state, pcm.state, loss, _) = pcm.train_step(
                pcm.params, pcm.opt_state, pcm.state, inputs, labels)
            pl.append(float(loss))
    return dt, jcm, pcm, np.array(jl), np.array(pl), calls


def test_padded_vocab_sgd_matches_jax(sgd_trained):
    """Losses at every step, the final params and the momentum trace
    (carried across by `opt_state_from_jax`, padded lm_head included)."""
    dt, jcm, pcm, jl, pl, _ = sgd_trained
    assert np.all(np.isfinite(pl)) and pl[-1] < pl[0]
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL[dt])
    jp, pp = jax.device_get(jcm.params), params_to_numpy(pcm.params)
    for layer, ws in pp.items():
        for w, a in ws.items():
            np.testing.assert_allclose(a, np.asarray(jp[layer][w], np.float32),
                                       atol=PARAM_ATOL[dt],
                                       err_msg=f"{layer}.{w}")
    assert _rel_l2(pp, jp) <= PARAM_REL_L2[dt]
    carried = opt_state_from_jax(jax.device_get(jcm.opt_state))
    assert set(carried) == set(pcm.opt_state) == {"trace"}
    assert tuple(carried["trace"]["lm_head"]["kernel"].shape) == (256, 5120)
    assert _rel_l2(params_to_numpy(pcm.opt_state["trace"]),
                   params_to_numpy(carried["trace"]),
                   skip=ZERO_GRAD) <= MOMENT_REL_L2[dt]


def test_padded_vocab_takes_the_fused_ce_path(sgd_trained):
    """Both packages fused the loss over the 5120 padded columns: the JAX
    `fused_cross_entropy` was traced, and the port's Function ran its
    forward and backward once per step (plain versions, no launch)."""
    _, _, _, _, _, calls = sgd_trained
    assert calls["jax"] > 0
    assert calls["fwd"] == calls["bwd"] == STEPS
    assert (fused_ce.launches_fwd, fused_ce.launches_bwd) == (0, 0)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_accum_fit_epoch_matches_jax(dt):
    """`FFConfig(accum_steps=2)` in both packages, SGD(1e-2) without
    momentum: one fit epoch over 4 batches is 2 updates of 2 microbatches
    each, with the same batches, loss and params, and an empty SGD state
    on both sides; `fit(accum_steps=1)` overrides the config per call."""
    jcm, pcm = _padded_pair(dt, JSGDOptimizer(lr=SGD_LR),
                            SGDOptimizer(lr=SGD_LR), accum_steps=2)
    x, y = _data(4, 4 * BATCH, vocab=PAD_KW["vocab"])
    jh = jcm.fit(x, y, epochs=1, verbose=False)
    ph = pcm.fit(x, y, epochs=1, verbose=False, sync_every=0)
    assert pcm.step_stats == {"dispatches": 2, "host_syncs": 0,
                              "barriers": 0, "fused_steps": 0}
    assert ph[0]["dispatches"] == 2.0 and ph[0]["samples"] == 4 * BATCH
    np.testing.assert_allclose(ph[0]["loss"], jh[0]["loss"],
                               rtol=LOSS_RTOL[dt])
    jp, pp = jax.device_get(jcm.params), params_to_numpy(pcm.params)
    for layer, ws in pp.items():
        for w, a in ws.items():
            np.testing.assert_allclose(a, np.asarray(jp[layer][w], np.float32),
                                       atol=PARAM_ATOL[dt],
                                       err_msg=f"{layer}.{w}")
    assert opt_state_from_jax(jax.device_get(jcm.opt_state)) == {}
    assert pcm.opt_state == {}
    pcm.fit(x, y, epochs=1, verbose=False, sync_every=0, accum_steps=1)
    assert pcm.step_stats == {"dispatches": 4, "host_syncs": 0,
                              "barriers": 0, "fused_steps": 0}


def test_group_microbatches_matches_jax():
    """N consecutive batches stack into (N, ...); a trailing short group
    and a group broken by a batch of another shape are dropped, as in
    the JAX grouper."""
    rng = np.random.default_rng(6)
    shapes = [4, 4, 4, 3, 4, 4, 4, 4, 4]
    batches = [([rng.standard_normal((b, 5)), rng.standard_normal((b, 2))],
                rng.integers(0, 9, size=(b,))) for b in shapes]
    for n in (1, 2, 3):
        got = list(group_microbatches(iter(batches), n))
        want = list(jgroup_microbatches(iter(batches), n))
        assert len(got) == len(want)
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gy, wy)
            assert len(gx) == len(wx) == 2
            for a, b in zip(gx, wx):
                np.testing.assert_array_equal(a, b)
    assert [np.shape(g[1]) for g in group_microbatches(iter(batches), 2)] == \
        [(2, 4)] * 3
