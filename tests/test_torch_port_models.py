"""The port's ResNet, ResNeXt, BERT and DLRM against the JAX package's, on
the CPU.

Each model is built by both packages' builders at a small size, compiled
in f32 on one device, and the port takes the JAX CompiledModel's initial
weights (`params_from_jax`) and state (`state_from_jax`). Both take
STEPS `train_step`s on one batch: the losses, the final params and the
batch-norm running stats must agree. The sizes are `bench.py`'s CPU
sizes (ResNeXt b4, 32x32, width 8, groups 4, 10 classes; BERT b2, seq
64, vocab 2048, d128, 2 heads, 2 layers, d_ff 256, here at dropout 0;
DLRM b256 with 4 tables of 10k rows, MSE on f32 labels) and, for ResNet,
a stem of width 8 and two bottleneck blocks (`build_resnet_block`) under
SGD with momentum and weight decay, which also runs a `fit` epoch with
`accum_steps=2` and `evaluate` against JAX.

Also: batch-norm state bitwise equal with remat "full" on and off and
across a checkpoint round trip; and ResNet-50, ResNeXt-50, BERT-base and
DLRM at full size built (not compiled) with the JAX package's layers,
shapes, params and flops. The ResNeXt cases (3 steps, and its search as
tests/test_models.py searches it) are in tests/test_torch_port_resnext.py,
which takes its helpers from here.
"""

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu.models as jmodels
import flexflow_tpu.models.bert as jbert
import flexflow_tpu_torch.models as pmodels
from flexflow_tpu import AdamOptimizer as JAdamOptimizer
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.ops.registry import get_op_def as jget_op_def
from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,
                                SGDOptimizer)
from flexflow_tpu_torch.convert import (params_from_jax, params_to_numpy,
                                        state_from_jax)
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.tensor import Tensor
from flexflow_tpu_torch.ops.registry import get_op_def

STEPS, LR = 3, 1e-4
# the test_torch_port_train.py tolerances in f32: the same f32 math in
# another summation order; Adam's step bound 2 * STEPS * LR where the
# gradient is zero in exact arithmetic (BERT's key bias `bk`)
LOSS_RTOL, PARAM_ATOL, PARAM_REL_L2 = 1e-4, 2e-5, 2e-5
ZERO_GRAD_ATOL = 2 * STEPS * LR
STATE_ATOL = 1e-5
# ResNet: Goyal et al.'s SGD at batch 8 (0.1 x b / 256 rounds to 0.0031;
# 0.01 moves the params more per step), momentum 0.9, weight decay 1e-4
SGD = dict(lr=0.01, momentum=0.9, weight_decay=1e-4)


@pytest.fixture(autouse=True)
def _guids_in_step():
    """Leave both packages' layer and tensor guid counters equal after each
    test (they start a layer's default name): this file builds models in
    one package alone, and other files in the process build unnamed
    layers in both and compare their names."""
    yield
    from flexflow_tpu.core.layer import Layer as JLayer
    from flexflow_tpu.core.tensor import Tensor as JTensor

    for a, b in ((JLayer, Layer), (JTensor, Tensor)):
        a._next_guid[0] = b._next_guid[0] = max(a._next_guid[0],
                                                b._next_guid[0])


def _side(m):
    return jmodels if isinstance(m, JFFModel) else pmodels


def tiny_resnet(m, batch=8, hw=16, classes=10):
    """A stem of width 8 (conv, BN with relu, max pool) and two bottleneck
    blocks, the first projecting, the second strided, then the global
    average pool and the classifier: ResNet-50's ops at CPU size."""
    zoo = _side(m)
    x = m.create_tensor([batch, 3, hw, hw], name="image")
    t = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="stem", use_bias=False)
    t = m.batch_norm(t, relu=True, name="stem_bn")
    t = m.pool2d(t, 3, 3, 1, 1, 1, 1, name="stem_pool")
    t = zoo.build_resnet_block(m, t, 4, 1, "s0b0", project=True)
    t = zoo.build_resnet_block(m, t, 4, 2, "s1b0", project=True)
    t = m.mean(t, axes=[2, 3], name="gap")
    m.dense(t, classes, name="fc")


def tiny_resnext(m, has_residual=False):
    _side(m).build_resnext50(m, batch=4, in_hw=32, classes=10, groups=4,
                             width=8, has_residual=has_residual)


def tiny_bert(m):
    kw = dict(batch=2, seq=64, vocab=2048, d_model=128, heads=2, layers=2,
              d_ff=256)
    if isinstance(m, JFFModel):
        # the JAX build has no dropout knob: its blocks take
        # transformer_block's default of 0.1, set to 0 here
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jbert, "transformer_block",
                       lambda *a, **k: jmodels.transformer.transformer_block(
                           *a, **k, dropout=0.0))
            jbert.build_bert(m, **kw)
    else:
        pmodels.build_bert(m, dropout=0.0, **kw)


DLRM_TABLES = (10_000,) * 4


def tiny_dlrm(m):
    _side(m).build_dlrm(m, batch=256, embedding_tables=DLRM_TABLES,
                        embedding_dim=64)


def _data(which, seed, n=None):
    """Inputs and labels as bench.py draws them."""
    rng = np.random.default_rng(seed)
    if which in ("resnet", "resnext"):
        n = n or (8 if which == "resnet" else 4)
        hw = 16 if which == "resnet" else 32
        x = rng.normal(size=(n, 3, hw, hw), scale=0.5).astype(np.float32)
        return [x], rng.integers(0, 10, size=(n,)).astype(np.int32)
    if which == "bert":
        ids = rng.integers(0, 2048, size=(2, 64)).astype(np.int32)
        pos = np.tile(np.arange(64, dtype=np.int32), (2, 1))
        return [ids, pos], rng.integers(0, 2048, size=(2, 64)).astype(np.int32)
    dense = rng.normal(size=(256, 13)).astype(np.float32)
    sparse = [rng.integers(0, t, size=(256, 1)).astype(np.int32)
              for t in DLRM_TABLES]
    return [dense] + sparse, rng.uniform(size=(256, 1)).astype(np.float32)


CASES = {
    "resnet": (tiny_resnet, lambda: JSGDOptimizer(**SGD),
               lambda: SGDOptimizer(**SGD), "sparse_categorical_crossentropy",
               ["accuracy"]),
    "resnext": (tiny_resnext, lambda: JAdamOptimizer(alpha=LR),
                lambda: AdamOptimizer(alpha=LR),
                "sparse_categorical_crossentropy", []),
    "bert": (tiny_bert, lambda: JAdamOptimizer(alpha=LR),
             lambda: AdamOptimizer(alpha=LR),
             "sparse_categorical_crossentropy", []),
    "dlrm": (tiny_dlrm, lambda: JAdamOptimizer(alpha=LR),
             lambda: AdamOptimizer(alpha=LR), "mean_squared_error", []),
}


def _compile_pair(which, **cfg):
    build, jopt, popt, loss, metrics = CASES[which]
    jm = JFFModel(JFFConfig(compute_dtype="float32", mesh_shape={"data": 1},
                            only_data_parallel=True, log_level="warning",
                            **cfg))
    build(jm)
    jcm = jm.compile(jopt(), loss, metrics)
    jcm.init(seed=0)
    pm = FFModel(FFConfig(compute_dtype="float32", **cfg))
    build(pm)
    pcm = pm.compile(popt(), loss, metrics, device="cpu")
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))
    pcm.state = state_from_jax(jax.device_get(jcm.state))
    return jcm, pcm


_TRAINED = {}


def _trained(which):
    """(jax cm, port cm, jax losses, port losses) after STEPS train steps
    on one batch, made once per model."""
    if which not in _TRAINED:
        _TRAINED[which] = _train(which)
    return _TRAINED[which]


def _train(which):
    jcm, pcm = _compile_pair(which)
    inputs, labels = _data(which, 0)
    key = jax.random.PRNGKey(0)
    jl, pl = [], []
    for _ in range(STEPS):
        (jcm.params, jcm.opt_state, jcm.state, loss, _) = jcm.train_step(
            jcm.params, jcm.opt_state, jcm.state, inputs, labels, key)
        jl.append(float(loss))
        (pcm.params, pcm.opt_state, pcm.state, loss, _) = pcm.train_step(
            pcm.params, pcm.opt_state, pcm.state, inputs, labels)
        pl.append(float(loss))
    return jcm, pcm, np.array(jl), np.array(pl)


# ResNeXt's JAX compile alone takes ~20 s: its cases are in
# tests/test_torch_port_resnext.py, to keep each file near 30 s
HERE = ["bert", "dlrm", "resnet"]


@pytest.mark.parametrize("which", HERE)
def test_losses_match_jax_at_every_step(which):
    _, _, jl, pl = _trained(which)
    assert np.all(np.isfinite(pl)) and pl[-1] < pl[0], pl
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)


def _rel_l2(got, want) -> float:
    keys = [(l, w) for l in got for w in got[l]]
    num = sum(float(((got[l][w] - np.asarray(want[l][w], np.float32)) ** 2)
                    .sum()) for l, w in keys)
    den = sum(float((np.asarray(want[l][w], np.float32) ** 2).sum())
              for l, w in keys)
    return (num / den) ** 0.5


def _params_match(jcm, pcm):
    jp, pp = jax.device_get(jcm.params), params_to_numpy(pcm.params)
    assert sorted(pp) == sorted(jp)
    for layer, ws in pp.items():
        for w, a in ws.items():
            b = np.asarray(jp[layer][w], np.float32)
            assert a.shape == b.shape
            atol = ZERO_GRAD_ATOL if w == "bk" else PARAM_ATOL
            np.testing.assert_allclose(a, b, atol=atol, err_msg=f"{layer}.{w}")
    assert _rel_l2(pp, jp) <= PARAM_REL_L2


def _state_match(jcm, pcm):
    js = jax.device_get(jcm.state)
    assert sorted(pcm.state) == sorted(js)
    for k, v in pcm.state.items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), np.asarray(js[k]),
                                   atol=STATE_ATOL, err_msg=k)


@pytest.mark.parametrize("which", HERE)
def test_final_params_and_state_match_jax(which):
    jcm, pcm, _, _ = _trained(which)
    _params_match(jcm, pcm)
    _state_match(jcm, pcm)
    n_bn = sum(l.op_type.value == "batch_norm" for l in pcm.model.layers)
    assert len(pcm.state) == 2 * n_bn
    assert n_bn == (9 if which == "resnet" else 0)


def test_resnet_fit_accum_and_evaluate_match_jax():
    """From the trained state: one fit epoch of 4 batches with
    accum_steps=2 (2 updates, the BN state fed from microbatch to
    microbatch) and `evaluate` in inference mode (the running stats
    normalize), both against JAX."""
    jcm, pcm, _, _ = _trained("resnet")
    x, y = _data("resnet", 1, n=32)
    jh = jcm.fit(x, y, epochs=1, verbose=False, accum_steps=2)
    ph = pcm.fit(x, y, epochs=1, verbose=False, sync_every=0, accum_steps=2)
    assert pcm.step_stats == {"dispatches": 2, "host_syncs": 0,
                              "barriers": 0, "fused_steps": 0}
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(ph[0][k], jh[0][k], rtol=LOSS_RTOL,
                                   err_msg=k)
    _params_match(jcm, pcm)
    _state_match(jcm, pcm)
    je = jcm.evaluate(x, y)
    pe = pcm.evaluate(x, y)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(pe[k], je[k], rtol=LOSS_RTOL, err_msg=k)
    # inference reads the stats: zeroing them changes the loss
    saved = pcm.state
    pcm.state = {}
    assert abs(pcm.evaluate(x, y)["loss"] - pe["loss"]) > 1e-3
    pcm.state = saved


def test_dlrm_takes_float_labels():
    """DLRM's labels are (b, 1) f32, and its MSE reads them as f32: the
    loss is the mean square of the sigmoid output minus the labels."""
    _, pcm, _, _ = _trained("dlrm")
    inputs, labels = _data("dlrm", 0)
    assert labels.dtype == np.float32 and labels.shape == (256, 1)
    loss, logits, _, _ = pcm.value_and_grads(pcm.params, pcm.state, inputs,
                                             labels)
    want = float(((logits.float().numpy() - labels) ** 2).mean())
    np.testing.assert_allclose(float(loss), want, rtol=1e-6)
    assert logits.shape == (256, 1) and float(logits.min()) >= 0.0


# ------------------------------------------------------ BN state and remat
def _port_resnet(remat=False, seed=3):
    Layer._next_guid[0], Tensor._next_guid[0] = 100, 1000
    m = FFModel(FFConfig(compute_dtype="float32", remat=remat))
    tiny_resnet(m)
    cm = m.compile(SGDOptimizer(**SGD), "sparse_categorical_crossentropy",
                   [], device="cpu")
    cm.init(seed=seed)
    return cm


def _steps(cm, n, seed=2):
    inputs, labels = _data("resnet", seed)
    losses = []
    for _ in range(n):
        (cm.params, cm.opt_state, cm.state, loss, _) = cm.train_step(
            cm.params, cm.opt_state, cm.state, inputs, labels)
        losses.append(loss)
    return torch.stack(losses)


def _bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_bn_state_bitwise_with_remat_full_on_and_off():
    """The checkpointed BN forward runs twice; its recompute's state is
    dropped, so the stats, losses and params equal remat off's bitwise."""
    off, full = _port_resnet(), _port_resnet(remat=True)
    assert set(full.strategy.remat.values()) == {"full"}
    assert not off.strategy.remat
    lo, lf = _steps(off, 2), _steps(full, 2)
    assert torch.equal(lo, lf)
    assert len(off.state) == 18
    _bitwise(off.state, full.state)
    for layer, ws in off.params.items():
        _bitwise(ws, full.params[layer])


def test_bn_state_survives_a_checkpoint_round_trip(tmp_path):
    cm = _port_resnet()
    _steps(cm, 2)
    cm.save_checkpoint(str(tmp_path / "ck"), block=True)
    back = _port_resnet(seed=9)
    back.load_checkpoint(str(tmp_path / "ck"))
    _bitwise(cm.state, back.state)
    assert torch.equal(_steps(cm, 1, seed=4), _steps(back, 1, seed=4))
    _bitwise(cm.state, back.state)


# --------------------------------------------------- full-size builds
FULL = {
    "resnet50": lambda m: _side(m).build_resnet50(m),
    "resnext50": lambda m: _side(m).build_resnext50(m),
    "bert_base": lambda m: _side(m).build_bert(m),
    "dlrm": lambda m: _side(m).build_dlrm(m, batch=4096),
}
# parameter counts of the JAX builds
PARAMS = {"resnet50": 25_557_032, "resnext50": 22_222_056,
          "bert_base": 132_361_530, "dlrm": 51_561_281}


@pytest.mark.parametrize("which", sorted(FULL))
def test_full_size_builds_match_jax(which):
    """Layer for layer: names, op types, params, output specs, weight
    specs and forward flops; nothing is compiled."""
    jm, pm = JFFModel(JFFConfig()), FFModel(FFConfig())
    FULL[which](jm)
    FULL[which](pm)
    assert len(pm.layers) == len(jm.layers)
    named = 0
    for jl, pl in zip(jm.layers, pm.layers):
        assert pl.op_type.value == jl.op_type.value
        assert pl.params == jl.params, pl.name
        if not pl.name.startswith(f"{pl.op_type.value}_"):
            assert pl.name == jl.name
            named += 1
        assert [(o.shape, o.dtype.value) for o in pl.outputs] == \
            [(o.shape, o.dtype.value) for o in jl.outputs]
        assert {w: (s.shape, s.dtype.value)
                for w, s in pl.weight_specs.items()} == \
            {w: (s.shape, s.dtype.value) for w, s in jl.weight_specs.items()}
        assert get_op_def(pl.op_type).flop_count(pl) == \
            jget_op_def(jl.op_type).flop_count(jl), pl.name
    assert named >= sum(bool(l.weight_specs) for l in pm.layers)
    count = sum(s.num_elements for l in pm.layers
                for s in l.weight_specs.values())
    assert count == PARAMS[which] == sum(
        s.num_elements for l in jm.layers for s in l.weight_specs.values())
