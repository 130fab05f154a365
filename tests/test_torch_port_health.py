"""Run health in the PyTorch port (flexflow_tpu_torch/health.py) against
the JAX package's (flexflow_tpu/health.py), on the CPU: the goodput meter,
the sentinel detectors and scalars, the watermark comparison, the SLO
merge and the scaling signal on equal inputs; and GPT-2 fits in both
packages: the grad norm the sentinels read at each sync (f32, 1e-4
relative), `health/nonfinite` halting at the same step with the same
durable checkpoint (eager and K = 2), the resumed fit finite, and with
every item of the layer off the fit bitwise as with it on, in the same
counts.

The fits are GPT-2 at 2 layers, d 64, dropout 0, from the JAX model's
initial weights (`convert.params_from_jax`).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu.health as jhealth
import flexflow_tpu.runtime.resilience as jres
import flexflow_tpu_torch.health as phealth
import flexflow_tpu_torch.runtime.resilience as pres
from flexflow_tpu import AdamOptimizer as JAdamOptimizer
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import telemetry as jtel
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.runtime import faults as jfaults
from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
from flexflow_tpu_torch import telemetry as ptel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.tensor import Tensor
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.runtime import faults as pfaults

GPT = dict(vocab=256, seq=32, d_model=64, heads=2, layers=2, dropout=0.0)
BATCH = 4


@pytest.fixture(autouse=True)
def _clean():
    for f in (jfaults, pfaults):
        f.clear()
    yield
    for f in (jfaults, pfaults):
        f.clear()
    jtel.shutdown()
    ptel.shutdown()
    from flexflow_tpu.core.layer import Layer as JLayer
    from flexflow_tpu.core.tensor import Tensor as JTensor

    for a, b in ((JLayer, Layer), (JTensor, Tensor)):
        a._next_guid[0] = b._next_guid[0] = max(a._next_guid[0],
                                                b._next_guid[0])


# ---------------------------------------------------------------- goodput
def test_goodput_meter_matches_jax():
    """The same credited buckets and walls give JAX's records, report and
    lines; the lap cursor charges the interval to its bucket."""
    assert phealth.BUCKETS == jhealth.BUCKETS
    assert phealth.PRODUCTIVE == jhealth.PRODUCTIVE
    recs = []
    for h in (jhealth, phealth):
        gm = h.GoodputMeter()
        gm.add("dispatch", 0.8)
        gm.add("checkpoint", 0.1)
        r0 = gm.epoch_end(1.0, epoch=0, bubble_frac=0.25)
        gm.add("prefetch_wait", 0.3)
        gm.add("host_sync", 0.2)
        r1 = gm.epoch_end(0.6, epoch=1)
        rep = gm.report()
        recs.append((r0, r1, rep, h.format_goodput(rep)))
    assert recs[1] == recs[0]
    r0 = recs[1][0]
    assert r0["bubble_s"] == pytest.approx(0.2)
    assert r0["residual_s"] == pytest.approx(0.1)
    assert r0["goodput"] == pytest.approx(0.6)
    gm = phealth.GoodputMeter()
    gm.tick()
    time.sleep(0.01)
    gm.lap("dispatch")
    rec = gm.epoch_end(0.05, epoch=0)
    assert rec["buckets"]["dispatch"] >= 0.009
    assert phealth.format_goodput({}) == jhealth.format_goodput({})


# -------------------------------------------------------------- sentinels
def test_sentinel_state_matches_jax():
    """Grad-norm spikes against the EMA, loss spikes against the last
    window, NaN and a tripped flag fatal: JAX's events and status."""
    seq = [(1, 1.0, 1.0, 0.0), (2, 1.1, 50.0, 0.0), (3, 100.0, 1.0, 0.0),
           (4, 1.0, float("nan"), 0.0), (5, float("nan"), 1.0, 1.0),
           (6, 1.0, 2.0, 0.0)]
    out = []
    for h in (jhealth, phealth):
        st = h.SentinelState()
        verdicts = [st.observe(s, loss_mean=lm, grad_norm=g, nonfinite=nf)
                    for s, lm, g, nf in seq]
        out.append((verdicts, [(e["kind"], e["step"]) for e in st.events],
                    st.status()))
    assert out[1] == out[0]
    assert out[1][0] == [None, None, None, "nonfinite", "nonfinite", None]
    assert (phealth.GRAD_SPIKE_RATIO, phealth.LOSS_SPIKE_RATIO) == (10.0, 4.0)


@pytest.mark.parametrize("loss,gn", [(1.5, 2.0), (np.nan, 2.0),
                                     (1.0, np.inf), (3.0, 0.0)])
def test_sentinel_metrics_match_jax(loss, gn):
    j = jhealth.sentinel_metrics(jnp.float32(loss), jnp.float32(gn))
    p = phealth.sentinel_metrics(torch.tensor(loss, dtype=torch.float32),
                                 torch.tensor(gn, dtype=torch.float32))
    assert set(p) == set(j) == set(phealth.SENTINEL_KEYS)
    for k in j:
        assert p[k].dtype == torch.float32 and p[k].dim() == 0
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]))


def test_grad_global_norm_matches_optax():
    import optax

    rng = np.random.default_rng(1)
    tree = {"a": {"k": rng.normal(size=(5, 7)).astype(np.float32),
                  "b": rng.normal(size=(7,)).astype(np.float32)},
            "c": {"k": rng.normal(size=(3, 2, 4)).astype(np.float32)}}
    want = float(optax.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                          tree)))
    got = phealth.grad_global_norm({l: {w: torch.from_numpy(a)
                                        for w, a in ws.items()}
                                    for l, ws in tree.items()})
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# ------------------------------------------------------------- watermarks
def test_watermarks_match_jax():
    for peak, pred in ((300, 100), (120, 100), (None, 100), (200, None)):
        assert phealth.watermark_drift(peak, pred) == \
            jhealth.watermark_drift(peak, pred)
    assert phealth.WATERMARK_WARN_RATIO == jhealth.WATERMARK_WARN_RATIO
    params = {"l": {"k": torch.zeros(4, 8), "b": torch.zeros(8)}}
    moments = {"mu": {"l": {"k": torch.zeros(4, 8)}}, "count": 3}
    got = phealth.device_watermarks((params, moments), "cpu")
    assert got == {"cpu": {"live": 4 * (32 + 8 + 32),
                           "peak": 4 * (32 + 8 + 32)}}
    wt = phealth.WatermarkTracker()
    wt.sample("init", (params, moments), "cpu")
    rep = wt.report(100)
    assert rep["samples"] == 1 and rep["warn"] and rep["ratio"] == 2.88
    wm = dict(rep)
    assert phealth.format_health({"nonfinite_steps": 1, "grad_spikes": 2,
                                  "loss_spikes": 0}, wm) == \
        jhealth.format_health({"nonfinite_steps": 1, "grad_spikes": 2,
                               "loss_spikes": 0}, wm)


def test_slo_merge_and_scaling_signal_match_jax():
    spec = "ttft_p99_ms=20,availability=0.9"
    trackers = []
    for h in (jhealth, phealth):
        ts = [h.SLOTracker(h.parse_slo(spec), max_events=6)
              for _ in range(2)]
        for i in range(10):
            ts[i % 2].observe({"outcome": "done" if i % 3 else "shed",
                               "ttft_s": 0.005 * i}, now_s=float(i))
        merged = h.merge_slo_trackers(ts)
        rep = merged.report(now_s=10.0)
        trackers.append((rep, h.scaling_signal(rep)))
    assert trackers[1] == trackers[0]
    assert phealth.scaling_signal({}) == jhealth.scaling_signal({})


# ------------------------------------------------------------------ fits
@pytest.fixture(scope="module")
def jax_gpt2():
    """One JAX compile for the file (its jitted steps are kept; each test
    initializes it again and sets its own config)."""
    jm = JFFModel(JFFConfig(mesh_shape={"data": 1}, log_level="warning",
                            batch_size=BATCH, seed=3, retry_base_delay=0.0))
    jbuild_gpt2(jm, JGPT2Config(**GPT), batch=BATCH)
    jcm = jm.compile(JAdamOptimizer(alpha=1e-3),
                     "sparse_categorical_crossentropy", [])
    yield jcm
    jcm.cfg.halt_on_nonfinite = False


def _gpt2_pair(jcm, **cfg):
    """JAX's model initialized again with `cfg` set on its config, and the
    port's compiled with `cfg` from JAX's weights."""
    for k, v in cfg.items():
        setattr(jcm.cfg, k, v)
    jcm.init(seed=0)
    params = params_from_jax(jax.device_get(jcm.params))
    return jcm, _port(params, batch_size=BATCH, seed=3, retry_base_delay=0.0,
                      **cfg), params


def _port(params, **kw):
    pm = FFModel(FFConfig(**kw))
    build_gpt2(pm, GPT2Config(**GPT), batch=BATCH)
    pcm = pm.compile(AdamOptimizer(alpha=1e-3),
                     "sparse_categorical_crossentropy", [], device="cpu")
    pcm.load_params(params)
    return pcm


def gpt2_data(n=32, seed=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, GPT["vocab"], size=(n, GPT["seq"])).astype(np.int32)
    pos = np.broadcast_to(np.arange(GPT["seq"], dtype=np.int32),
                          ids.shape).copy()
    y = rng.integers(0, GPT["vocab"], size=ids.shape).astype(np.int32)
    return [ids, pos], y


def _recording(monkeypatch, h):
    seen = []
    orig = h.SentinelState.observe

    def observe(self, step, loss_mean=None, grad_norm=None, nonfinite=0.0):
        seen.append((step, loss_mean, grad_norm, nonfinite))
        return orig(self, step, loss_mean=loss_mean, grad_norm=grad_norm,
                    nonfinite=nonfinite)
    monkeypatch.setattr(h.SentinelState, "observe", observe)
    return seen


def _params(cm):
    return {l: {w: t.detach().clone() for w, t in ws.items()}
            for l, ws in cm.params.items()}


def test_sentinels_read_jax_grad_norms_and_change_nothing(jax_gpt2,
                                                          monkeypatch,
                                                          tmp_path):
    """Sentinels on (the default) with a sync every 2 updates: at each
    sync the window's mean grad norm and loss are JAX's (1e-4 relative),
    nothing is flagged, and the history carries no reserved key. With
    the sentinels and telemetry off, and with both on, the port's fit
    gives the same step_stats and bitwise the same params and losses."""
    jseen = _recording(monkeypatch, jhealth)
    pseen = _recording(monkeypatch, phealth)
    jcm, pcm, params = _gpt2_pair(jax_gpt2, halt_on_nonfinite=False)
    x, y = gpt2_data(16)
    kw = dict(epochs=2, verbose=False, sync_every=2)
    jcm.fit(x, y, **kw)
    ph = pcm.fit(x, y, **kw)
    assert pcm.step_stats == jcm.step_stats == {
        "dispatches": 8, "host_syncs": 4, "barriers": 0, "fused_steps": 0}
    assert [s[0] for s in pseen] == [s[0] for s in jseen]
    assert len(pseen) == 2 * (2 + 1)       # 2 syncs and the end an epoch
    for (_, pl, pg, pn), (_, jl, jg, jn) in zip(pseen, jseen):
        if jg is None:
            assert pg is None
            continue
        np.testing.assert_allclose(pg, jg, rtol=1e-4)
        assert pn == jn == 0.0
        if jl is not None:
            np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pcm.health_report()["sentinels"]["nonfinite_steps"] == 0
    assert not any(k.startswith("health/") for e in ph for k in e)
    # the same fit with the whole layer off, and with telemetry on too:
    # bitwise, the same counts
    on_p = _params(pcm)
    for extra in (dict(health_sentinels=False),
                  dict(telemetry_dir=str(tmp_path / "tel"))):
        other = _port(params, batch_size=BATCH, seed=3, **extra)
        oh = other.fit(x, y, **kw)
        assert other.step_stats == pcm.step_stats
        assert (other._sentinels is None) == ("health_sentinels" in extra)
        assert [e["loss"] for e in oh] == [e["loss"] for e in ph]
        other_p = _params(other)
        assert all(torch.equal(on_p[l][w], other_p[l][w])
                   for l in on_p for w in on_p[l])
        ptel.shutdown()


@pytest.mark.parametrize("k,at,halt,ckpt", [(1, 3, 3, 2), (2, 3, 4, 2)])
def test_nonfinite_halts_at_jax_step_and_resumes(jax_gpt2, tmp_path, k, at,
                                                 halt, ckpt):
    """health/nonfinite@at NaN-poisons the first param before step `at`;
    with a sync every update the next sync's window trips the sentinel,
    and halt_on_nonfinite raises NonFiniteError at step `halt` (the end of
    the dispatch covering `at`) naming the last durable checkpoint (step
    `ckpt`, taken every 2 updates), in both packages. A fit resumed from
    it has finite losses."""
    roots = [str(tmp_path / "j"), str(tmp_path / "p")]
    jcm, pcm, params = _gpt2_pair(jax_gpt2, halt_on_nonfinite=True)
    x, y = gpt2_data()
    out = []
    for f, res, cm, root in ((jfaults, jres, jcm, roots[0]),
                             (pfaults, pres, pcm, roots[1])):
        f.configure(f"health/nonfinite@{at}")
        with pytest.raises(Exception) as ei:
            cm.fit(x, y, epochs=1, verbose=False, sync_every=1,
                   steps_per_dispatch=k, checkpoint_dir=root,
                   checkpoint_every_steps=2)
        f.clear()
        err = ei.value
        man = res.load_manifest(err.checkpoint)
        out.append((type(err).__name__, err.step,
                    err.checkpoint == res.latest_checkpoint(root),
                    man["step"], man["progress"]["step_in_epoch"]))
    assert out[1] == out[0] == ("NonFiniteError", halt, True, ckpt, ckpt)
    assert pcm.health_report()["sentinels"]["nonfinite_steps"] == 1
    resumed = _port(params, batch_size=BATCH, seed=3)
    hist = resumed.fit(x, y, epochs=1, verbose=False, resume="auto",
                       checkpoint_dir=roots[1])
    assert np.isfinite(hist[0]["loss"])


def test_goodput_and_watermarks_after_fit(tmp_path):
    """The buckets tile the fit's wall (>= 95% accounted), goodput lands
    in each epoch's history, and the watermarks hold init plus one sample
    an epoch against the predicted weight state, under it on the CPU."""
    pm = FFModel(FFConfig(batch_size=BATCH, seed=3))
    build_gpt2(pm, GPT2Config(**GPT), batch=BATCH)
    pcm = pm.compile(AdamOptimizer(alpha=1e-3),
                     "sparse_categorical_crossentropy", [], device="cpu")
    pcm.init(seed=0)
    x, y = gpt2_data(16)
    hist = pcm.fit(x, y, epochs=2, verbose=False)
    rep = pcm.goodput_report()
    assert rep["epochs"] == 2 and rep["accounted_frac"] >= 0.95
    wall = sum(h["epoch_time_s"] for h in hist)
    assert rep["wall_s"] == pytest.approx(wall, rel=1e-6)
    assert rep["buckets"]["dispatch"] > 0.0
    assert all(0.0 <= h["goodput"] <= 1.0 for h in hist)
    wm = pcm.health_report()["watermarks"]
    assert wm["samples"] == 3 and wm["predicted"] == \
        "predicted_weight_state_bytes"
    assert wm["ratio"] is not None and not wm["warn"]


def test_recompile_trigger_drops_to_one_step_and_rebuilds():
    """A registered recompile trigger makes fit take one step a dispatch
    with a host sync after each, as in JAX; when it fires, the forward
    and the multi-step programs are rebuilt and the rebuild lands in the
    recompile goodput bucket; the trajectory is the one without it."""
    fired = []
    pcm = _port_init()
    ref = _port_init()
    x, y = gpt2_data(16)
    pcm.recompile_on_condition(lambda cm: cm._iteration == 2,
                               lambda cm: fired.append(cm._iteration))
    fwd = pcm.forward_fn
    hist = pcm.fit(x, y, epochs=1, verbose=False, steps_per_dispatch=2)
    assert fired == [2] and pcm.forward_fn is not fwd
    assert pcm.step_stats == {"dispatches": 4, "host_syncs": 4,
                              "barriers": 0, "fused_steps": 0}
    assert pcm.goodput_report()["buckets"]["recompile"] > 0.0
    rh = ref.fit(x, y, epochs=1, verbose=False, steps_per_dispatch=1,
                 sync_every=1)
    assert hist[0]["loss"] == rh[0]["loss"]


def _port_init():
    pm = FFModel(FFConfig(batch_size=BATCH, seed=3))
    build_gpt2(pm, GPT2Config(**GPT), batch=BATCH)
    pcm = pm.compile(AdamOptimizer(alpha=1e-3),
                     "sparse_categorical_crossentropy", [], device="cpu")
    pcm.init(seed=0)
    return pcm
