"""The span stream of the PyTorch port (flexflow_tpu_torch/telemetry.py)
against the JAX package's (flexflow_tpu/telemetry.py), on the CPU: the
pure derived metrics (drift, pipeline bubble) and size rotation on equal
inputs, the port's stream read by the JAX package's reader and rendered
by tools/trace_report.py, and a GPT-2 fit with telemetry and sentinels on
in both packages, which must emit the same `fit/*` and `health/*` events
in the same counts, with the same `step_stats`.

The fits are GPT-2 at 2 layers, d 64, dropout 0, from the JAX model's
initial weights (`convert.params_from_jax`). Each package's telemetry
module is its own process-global sink, so each test points both at
directories of its own and shuts both down after.
"""

import collections
import os
import sys

import jax
import numpy as np
import pytest

from flexflow_tpu import AdamOptimizer as JAdamOptimizer
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import telemetry as jtel
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
from flexflow_tpu_torch import telemetry as ptel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.tensor import Tensor
from flexflow_tpu_torch.models import GPT2Config, build_gpt2

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import monitor  # noqa: E402
import trace_report  # noqa: E402

GPT = dict(vocab=256, seq=32, d_model=64, heads=2, layers=2, dropout=0.0)
BATCH = 4


@pytest.fixture(autouse=True)
def _clean():
    """Both sinks off before and after; both guid counters equal after."""
    jtel.shutdown()
    ptel.shutdown()
    yield
    jtel.shutdown()
    ptel.shutdown()
    from flexflow_tpu.core.layer import Layer as JLayer
    from flexflow_tpu.core.tensor import Tensor as JTensor

    for a, b in ((JLayer, Layer), (JTensor, Tensor)):
        a._next_guid[0] = b._next_guid[0] = max(a._next_guid[0],
                                                b._next_guid[0])


# ------------------------------------------------------------ pure metrics
@pytest.mark.parametrize("pred,windows", [
    (0.01, [(8, 1.0), (8, 0.05), (8, 0.07), (8, 0.06)]),
    (0.01, [(4, 0.5)]),
    (None, [(4, 0.5), (4, 0.2)]),
    (0.001, [(0, 0.0), (4, 0.2), (4, 0.3)]),
    (0.5, [(4, 0.02), (4, 0.03)]),
    (0.02, [])])
def test_drift_stats_match_jax(pred, windows):
    got = ptel.drift_stats(pred, windows)
    assert got == jtel.drift_stats(pred, windows)
    # the same lines; a warning's advice is the port's own
    assert ptel.format_drift(got)[0] == jtel.format_drift(got)[0]
    assert len(ptel.format_drift(got)) == len(jtel.format_drift(got))


def test_bubble_from_ops_matches_jax():
    rng = np.random.default_rng(0)
    for stages in (1, 2, 4):
        ops = [(int(s), float(t), float(t + d)) for s, t, d in zip(
            rng.integers(0, stages, 12), rng.uniform(0, 100, 12),
            rng.uniform(1, 30, 12))]
        assert ptel.bubble_from_ops(stages, ops) == \
            jtel.bubble_from_ops(stages, ops)
    assert ptel.bubble_from_ops(2, []) is jtel.bubble_from_ops(2, []) is None
    evs = [{"name": n, "cat": "pipeline", "ph": "X", "pid": 1, "ts": t,
            "dur": 5.0, "args": {"stage": s, "update": u, "fit": 0}}
           for u in range(3) for s in range(2)
           for n, t in (("pipe/F", 10.0 * u + 3 * s),
                        ("pipe/B", 10.0 * u + 6 + 2 * s))]
    got = ptel.pipeline_bubble_from_events(evs)
    assert got == jtel.pipeline_bubble_from_events(evs) and got > 0


def _emit_same(tel, n=40):
    for i in range(n):
        with tel.span("fit/dispatch", cat="fit", kind="1", iteration=i):
            pass
        tel.counter("dataloader/queue_depth", i % 3, cat="dataloader")
        tel.event("fault/injected", cat="fault", site="fit/dispatch",
                  index=i)
    tel.error("checkpoint/write_failed", path="x", error="e")
    tel.retry("fit/dispatch", 1, RuntimeError("boom"), delay_s=0.0)


def test_rotation_matches_jax(tmp_path):
    """A 2 KiB cap rolls both sinks to the same numbered segments, and
    each package's reader merges the other's directory into the same
    ts-sorted stream."""
    dirs = {}
    for tag, tel in (("jax", jtel), ("port", ptel)):
        d = str(tmp_path / tag)
        assert tel.configure(d, max_mb=2048 / (1 << 20))
        _emit_same(tel)
        tel.shutdown()
        dirs[tag] = d
    segs = {t: sorted(f.replace(str(os.getpid()), "PID")
                      for f in os.listdir(d)) for t, d in dirs.items()}
    assert segs["port"] == segs["jax"] and len(segs["port"]) > 3
    shape = {}
    for tag, d in dirs.items():
        for reader in (jtel.read_events, ptel.read_events):
            evs = reader(d)
            shape.setdefault(tag, []).append(
                [(e["name"], e["ph"], e.get("cat"), e["tid"],
                  sorted(e.get("args", {}))) for e in evs])
    assert shape["port"][0] == shape["port"][1] == shape["jax"][0]
    assert len(shape["port"][0]) == 40 * 3 + 2


# -------------------------------------------------------------- the fits
@pytest.fixture(scope="module")
def jax_gpt2():
    """One JAX compile for the file (its jitted steps are kept; each test
    initializes it again)."""
    jm = JFFModel(JFFConfig(mesh_shape={"data": 1}, log_level="warning",
                            batch_size=BATCH, seed=3, retry_base_delay=0.0))
    jbuild_gpt2(jm, JGPT2Config(**GPT), batch=BATCH)
    return jm.compile(JAdamOptimizer(alpha=1e-3),
                      "sparse_categorical_crossentropy", [])


def _gpt2_pair(jcm, tdirs):
    """JAX's model initialized with its stream on tdirs[0]; the port's
    compiled with its stream on tdirs[1], from JAX's weights."""
    jtel.configure(tdirs[0])
    jcm.init(seed=0)
    pm = FFModel(FFConfig(batch_size=BATCH, seed=3, retry_base_delay=0.0,
                          telemetry_dir=tdirs[1]))
    build_gpt2(pm, GPT2Config(**GPT), batch=BATCH)
    pcm = pm.compile(AdamOptimizer(alpha=1e-3),
                     "sparse_categorical_crossentropy", [], device="cpu")
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))
    return jcm, pcm


def gpt2_data(n=32, seed=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, GPT["vocab"], size=(n, GPT["seq"])).astype(np.int32)
    pos = np.broadcast_to(np.arange(GPT["seq"], dtype=np.int32),
                          ids.shape).copy()
    y = rng.integers(0, GPT["vocab"], size=ids.shape).astype(np.int32)
    return [ids, pos], y


def _health_fit_events(tdir, tel):
    tel.flush()
    evs = tel.read_events(tdir)
    return collections.Counter(
        (e["name"], e.get("cat")) for e in evs
        if e["name"].startswith(("fit/", "health/"))), evs


@pytest.mark.parametrize("k", [1, 2])
def test_fit_emits_jax_events(jax_gpt2, tmp_path, k):
    """Telemetry and sentinels on, 2 epochs of 8 batches, a host sync
    every 2 updates (K = 2: one fused dispatch each): the multiset of
    (name, cat) of the fit/* and health/* events and the step_stats are
    JAX's; the drift event carries the predicted and measured step."""
    tdirs = [str(tmp_path / "jax"), str(tmp_path / "port")]
    jcm, pcm = _gpt2_pair(jax_gpt2, tdirs)
    x, y = gpt2_data()
    kw = dict(epochs=2, verbose=False, sync_every=2, steps_per_dispatch=k)
    jh = jcm.fit(x, y, **kw)
    ph = pcm.fit(x, y, **kw)
    assert pcm.step_stats == jcm.step_stats
    want, _ = _health_fit_events(tdirs[0], jtel)
    got, evs = _health_fit_events(tdirs[1], ptel)
    assert got == want
    assert got[("fit/dispatch", "fit")] == pcm.step_stats["dispatches"]
    assert got[("health/goodput", "health")] == 2
    assert got[("health/hbm", "health")] == 3      # init + 2 epochs
    drift = [e for e in evs if e["name"] == "fit/drift"][-1]["args"]
    assert drift["predicted_step_time_s"] > 0
    assert drift["measured_step_time_s"] > 0 and drift["windows"] == 2
    for a, b in zip(ph, jh):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        assert 0.0 <= a["goodput"] <= 1.0
    # the compile's spans and the loader's transfers are in the stream
    names = {e["name"] for e in evs}
    assert {"compile/compile_model", "dataloader/transfer",
            "dataloader/queue_depth"} <= names


def test_port_stream_read_by_jax_tools(tmp_path):
    """The port's stream goes through the JAX package's reader,
    tools/trace_report.py (its Chrome export passes validate_chrome) and
    tools/monitor.py unchanged."""
    tdir = str(tmp_path / "port")
    pm = FFModel(FFConfig(batch_size=BATCH, seed=3, telemetry_dir=tdir))
    build_gpt2(pm, GPT2Config(**GPT), batch=BATCH)
    pcm = pm.compile(AdamOptimizer(alpha=1e-3),
                     "sparse_categorical_crossentropy", [], device="cpu")
    pcm.init(seed=0)
    x, y = gpt2_data(16)
    pcm.fit(x, y, epochs=1, verbose=False)
    ptel.flush()
    assert ptel.sink_path().endswith(f"telemetry-{os.getpid()}.jsonl")
    evs = jtel.read_events(tdir)
    assert [e["name"] for e in evs] == \
        [e["name"] for e in ptel.read_events(tdir)]
    out = str(tmp_path / "trace.json")
    rep = trace_report.render(tdir, out_path=out, quiet=True)
    assert any(r["name"] == "fit/dispatch" and r["count"] == 4
               for r in rep["summary"])
    import json

    with open(out) as f:
        assert trace_report.validate_chrome(json.load(f)) == []
    state = monitor.gather(evs)
    assert state is not None


def test_serving_emits_jax_request_and_step_events(tmp_path):
    """A GPT-2 engine serving 6 requests with telemetry on: the engine,
    prefill, decode-step and request events of JAX's scheduler, in JAX's
    counts (one admitted and one done a request, one decode-step span a
    decode step)."""
    from flexflow_tpu.serving import ContinuousBatchingScheduler as JSched
    from flexflow_tpu.serving import Request as JRequest
    from flexflow_tpu.serving import compile_serving as jcompile_serving
    from flexflow_tpu.serving import gpt2_prompt_inputs as jprompt
    from flexflow_tpu.serving import gpt2_step_inputs as jstep
    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            Request, compile_serving,
                                            gpt2_prompt_inputs,
                                            gpt2_step_inputs)

    gkw = dict(vocab=256, seq=64, d_model=64, heads=2, layers=1, dropout=0.0)
    skw = dict(max_batch_slots=4, kv_page_size=16, max_decode_len=6)
    trace = [(12, 6), (20, 5), (9, 6), (30, 4), (15, 6), (25, 5)]
    dirs = [str(tmp_path / "jax"), str(tmp_path / "port")]
    jm = JFFModel(JFFConfig(mesh_shape={"data": 1}, log_level="warning",
                            telemetry_dir=dirs[0], **skw))
    jbuild_gpt2(jm, JGPT2Config(**gkw), batch=4)
    jeng = jcompile_serving(jm)
    jeng.init(seed=0)
    pm = FFModel(FFConfig(telemetry_dir=dirs[1], **skw))
    build_gpt2(pm, GPT2Config(**gkw), batch=4)
    peng = compile_serving(pm, device="cpu")
    peng.load_params(params_from_jax(jax.device_get(jeng.params)))
    counts, steps = [], []
    for tel, eng, sched_cls, req_cls, pfn, sfn, kw, d in (
            (jtel, jeng, JSched, JRequest, jprompt, jstep,
             {"reqtrace": False}, dirs[0]),
            (ptel, peng, ContinuousBatchingScheduler, Request,
             gpt2_prompt_inputs, gpt2_step_inputs, {}, dirs[1])):
        rng = np.random.default_rng(5)
        reqs = [req_cls(rid=i, prompt=[int(t) for t in rng.integers(
            1, gkw["vocab"], size=n)], max_new_tokens=m)
            for i, (n, m) in enumerate(trace)]
        sched = sched_cls(eng, eng.params, pfn, sfn, **kw)
        done = sched.run(reqs)
        assert len(done) == len(trace)
        tel.flush()
        c = collections.Counter((e["name"], e.get("cat"))
                                for e in tel.read_events(d))
        counts.append({k: v for k, v in c.items() if k[0] in (
            "serve/engine", "serve/prefill", "serve/decode_step",
            "serve/request_admitted", "serve/request_done",
            "serve/compile_serving")})
        steps.append(sched.decode_steps)
    assert counts[1] == counts[0]
    assert counts[1][("serve/request_admitted", "serve")] == len(trace)
    assert counts[1][("serve/request_done", "serve")] == len(trace)
    assert counts[1][("serve/decode_step", "serve")] == steps[1] == steps[0]
