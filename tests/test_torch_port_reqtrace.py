"""The port's request tracing, streaming histograms and replayable traces
against the JAX package's, on the CPU.

The histograms and the trace format are pure functions of their inputs:
the same samples (and the same `np.random.Generator` seeds) give JAX's
buckets, quantiles, Prometheus lines, records and bytes. The tracer rides
one small GPT-2 (tests/test_serving_reqtrace.py's shapes: vocab 256, seq
16, d 32, 4 heads, 1 layer, 4 slots, page 4) served by both packages on
the JAX engine's weights: each request's stage names and terminal record
fields, for every outcome, equal JAX's; tracing on and off give the same
streams and host syncs; `serve_trace_out` writes JAX's bytes.
"""

import json

import jax
import numpy as np
import pytest

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.runtime import faults as jfaults
from flexflow_tpu.runtime.resilience import RetryPolicy as JRetryPolicy
from flexflow_tpu.serving import ContinuousBatchingScheduler as JScheduler
from flexflow_tpu.serving import Request as JRequest
from flexflow_tpu.serving import compile_serving as jcompile_serving
from flexflow_tpu.serving import gpt2_prompt_inputs as jprompt_inputs
from flexflow_tpu.serving import gpt2_step_inputs as jstep_inputs
from flexflow_tpu.serving import reqtrace as jreqtrace
from flexflow_tpu.serving import tracefmt as jtracefmt
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.runtime import faults
from flexflow_tpu_torch.runtime.resilience import RetryPolicy
from flexflow_tpu_torch.serving import (TERMINAL_FIELDS,
                                        ContinuousBatchingScheduler, Request,
                                        StreamingHistogram, compile_serving,
                                        gpt2_prompt_inputs, gpt2_step_inputs,
                                        reqtrace, tracefmt)

GPT2_KW = dict(vocab=256, seq=16, d_model=32, heads=4, layers=1, dropout=0.0)
SERVE_KW = dict(max_batch_slots=4, kv_page_size=4, max_decode_len=6)


# ----------------------------------------------------------- histograms
def _draws():
    rng = np.random.default_rng(0)
    return [np.exp(rng.normal(np.log(5e-3), 1.2, size=4000)),
            rng.exponential(0.08, size=4000) + 1e-5,
            rng.uniform(1e-4, 2.0, size=999),
            np.array([1e-9, 3e-3, 3e-3, 0.2, 1e3, np.nan, np.inf])]


def _hist_state(h):
    return (h.counts.tolist(), h.count, h.sum,
            [h.quantile(q) for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)],
            h.mean(), h.snapshot(), h.prom_lines("flexflow_serve_x", "x"))


def test_histogram_edges_and_metrics_match_jax():
    assert np.array_equal(reqtrace.HIST_EDGES, jreqtrace.HIST_EDGES)
    assert reqtrace.HIST_METRICS == jreqtrace.HIST_METRICS
    assert TERMINAL_FIELDS == jreqtrace.TERMINAL_FIELDS


@pytest.mark.parametrize("which", range(4))
def test_histogram_quantiles_snapshot_and_prom_match_jax(which):
    draws = _draws()[which]
    h, jh = StreamingHistogram(), jreqtrace.StreamingHistogram()
    h.add_many(draws)
    jh.add_many(draws)
    h.add(0.004, n=3)
    jh.add(0.004, n=3)
    assert _hist_state(h) == _hist_state(jh)
    back = StreamingHistogram.from_snapshot(jh.snapshot())
    assert _hist_state(back)[:3] == _hist_state(jh)[:3]


def test_histogram_merge_matches_jax():
    a, b, _, _ = _draws()
    ha, hb, ja, jb = (cls() for cls in (StreamingHistogram,
                                        StreamingHistogram,
                                        jreqtrace.StreamingHistogram,
                                        jreqtrace.StreamingHistogram))
    for h, x in ((ha, a), (hb, b), (ja, a), (jb, b)):
        h.add_many(x)
    ha.merge(hb)
    ja.merge(jb)
    assert _hist_state(ha) == _hist_state(ja)
    with pytest.raises(ValueError):
        ha.merge(StreamingHistogram(edges=np.array([0.1, 1.0])))
    with pytest.raises(ValueError):
        StreamingHistogram.from_snapshot({"buckets": {}, "sum": 0.0,
                                          "count": 0, "n_edges": 7})


# ----------------------------------------------------------- tracefmt
def _records(mod, n=8, seed=0):
    return mod.poisson_records(np.random.default_rng(seed), n, rate=10.0,
                               vocab=64, prompt_len=4, max_new=8,
                               deadline_s=2.5, priorities=(0, 1, 2))


def _as_json(records):
    return [r.to_json() for r in records]


def test_generators_match_jax():
    assert _as_json(_records(tracefmt)) == _as_json(_records(jtracefmt))
    kw = dict(n_base=20, base_rate=5.0, burst_factor=10.0, burst_frac=0.25,
              vocab=64, prompt_len=6, max_new=4)
    got = tracefmt.burst_records(np.random.default_rng(3), **kw)
    want = jtracefmt.burst_records(np.random.default_rng(3), **kw)
    assert _as_json(got) == _as_json(want)
    assert _as_json(tracefmt.scale_rate(got, 2.5)) == \
        _as_json(jtracefmt.scale_rate(want, 2.5))
    with pytest.raises(ValueError):
        tracefmt.scale_rate(got, 0.0)


def test_save_load_save_bitwise_across_packages(tmp_path):
    """The port's save -> load -> save is bitwise; its file is JAX's
    byte for byte, and each package loads the other's."""
    recs = _records(tracefmt)
    pa, pb, ja = (str(tmp_path / n) for n in ("pa.jsonl", "pb.jsonl",
                                             "ja.jsonl"))
    meta = {"seed": 0, "rate": 10.0}
    tracefmt.save_trace(pa, recs, meta=meta)
    tr = tracefmt.load_trace(pa)
    assert tr.skipped == 0 and tr.records == recs and tr.meta == meta
    tracefmt.save_trace(pb, tr.records, meta=tr.meta)
    jtracefmt.save_trace(ja, _records(jtracefmt), meta=meta)
    with open(pa, "rb") as f1, open(pb, "rb") as f2, open(ja, "rb") as f3:
        assert f1.read() == f2.read() == f3.read()
    assert _as_json(jtracefmt.load_trace(pa).records) == _as_json(recs)
    assert _as_json(tracefmt.load_trace(ja).records) == _as_json(recs)


def test_load_errors_and_skips_match_jax(tmp_path):
    good = {"arrival_ts": 1.0, "tokens_in": 8, "max_tokens": 4}
    body = [json.dumps({"schema_version": 1, "meta": {}}),
            json.dumps(good), "{truncated json", json.dumps([1, 2, 3]),
            json.dumps({"tokens_in": 8, "max_tokens": 4}),
            json.dumps({"arrival_ts": "NaNope", "tokens_in": 1,
                        "max_tokens": 1}), "",
            json.dumps(dict(good, arrival_ts=2.0, lora_id=7))]
    p = tmp_path / "t.jsonl"
    p.write_text("\n".join(body) + "\n")
    tr, jtr = tracefmt.load_trace(str(p)), jtracefmt.load_trace(str(p))
    assert tr.skipped == jtr.skipped == 4
    assert _as_json(tr.records) == _as_json(jtr.records)
    for text in ("", "not json\n", "[1,2,3]\n",
                 json.dumps({"schema_version": 2, "meta": {}}) + "\n"):
        p.write_text(text)
        with pytest.raises(ValueError) as e:
            tracefmt.load_trace(str(p))
        with pytest.raises(ValueError) as je:
            jtracefmt.load_trace(str(p))
        assert str(e.value).split(" (")[0].replace(
            "flexflow_tpu_torch", "flexflow_tpu") == \
            str(je.value).split(" (")[0]


def test_records_requests_round_trip_matches_jax():
    recs = _records(tracefmt, n=6)
    reqs = tracefmt.records_to_requests(recs)
    jreqs = jtracefmt.records_to_requests(_records(jtracefmt, n=6))
    fields = ("rid", "prompt", "max_new_tokens", "arrival_s", "priority",
              "deadline_s")
    assert [[getattr(r, f) for f in fields] for r in reqs] == \
        [[getattr(r, f) for f in fields] for r in jreqs]
    assert isinstance(reqs[0], Request)
    assert tracefmt.requests_to_records(reqs) == recs
    bare = [tracefmt.TraceRecord(arrival_ts=0.1 * i, tokens_in=5,
                                 max_tokens=3, rid=i) for i in range(3)]
    jbare = [jtracefmt.TraceRecord(arrival_ts=0.1 * i, tokens_in=5,
                                   max_tokens=3, rid=i) for i in range(3)]
    assert [r.prompt for r in tracefmt.records_to_requests(
        bare, vocab=64, seed=4)] == [r.prompt for r in
                                     jtracefmt.records_to_requests(
                                         jbare, vocab=64, seed=4)]
    with pytest.raises(ValueError):
        tracefmt.records_to_requests(bare)


# ----------------------------------------------------- the tracer, served
@pytest.fixture(scope="module")
def engines():
    jm = JFFModel(JFFConfig(mesh_shape={"data": 1}, log_level="warning",
                            **SERVE_KW))
    jbuild_gpt2(jm, JGPT2Config(**GPT2_KW), batch=8)
    jeng = jcompile_serving(jm)
    jeng.init(seed=0)
    pm = FFModel(FFConfig(**SERVE_KW))
    build_gpt2(pm, GPT2Config(**GPT2_KW), batch=8)
    peng = compile_serving(pm, device="cpu")
    peng.load_params(params_from_jax(jax.device_get(jeng.params)))
    return jeng, peng


def _reqs(cls, n, max_new=4, prompt_len=4, seed=41, **kw):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=[int(x) for x in
                               rng.integers(1, 256, size=prompt_len)],
                max_new_tokens=max_new, arrival_s=0.0, **kw)
            for i in range(n)]


def _run(eng, which, reqs, **kw):
    if which == "jax":
        sched = JScheduler(eng, eng.params, jprompt_inputs, jstep_inputs,
                           eos_id=None, dispatch_ahead=4, **kw)
    else:
        sched = ContinuousBatchingScheduler(
            eng, eng.params, gpt2_prompt_inputs, gpt2_step_inputs,
            eos_id=None, dispatch_ahead=4, **kw)
    done = sched.run(reqs)
    return sched, {r.rid: list(r.tokens) for r in done}


def _traces(sched):
    """rid -> (outcome, reason, stage names, terminal record keys)."""
    return {tr["rid"]: (tr["outcome"], tr["outcome_reason"],
                        [s["stage"] for s in tr["stages"]],
                        sorted(k for k in tr if k in TERMINAL_FIELDS))
            for tr in sched.tracer.ring}


def _scenarios(which, eng):
    """done, shed (a prompt past the window; queue_full), failed (a
    kv_admit fault past its retries) and timeout (the watchdog)."""
    mod, req, pol = ((jfaults, JRequest, JRetryPolicy) if which == "jax"
                     else (faults, Request, RetryPolicy))
    out = {}
    reqs = _reqs(req, 6, max_new=5) + [req(rid=6, prompt=[1] * 17,
                                           max_new_tokens=2)]
    out["done_shed"] = _run(eng, which, reqs, queue_cap=2)
    n = mod.counts().get("serve/kv_admit", 0) + 2
    mod.configure(f"serve/kv_admit@{n}*3")
    try:
        out["failed"] = _run(eng, which, _reqs(req, 4),
                             retry_policy=pol(attempts=3, base_delay=0.0))
    finally:
        mod.clear()
    out["timeout"] = _run(eng, which, _reqs(req, 2, max_new=6),
                          decode_timeout_ms=1e-6)
    return out


def test_stages_and_terminal_records_match_jax_for_every_outcome(engines):
    jeng, peng = engines
    js, ps = _scenarios("jax", jeng), _scenarios("port", peng)
    outcomes = set()
    for name in js:
        assert ps[name][1] == js[name][1], name
        got, want = _traces(ps[name][0]), _traces(js[name][0])
        assert got == want, name
        outcomes |= {o for o, *_ in got.values()}
        sched = ps[name][0]
        assert sched.tracer.min_accounted_frac() >= 0.95
        for tr in sched.tracer.ring:
            assert set(TERMINAL_FIELDS) <= set(tr)
    assert outcomes == {"done", "shed", "failed", "timeout"}
    s = ps["done_shed"][0]
    assert s.tracer.hists["ttft"].count == len(s.completed)
    assert s.tracer.hists["decode_step"].count > 0
    assert s.tracer.get(3)["rid"] == 3
    assert {m: h.count for m, h in s.tracer.hists.items()} == \
        {m: h.count for m, h in js["done_shed"][0].tracer.hists.items()}


def test_tracing_off_vs_on_bitwise_same_syncs(engines, tmp_path):
    """Tracing off holds no tracer and emits no serve/req/* or serve/hist
    event; on, the streams, decode steps, prefills and host syncs are the
    same, and the terminal events carry every TERMINAL_FIELDS key."""
    _, peng = engines
    runs = {}
    for on in (True, False):
        tdir = str(tmp_path / f"tel{int(on)}")
        tel.configure(tdir)
        try:
            sched, streams = _run(peng, "port", _reqs(Request, 6, max_new=5),
                                  reqtrace=on)
        finally:
            tel.shutdown()
        runs[on] = (sched, streams, tel.read_events(tdir))
    (s_on, t_on, e_on), (s_off, t_off, e_off) = runs[True], runs[False]
    assert s_on.tracer is not None and s_off.tracer is None
    assert t_on == t_off
    assert (s_on.decode_steps, s_on.prefills, s_on.materializations) == \
        (s_off.decode_steps, s_off.prefills, s_off.materializations)
    names_off = [e["name"] for e in e_off]
    assert not any(n.startswith("serve/req/") for n in names_off)
    assert "serve/hist" not in names_off
    names_on = [e["name"] for e in e_on]
    assert {"serve/req/queue", "serve/req/prefill", "serve/req/decode"} <= \
        set(names_on)
    assert sorted(e["args"]["metric"] for e in e_on
                  if e["name"] == "serve/hist") == \
        sorted(m for m, h in s_on.tracer.hists.items() if h.count)
    for evs in (e_on, e_off):
        done = [e for e in evs if e["name"] == "serve/request_done"]
        assert len(done) == 6
        assert all(set(TERMINAL_FIELDS) <= set(e["args"]) for e in done)
    assert FFConfig().serve_reqtrace is True


def test_serve_trace_out_writes_jax_bytes(engines, tmp_path, monkeypatch):
    """`serve_trace_out`: the offered load at the end of run(), byte for
    byte the JAX scheduler's export of the same requests, and it replays
    to the same requests."""
    jeng, peng = engines
    paths = {}
    for which, eng, req in (("jax", jeng, JRequest), ("port", peng, Request)):
        paths[which] = str(tmp_path / f"{which}.jsonl")
        monkeypatch.setattr(eng.cfg, "serve_trace_out", paths[which])
        reqs = _reqs(req, 5, max_new=3, priority=2)
        reqs.append(req(rid=5, prompt=[1] * 17, max_new_tokens=2))  # shed
        _run(eng, which, reqs)
    with open(paths["jax"], "rb") as f1, open(paths["port"], "rb") as f2:
        assert f1.read() == f2.read()
    back = tracefmt.records_to_requests(
        tracefmt.load_trace(paths["port"]).records)
    assert [(r.rid, r.prompt, r.max_new_tokens, r.priority) for r in back] \
        == [(r.rid, r.prompt, r.max_new_tokens, r.priority)
            for r in _reqs(Request, 5, max_new=3, priority=2)
            + [Request(rid=5, prompt=[1] * 17, max_new_tokens=2)]]
