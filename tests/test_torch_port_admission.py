"""The port's SLO-aware admission against the JAX scheduler, on the CPU.

Both schedulers serve one open-loop trace on one small GPT-2 (the JAX
engine's params carried into the port). Each scheduler module's clock is
replaced by a virtual one that only the engine calls move (a prefill,
a decode step, a speculative round each take a fixed time) and the
open-loop idle sleeps, so arrivals, the EMA prefill time, queue waits,
TTFTs and the watchdog's per-step times are the same numbers in both
packages. The JAX scheduler runs with `reqtrace=False`. The shed,
completed and failed lists (by rid, outcome and reason), the admission
waves, the streams and the SLO reports must be equal.
"""

import jax
import numpy as np
import pytest

import flexflow_tpu.serving.scheduler as jsched_mod
import flexflow_tpu_torch.serving.scheduler as psched_mod
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.health import SLOTracker as JSLOTracker
from flexflow_tpu.health import parse_slo as jparse_slo
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.serving import ContinuousBatchingScheduler as JScheduler
from flexflow_tpu.serving import Request as JRequest
from flexflow_tpu.serving import compile_serving as jcompile_serving
from flexflow_tpu.serving import gpt2_prompt_inputs as jprompt_inputs
from flexflow_tpu.serving import gpt2_step_inputs as jstep_inputs
from flexflow_tpu.serving.reqtrace import terminal_record as jterminal_record
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.health import SLOTracker, parse_slo
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler, Request,
                                        compile_serving, gpt2_prompt_inputs,
                                        gpt2_step_inputs, terminal_record)

GPT2_KW = dict(vocab=512, seq=128, d_model=128, heads=2, layers=2, dropout=0.0)
DRAFT_KW = dict(GPT2_KW, d_model=64, heads=1, layers=1)
SERVE_KW = dict(max_batch_slots=4, kv_page_size=16, max_decode_len=8)
SLO = ("ttft_p99_ms=120,per_token_p50_ms=12,queue_wait_p90_ms=60,"
       "availability=0.9")
# virtual seconds each engine call takes
PREFILL_S, STEP_S, ROUND_S = 0.05, 0.01, 0.03


class VirtualClock:
    """Stands in for a scheduler module's `time`: engine calls and idle
    sleeps move it, nothing else does."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += max(0.0, s)


def _timed(clock, fn, dt):
    def call(*a, **kw):
        clock.t += dt
        return fn(*a, **kw)
    return call


def _jmodel(kw):
    m = JFFModel(JFFConfig(mesh_shape={"data": 1}, log_level="warning",
                           serve_slo=SLO, **SERVE_KW))
    jbuild_gpt2(m, JGPT2Config(**kw), batch=8)
    return m


def _pmodel(kw):
    m = FFModel(FFConfig(serve_slo=SLO, **SERVE_KW))
    build_gpt2(m, GPT2Config(**kw), batch=8)
    return m


@pytest.fixture(scope="module")
def engines():
    """{"plain": (jax, port), "spec": (jax, port)}: the spec pair drafts
    K=3 tokens with a random one-layer draft."""
    jp = jcompile_serving(_jmodel(GPT2_KW))
    jp.init(seed=0)
    js = jcompile_serving(_jmodel(GPT2_KW), draft=_jmodel(DRAFT_KW),
                          spec_tokens=3)
    js.load_params(jp.params)
    js.draft.init(seed=7)
    out = {"plain": (jp, compile_serving(_pmodel(GPT2_KW), device="cpu")),
           "spec": (js, compile_serving(_pmodel(GPT2_KW), draft=_pmodel(
               DRAFT_KW), spec_tokens=3, device="cpu"))}
    tree = params_from_jax(jax.device_get(jp.params))
    for _, peng in out.values():
        peng.load_params(tree)
    out["spec"][1].draft.load_params(
        params_from_jax(jax.device_get(js.draft.params)))
    return out


def _trace(cls, rows, seed=11):
    """rows: (prompt_len, max_new, arrival_s, priority, deadline_s)."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=[int(x) for x in
                               rng.integers(1, GPT2_KW["vocab"], size=n)],
                max_new_tokens=m, arrival_s=a, priority=p, deadline_s=d)
            for i, (n, m, a, p, d) in enumerate(rows)]


def _run(mod, eng, sched_cls, req_cls, prompt_fn, step_fn, rows, cfg, kw,
         monkeypatch):
    clock = VirtualClock()
    monkeypatch.setattr(mod, "time", clock)
    for name, value in cfg.items():
        monkeypatch.setattr(eng.cfg, name, value)
    monkeypatch.setattr(eng, "prefill", _timed(clock, eng.prefill, PREFILL_S))
    monkeypatch.setattr(eng, "decode_step",
                        _timed(clock, eng.decode_step, STEP_S))
    if eng.draft is not None:
        monkeypatch.setattr(eng, "spec_round_step",
                            _timed(clock, eng.spec_round_step, ROUND_S))
    sched = sched_cls(eng, eng.params, prompt_fn, step_fn, **kw)
    sched.run(_trace(req_cls, rows))
    return sched


def _serve_both(engines, kind, rows, monkeypatch, cfg=None, **kw):
    jeng, peng = engines[kind]
    with monkeypatch.context() as mp:
        js = _run(jsched_mod, jeng, JScheduler, JRequest, jprompt_inputs,
                  jstep_inputs, rows, cfg or {}, dict(kw, reqtrace=False), mp)
    with monkeypatch.context() as mp:
        ps = _run(psched_mod, peng, ContinuousBatchingScheduler, Request,
                  gpt2_prompt_inputs, gpt2_step_inputs, rows, cfg or {}, kw,
                  mp)
    return js, ps


def _outcomes(s):
    return {"completed": sorted((r.rid, r.outcome, tuple(r.tokens))
                                for r in s.completed),
            "shed": [(r.rid, r.shed_reason, r.finish_s) for r in s.shed],
            "failed": [(r.rid, r.outcome, r.finish_s, len(r.tokens))
                       for r in s.failed]}


def _waves(s):
    """rids admitted together, in admission order."""
    by_t = {}
    for r in s.completed + s.failed:
        by_t.setdefault(r.admit_s, []).append(r.rid)
    return [sorted(v) for _, v in sorted(by_t.items())]


def _each_request_ends_once(s, n):
    ends = [r.rid for r in s.completed + s.shed + s.failed]
    assert sorted(ends) == list(range(n))


def _pages_back(eng):
    for kv in (eng.kv,) + ((eng.draft.kv,) if eng.draft else ()):
        assert len(kv.free_pages) == kv.capacity_pages()


# (prompt_len, max_new, arrival_s, priority, deadline_s). With queue cap 3,
# a TTFT budget of 150 ms and a context ceiling of 60: at t=0, 3 displaces
# 2 (queue_full); 4's deadline passes during the first prefill; 6 takes
# the last slot before 5, which then waits past the budget; 7's prompt
# is longer than the prefill window; 8's prompt + budget is over 60
TRACE = [(20, 8, 0.0, 1, None), (33, 6, 0.0, 1, None),
         (7, 8, 0.0, 1, None), (50, 7, 0.0, 0, None),
         (12, 8, 0.01, 1, 0.03), (40, 6, 0.02, 2, None),
         (9, 8, 0.03, 1, None), (129, 4, 0.04, 0, None),
         (55, 8, 0.045, 0, None), (25, 8, 0.5, 1, None),
         (5, 8, 0.5, 2, None), (11, 8, 1.5, 0, 0.01)]
ADMISSION = dict(cfg={"serve_max_context": 60}, queue_cap=3,
                 ttft_budget_ms=150.0)


def test_shed_completed_failed_lists_match(engines, monkeypatch):
    """Queue cap, TTFT budget, deadlines, the prefill window and the context
    ceiling on one trace: every list, reason and stat as in JAX."""
    js, ps = _serve_both(engines, "plain", TRACE, monkeypatch, **ADMISSION)
    assert _outcomes(ps) == _outcomes(js)
    assert {k: v for k, v in ps.stats.items() if k in js.stats} == \
        {k: js.stats[k] for k in ps.stats}
    reasons = {r.shed_reason for r in ps.shed}
    assert reasons == {"queue_full", "ttft_budget", "deadline",
                       "prompt_too_long", "over_max_context"}, reasons
    assert [r.ttft_s for r in ps.completed] == [r.ttft_s for r in js.completed]
    assert ps._ema_serve_ms == js._ema_serve_ms
    assert ps._ema_serve_ms == pytest.approx(1e3 * PREFILL_S)
    _each_request_ends_once(ps, len(TRACE))
    _pages_back(engines["plain"][1])


def test_admission_waves_under_prefill_chunk(engines, monkeypatch):
    rows = [(n, 6, 0.0, 1, None) for n in (40, 30, 50, 20, 60, 10, 35)]
    js, ps = _serve_both(engines, "plain", rows, monkeypatch,
                         prefill_chunk_tokens=80)
    waves = _waves(ps)
    assert waves == _waves(js)
    assert len(waves) >= 3
    lens = {i: r[0] for i, r in enumerate(rows)}
    assert all(sum(lens[i] for i in w) <= 80 or len(w) == 1 for w in waves)
    assert _outcomes(ps) == _outcomes(js)
    _each_request_ends_once(ps, len(rows))


def test_priority_first_admission(engines, monkeypatch):
    """Seven at once into four slots: the first wave takes the four most
    urgent (priority, then arrival, then rid)."""
    prios = (2, 1, 0, 2, 0, 1, 0)
    rows = [(10 + i, 6, 0.0, p, None) for i, p in enumerate(prios)]
    js, ps = _serve_both(engines, "plain", rows, monkeypatch)
    waves = _waves(ps)
    assert waves == _waves(js)
    urgent = sorted(range(7), key=lambda i: (prios[i], i))[:4]
    assert waves[0] == sorted(urgent)
    assert _outcomes(ps) == _outcomes(js)


def test_queue_cap_displacement(engines, monkeypatch):
    """A full queue sheds its least urgent waiter for a more urgent arrival,
    and an arrival no more urgent than every waiter sheds itself."""
    # 0 and 1 take two slots; 2..7 arrive while they prefill: 2 and 3
    # fill the queue, 4 and 5 are no more urgent than 3 and shed
    # themselves, 6 displaces 3, 7 sheds itself
    rows = [(10, 8, 0.0, 1, None), (10, 8, 0.0, 1, None),
            (10, 8, 0.001, 1, None), (10, 8, 0.001, 1, None),
            (12, 6, 0.01, 2, None), (14, 6, 0.01, 1, None),
            (16, 6, 0.02, 0, None), (18, 6, 0.02, 2, None)]
    js, ps = _serve_both(engines, "plain", rows, monkeypatch, queue_cap=2)
    assert _outcomes(ps) == _outcomes(js)
    assert [(r.rid, r.shed_reason) for r in ps.shed] == \
        [(i, "queue_full") for i in (4, 5, 3, 7)]
    _each_request_ends_once(ps, len(rows))


def test_over_max_context(engines, monkeypatch):
    rows = [(30, 8, 0.0, 1, None), (52, 8, 0.0, 1, None),
            (53, 8, 0.0, 1, None)]
    js, ps = _serve_both(engines, "plain", rows, monkeypatch,
                         cfg={"serve_max_context": 60})
    assert _outcomes(ps) == _outcomes(js)
    assert [(r.rid, r.shed_reason) for r in ps.shed] == \
        [(2, "over_max_context")]
    assert ps.stats["shed_over_max_context"] == 1


@pytest.mark.parametrize("kind", ["plain", "spec"])
def test_watchdog_evicts_longest_resident(engines, monkeypatch, kind):
    """Every window is slower than the budget: each sync evicts the slot
    with the most tokens (ties to the lowest slot) as "timeout", in both
    caches when a draft is attached."""
    picks = []
    pick = psched_mod.ContinuousBatchingScheduler._pick_wedged

    def watched(self, active):
        slot = pick(self, active)
        most = max(len(r.tokens) for r in active.values())
        assert slot == min(s for s, r in active.items()
                           if len(r.tokens) == most)
        picks.append(active[slot].rid)
        return slot
    monkeypatch.setattr(psched_mod.ContinuousBatchingScheduler,
                        "_pick_wedged", watched)
    rows = [(10 + 7 * i, 8, 0.0, 1, None) for i in range(5)]
    js, ps = _serve_both(engines, kind, rows, monkeypatch,
                         decode_timeout_ms=5.0)
    assert _outcomes(ps) == _outcomes(js)
    assert ps.stats["decode_timeouts"] == js.stats["decode_timeouts"] > 0
    assert ps.stats["evicted_wedged"] == len(ps.failed) == len(picks)
    assert [r.rid for r in ps.failed] == picks
    assert {r.outcome for r in ps.failed} == {"timeout"}
    _each_request_ends_once(ps, len(rows))
    _pages_back(engines[kind][1])


def test_engine_slo_reports_match(engines, monkeypatch):
    """The engine's SLOTracker, fed by every terminal record of a run,
    reports what JAX's reports."""
    for _, peng in engines.values():
        peng.slo.__init__(peng.slo.objectives)
    jeng = engines["plain"][0]
    jeng.slo.__init__(jeng.slo.objectives)
    js, ps = _serve_both(engines, "plain", TRACE, monkeypatch, **ADMISSION)
    rep, jrep = engines["plain"][1].slo.report(), jeng.slo.report()
    assert rep["requests"] == len(TRACE)
    assert rep == jrep


BAD_SLO = ["ttft_p99_ms", "ttft_p99_ms=fast", "availability=1.5",
           "availability=0", "ttft_p100_ms=5", "latency_p99_ms=5",
           "throughput=3"]


@pytest.mark.parametrize("spec", BAD_SLO)
def test_parse_slo_errors_match(spec):
    with pytest.raises(ValueError) as jerr:
        jparse_slo(spec)
    with pytest.raises(ValueError) as perr:
        parse_slo(spec)
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError):
        FFConfig(serve_slo=spec)


def test_parse_slo_and_tracker_match():
    spec = " ttft_p99_ms=25, per_token_p50_ms=10,queue_wait_p90_ms=5 ," \
           "availability=0.999"
    assert parse_slo(spec) == jparse_slo(spec)
    assert parse_slo("") == jparse_slo("") == {}
    rng = np.random.default_rng(4)
    trackers = (SLOTracker(parse_slo(spec)), JSLOTracker(jparse_slo(spec)))
    outcomes = ("done", "done", "done", "shed", "failed", "timeout")
    for i in range(200):
        req = Request(rid=i, prompt=[1] * int(rng.integers(1, 40)),
                      max_new_tokens=8, arrival_s=float(i),
                      priority=int(rng.integers(0, 3)))
        req.outcome = outcomes[int(rng.integers(0, len(outcomes)))]
        if req.outcome == "done":
            req.admit_s = i + float(rng.uniform(0, 0.01))
            req.ttft_s = float(rng.uniform(0.001, 0.05))
            req.tokens = [0] * int(rng.integers(1, 9))
        now = i + float(rng.uniform(0.05, 0.3))
        rec = terminal_record(req, now, 3, "x")
        assert rec == jterminal_record(req, now, 3, "x")
        for t in trackers:
            t.observe(rec, now_s=10.0 * i)
    for now in (1990.0, 2100.0, 2400.0):
        assert trackers[0].report(now) == trackers[1].report(now)
