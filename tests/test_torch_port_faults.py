"""Fault injection and retries in the PyTorch port against the JAX
package, on the CPU: the plan grammar and the sites, the seeded retry
schedule and its escalation, and the same plans replayed at every
training and serving site of both packages (`dataloader/transfer`,
`checkpoint/write`, `fit/dispatch` inside a fused dispatch,
`health/nonfinite`, `serve/kv_admit`, `serve/prefill`,
`serve/decode_step`) with the same retries and outcomes.

The two packages keep separate plans (each its own `faults` module), so
every test arms both. Retries sleep 0 s here (`retry_base_delay=0`, or a
policy with `base_delay=0`) except where the schedule itself is compared,
where `time.sleep` is replaced by a recorder. Numbers are held as in
tests/test_torch_port_dispatch.py: f32 at 1e-5 relative.
"""

import os

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu.runtime.resilience as jres
import flexflow_tpu_torch.runtime.resilience as pres
from flexflow_tpu import AdamOptimizer as JAdamOptimizer
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.runtime import dataloader as jdataloader
from flexflow_tpu.runtime import faults as jfaults
from flexflow_tpu.serving import ContinuousBatchingScheduler as JScheduler
from flexflow_tpu.serving import Request as JRequest
from flexflow_tpu.serving import compile_serving as jcompile_serving
from flexflow_tpu.serving import gpt2_prompt_inputs as jprompt_inputs
from flexflow_tpu.serving import gpt2_step_inputs as jstep_inputs
from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
from flexflow_tpu_torch.convert import params_from_jax, params_to_numpy
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.tensor import Tensor
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.runtime import dataloader as pdataloader
from flexflow_tpu_torch.runtime import faults as pfaults
from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler, Request,
                                        compile_serving, gpt2_prompt_inputs,
                                        gpt2_step_inputs)

RTOL, ATOL = 1e-5, 1e-7
BOTH = ((jfaults, jres), (pfaults, pres))


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends with both plans clear, and both
    packages' guid counters equal."""
    for f, _ in BOTH:
        f.clear()
    yield
    for f, _ in BOTH:
        f.clear()
    from flexflow_tpu.core.layer import Layer as JLayer
    from flexflow_tpu.core.tensor import Tensor as JTensor

    for a, b in ((JLayer, Layer), (JTensor, Tensor)):
        a._next_guid[0] = b._next_guid[0] = max(a._next_guid[0],
                                                b._next_guid[0])


def _arm(plan):
    for f, _ in BOTH:
        f.configure(plan)


# ------------------------------------------------------ grammar and sites
def test_plan_grammar_and_sites_match_jax():
    assert pfaults.SITES == jfaults.SITES
    plan = ("dataloader/transfer@3*2, checkpoint/write@1!,fit/dispatch@7,"
            "serve/kv_admit@2*4")
    want = [(s.site, s.at, s.times, s.permanent)
            for s in jfaults.parse_plan(plan)]
    got = [(s.site, s.at, s.times, s.permanent)
           for s in pfaults.parse_plan(plan)]
    assert got == want == [("dataloader/transfer", 3, 2, False),
                           ("checkpoint/write", 1, 1, True),
                           ("fit/dispatch", 7, 1, False),
                           ("serve/kv_admit", 2, 4, False)]
    for bad in ("nope/site@1", "fit/dispatch@x", "fit/dispatch",
                "fit/dispatch@2*", "fit/dispatch@@2"):
        with pytest.raises(ValueError) as je:
            jfaults.parse_plan(bad)
        with pytest.raises(ValueError) as pe:
            pfaults.parse_plan(bad)
        assert str(pe.value) == str(je.value)


def test_check_poison_and_indices_match_jax():
    """site@N fires once at operation N; site@N*T T times from N; site@N!
    from N on; poison answers without raising; counts count operations."""
    _arm("serve/prefill@2,serve/decode_step@2*2,checkpoint/write@3!,"
         "health/nonfinite@2")
    rows = []
    for f, _ in BOTH:
        row = []
        for site in ("serve/prefill", "serve/decode_step",
                     "checkpoint/write"):
            for _ in range(5):
                try:
                    f.check(site)
                    row.append("ok")
                except f.PermanentInjectedFault:
                    row.append("permanent")
                except f.InjectedFault:
                    row.append("fault")
        row += [f.poison("health/nonfinite", index=i) for i in (1, 2, 3)]
        row += [f.counts(), f.fired(), f.active()]
        rows.append(row)
        f.clear()
        row.append(f.active())
        with pytest.raises(ValueError):
            f.check("serve/nope")
    assert rows[1] == rows[0]
    assert rows[0][:15] == ["ok", "fault", "ok", "ok", "ok",
                            "ok", "fault", "fault", "ok", "ok",
                            "ok", "ok", "permanent", "permanent", "permanent"]


def test_fault_plan_flag_arms_the_plan():
    from flexflow_tpu_torch.config import FFConfig as PCfg

    cfg = PCfg.parse_args(["--fault-plan", "fit/dispatch@2",
                           "--retry-attempts", "5",
                           "--retry-base-delay", "0.5"])
    assert (cfg.fault_plan, cfg.retry_attempts, cfg.retry_base_delay) == \
        ("fit/dispatch@2", 5, 0.5)
    m = FFModel(cfg)
    m.dense(m.create_tensor([4, 3], name="x"), 2, name="d")
    assert not pfaults.active()
    m.compile(AdamOptimizer(), "mean_squared_error", device="cpu")
    assert pfaults.active()
    assert [(s.site, s.at) for s in pfaults._SPECS] == [("fit/dispatch", 2)]


def test_env_plan_is_read_at_import():
    import subprocess
    import sys

    code = ("from flexflow_tpu_torch.runtime import faults; "
            "print([(s.site, s.at, s.permanent) for s in faults._SPECS])")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)),
        env=dict(os.environ, FF_FAULT_PLAN="checkpoint/write@2!"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[('checkpoint/write', 2, True)]"


# --------------------------------------------------------------- retries
@pytest.mark.parametrize("plan,outcome", [
    ("fit/dispatch@1*2", "ok"), ("fit/dispatch@1*5", "InjectedFault"),
    ("fit/dispatch@1!", "PermanentInjectedFault"), ("", "ValueError")])
def test_retry_schedule_and_escalation_match_jax(plan, outcome, monkeypatch):
    """The seeded jitter gives the same backoff delays; a transient fault
    within the budget recovers, one past it (or a permanent one)
    escalates after `attempts` tries; a ValueError is not retried."""
    _arm(plan)
    seen = []
    for f, res in BOTH:
        slept = []
        monkeypatch.setattr(res.time, "sleep", slept.append)
        calls = []

        def fn():
            calls.append(1)
            if not plan:
                raise ValueError("a program's fault")
            return 42
        pol = res.RetryPolicy(attempts=3, base_delay=0.01, seed=5)
        try:
            got = res.run_resilient("fit/dispatch", fn, pol)
        except Exception as e:  # noqa: BLE001 - compared by type
            got = type(e).__name__
        seen.append((got, slept, len(calls), f.fired()))
    assert seen[1] == seen[0]
    assert seen[0][0] == (42 if outcome == "ok" else outcome)
    want_sleeps = {"ok": 2, "InjectedFault": 2,
                   "PermanentInjectedFault": 2, "ValueError": 0}[outcome]
    assert len(seen[0][1]) == want_sleeps
    # the schedule itself: doubling from base_delay within +-25% jitter
    for a, d in enumerate(seen[0][1], start=1):
        assert 0.75 * 0.01 * 2 ** (a - 1) <= d <= 1.25 * 0.01 * 2 ** (a - 1)
    assert [pres.RetryPolicy(seed=9).delay(a) for a in range(1, 8)] == \
        [jres.RetryPolicy(seed=9).delay(a) for a in range(1, 8)]
    cfg_kw = dict(seed=3, retry_attempts=4, retry_base_delay=0.2)
    jp = jres.RetryPolicy.from_config(JFFConfig(**cfg_kw))
    pp = pres.RetryPolicy.from_config(FFConfig(**cfg_kw))
    assert (pp.attempts, pp.base_delay, pp.seed) == \
        (jp.attempts, jp.base_delay, jp.seed) == (4, 0.2, 3 ^ (os.getpid() << 8))


# ------------------------------------------------------------- the loader
def _batches(n=7):
    rng = np.random.default_rng(1)
    return [([rng.normal(size=(4, 2)).astype(np.float32)],
             rng.integers(0, 5, size=(4,)).astype(np.int32))
            for _ in range(n)]


@pytest.mark.parametrize("plan", ["dataloader/transfer@2*2",
                                  "dataloader/transfer@2!"])
def test_loader_transfer_site_matches_jax(plan):
    """A transient transfer fault is retried in the worker and every item
    arrives; a permanent one reaches the consumer after the items before
    it, in both packages."""
    out = []
    for (f, res), make in zip(BOTH, (
            lambda p: jdataloader.prefetch_multi(iter(_batches()), 3, [None],
                                                 None, retry_policy=p),
            lambda p: pdataloader.prefetch_multi(iter(_batches()), 3, "cpu",
                                                 retry_policy=p))):
        f.configure(plan)
        kinds, err = [], None
        try:
            for kind, _, _ in make(res.RetryPolicy(base_delay=0.0)):
                kinds.append(kind)
        except f.InjectedFault as e:
            err = type(e).__name__
        out.append((kinds, err, f.fired(), f.counts()))
    assert out[1] == out[0]
    assert out[0][0] == (["k", "k", "1"] if plan.endswith("*2") else ["k"])


# --------------------------------------------------------- the checkpoint
@pytest.mark.parametrize("plan", ["checkpoint/write@1*2",
                                  "checkpoint/write@1!"])
def test_checkpoint_write_site_matches_jax(plan, tmp_path):
    """Write and commit are one operation: two transient faults cost two
    retries and the snapshot commits; a permanent one raises and nothing
    is committed, in both packages."""
    jcm, pcm = _bn_pair()
    out = []
    for (f, res), cm, root in zip(BOTH, (jcm, pcm),
                                  (tmp_path / "j", tmp_path / "p")):
        f.configure(plan)
        err = None
        try:
            res.save_durable(cm, str(root), block=True,
                             policy=res.RetryPolicy(base_delay=0.0))
        except f.InjectedFault as e:
            err = type(e).__name__
        latest = res.latest_checkpoint(str(root))
        out.append((err, f.fired(),
                    None if latest is None else os.path.basename(latest)))
    assert out[1] == out[0]
    assert out[0][2] == (None if plan.endswith("!") else "ckpt-0000000000")


# ------------------------------------------------------------------ fit
def tiny_bn(m, batch=4):
    x = m.create_tensor([batch, 3, 8, 8], name="image")
    t = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="conv", use_bias=False)
    t = m.batch_norm(t, relu=True, name="bn")
    t = m.mean(t, axes=[2, 3], name="gap")
    m.dense(t, 10, name="fc")


def _bn_pair(**cfg):
    cfg = dict(retry_base_delay=0.0, **cfg)
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


def _data(seed=4, n=32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3, 8, 8), scale=0.5).astype(np.float32)
    return x, rng.integers(0, 10, size=(n,)).astype(np.int32)


def _fit_both(plan, **fit_kw):
    jcm, pcm = _bn_pair()
    x, y = _data()
    out = []
    for (f, _), cm in zip(BOTH, (jcm, pcm)):
        f.configure(plan)
        err = hist = None
        try:
            hist = cm.fit(x, y, epochs=1, verbose=False, **fit_kw)
        except f.InjectedFault as e:
            err = type(e).__name__
        out.append((err, int(cm._iteration), f.fired(), hist))
    return jcm, pcm, out


def test_fit_dispatch_fault_fails_the_same_global_step():
    """fit/dispatch@5! with steps_per_dispatch=3: the second dispatch
    covers steps 4-6 and fails at step 5 before it runs, after the retry
    budget (3 attempts): the fit raises with 3 updates taken, in both
    packages."""
    _, _, out = _fit_both("fit/dispatch@5!", steps_per_dispatch=3)
    assert out[1][:3] == out[0][:3] == (
        "PermanentInjectedFault", 3, {"fit/dispatch": 3})


def test_fit_dispatch_transient_fault_retries_to_the_same_params():
    """fit/dispatch@5*2: two retries inside the fused dispatch, then the
    same trajectory as without the plan (and as JAX's)."""
    jcm, pcm, out = _fit_both("fit/dispatch@5*2", steps_per_dispatch=3)
    assert out[1][:3] == out[0][:3] == (None, 8, {"fit/dispatch": 2})
    assert pcm.step_stats == jcm.step_stats
    np.testing.assert_allclose(out[1][3][0]["loss"], out[0][3][0]["loss"],
                               rtol=RTOL)
    jp = jax.device_get(jcm.params)
    for l, ws in params_to_numpy(pcm.params).items():
        for w, a in ws.items():
            np.testing.assert_allclose(a, np.asarray(jp[l][w]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{l}.{w}")
    _, clean = _bn_pair()
    clean.fit(*_data(), epochs=1, verbose=False, steps_per_dispatch=3)
    assert all(torch.equal(clean.params[l][w], pcm.params[l][w])
               for l in pcm.params for w in pcm.params[l])


def test_health_nonfinite_poisons_the_same_leaf():
    """health/nonfinite@4 NaN-poisons the first param leaf in JAX's tree
    order (bn.beta) before step 4 without raising; the epoch's loss goes
    NaN in both. (Which other leaves turn NaN later differs: JAX's relu
    gradient is where(x > 0, g, 0), which zeroes a NaN; torch's passes
    it.)"""
    jcm, pcm, out = _fit_both("health/nonfinite@4", steps_per_dispatch=3)
    assert out[1][:3] == out[0][:3] == (None, 8, {"health/nonfinite": 1})
    assert np.isnan(out[0][3][0]["loss"]) and np.isnan(out[1][3][0]["loss"])
    jleaves, _ = jax.tree_util.tree_flatten(jax.device_get(jcm.params))
    assert np.isnan(np.asarray(jleaves[0])).all()
    assert torch.isnan(pcm.params["bn"]["beta"]).all()
    assert np.array_equal(np.asarray(jleaves[0]).shape,
                          tuple(pcm.params["bn"]["beta"].shape))


# --------------------------------------------------------------- serving
GPT_KW = dict(vocab=256, seq=64, d_model=64, heads=2, layers=1, dropout=0.0)
SERVE_KW = dict(max_batch_slots=4, kv_page_size=16, max_decode_len=6)
TRACE = [(12, 6), (20, 5), (9, 6), (30, 4), (15, 6), (25, 5)]


@pytest.fixture(scope="module")
def engines():
    jm = JFFModel(JFFConfig(mesh_shape={"data": 1}, log_level="warning",
                            **SERVE_KW))
    jbuild_gpt2(jm, JGPT2Config(**GPT_KW), batch=4)
    jeng = jcompile_serving(jm)
    jeng.init(seed=0)
    pm = FFModel(FFConfig(**SERVE_KW))
    build_gpt2(pm, GPT2Config(**GPT_KW), batch=4)
    peng = compile_serving(pm, device="cpu")
    peng.load_params(params_from_jax(jax.device_get(jeng.params)))
    return jeng, peng


def _requests(cls):
    rng = np.random.default_rng(5)
    return [cls(rid=i, prompt=[int(t) for t in rng.integers(
        1, GPT_KW["vocab"], size=n)], max_new_tokens=m)
        for i, (n, m) in enumerate(TRACE)]


def _outcomes(s):
    return {"completed": sorted((r.rid, tuple(r.tokens)) for r in s.completed),
            "failed": sorted((r.rid, r.outcome) for r in s.failed),
            "shed": sorted(r.rid for r in s.shed)}


@pytest.mark.parametrize("plan", [
    "", "serve/decode_step@2*1", "serve/kv_admit@2*3", "serve/prefill@2*3",
    "serve/decode_step@3*3"])
def test_serving_sites_give_jax_outcomes(engines, plan):
    """A transient decode fault costs a retry and changes nothing; an
    escalated kv_admit fails that request, an escalated prefill the batch
    it admits, an escalated decode step the longest-resident slot; the
    others are served as without the plan, and every page comes back."""
    outs = []
    for (f, res), eng, sched_cls, req_cls, pfn, sfn, kw in (
            (BOTH[0], engines[0], JScheduler, JRequest, jprompt_inputs,
             jstep_inputs, {"reqtrace": False}),
            (BOTH[1], engines[1], ContinuousBatchingScheduler, Request,
             gpt2_prompt_inputs, gpt2_step_inputs, {})):
        f.configure(plan)
        sched = sched_cls(eng, eng.params, pfn, sfn,
                          retry_policy=res.RetryPolicy(base_delay=0.0), **kw)
        sched.run(_requests(req_cls))
        assert len(eng.kv.free_pages) == eng.kv.capacity_pages()
        outs.append((_outcomes(sched), f.fired(),
                     {k: sched.stats[k] for k in ("failed",
                                                  "evicted_wedged")}))
        f.clear()
    assert outs[1] == outs[0]
    failed = outs[0][0]["failed"]
    if plan.endswith("*3"):
        assert failed and all(o == "failed" for _, o in failed)
    else:
        assert failed == []
