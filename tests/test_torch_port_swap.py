"""The port's hot-swap (watch, poll_swap, rollback, unpin) against the JAX
package's, on the CPU.

Each package watches a root of its own durable snapshots: the JAX engine
reads the JAX package's, the port's engine the port's, written by its own
checkpoint writer (and, in one test, by its `fit`) from the same params
(`params_from_jax`), so both serve the same weights before and after every
swap. The shapes are tests/test_serving_resilience.py's (GPT-2 vocab 256,
seq 16, d 64, 2 heads, 1 layer, 4 slots, page 4).
"""

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.runtime import faults as jfaults
from flexflow_tpu.runtime.checkpoint import \
    CheckpointMismatchError as JCheckpointMismatchError
from flexflow_tpu.runtime.resilience import RetryPolicy as JRetryPolicy
from flexflow_tpu.runtime.resilience import save_durable as jsave_durable
from flexflow_tpu.serving import ContinuousBatchingScheduler as JScheduler
from flexflow_tpu.serving import Request as JRequest
from flexflow_tpu.serving import compile_serving as jcompile_serving
from flexflow_tpu.serving import gpt2_prompt_inputs as jprompt_inputs
from flexflow_tpu.serving import gpt2_step_inputs as jstep_inputs
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.health import SwapStats
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.runtime import faults
from flexflow_tpu_torch.runtime.checkpoint import CheckpointMismatchError
from flexflow_tpu_torch.runtime.resilience import RetryPolicy, save_durable
from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler, Request,
                                        compile_serving, gpt2_prompt_inputs,
                                        gpt2_step_inputs)

GPT2_KW = dict(vocab=256, seq=16, d_model=64, heads=2, layers=1, dropout=0.0)
SERVE_KW = dict(max_batch_slots=4, kv_page_size=4)


def _jtrainer(gkw):
    m = JFFModel(JFFConfig(mesh_shape={"data": 1}, log_level="warning",
                           async_checkpoint=False, **SERVE_KW))
    jbuild_gpt2(m, JGPT2Config(**gkw), batch=8)
    return m.compile(JSGDOptimizer(lr=0.01),
                     loss_type="sparse_categorical_crossentropy", metrics=[])


def _ptrainer(gkw):
    m = FFModel(FFConfig(async_checkpoint=False, **SERVE_KW))
    build_gpt2(m, GPT2Config(**gkw), batch=8)
    return m.compile(SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy",
                     [], device="cpu")


@pytest.fixture(scope="module")
def env():
    """A JAX and a port serving engine on the same weights, and one trainer
    each to write snapshots."""
    jm = JFFModel(JFFConfig(mesh_shape={"data": 1}, log_level="warning",
                            **SERVE_KW))
    jbuild_gpt2(jm, JGPT2Config(**GPT2_KW), batch=8)
    jeng = jcompile_serving(jm, max_decode_len=6)
    jeng.init(seed=0)
    pm = FFModel(FFConfig(**SERVE_KW))
    build_gpt2(pm, GPT2Config(**GPT2_KW), batch=8)
    peng = compile_serving(pm, max_decode_len=6, device="cpu")
    peng.load_params(params_from_jax(jax.device_get(jeng.params)))
    jcm, pcm = _jtrainer(GPT2_KW), _ptrainer(GPT2_KW)
    jcm.init(seed=0)
    return {"jeng": jeng, "peng": peng, "jcm": jcm, "pcm": pcm}


@pytest.fixture(autouse=True)
def fresh_swap_state(env):
    """Each test starts from engines that have swapped nothing (the live
    params stay): the versions a test writes are then always newer."""
    for e in (env["jeng"], env["peng"]):
        e.swap_stats = type(e.swap_stats)()
        e._versions.clear()
        e._bad_snapshots.clear()
    yield
    _unwatch(env)


def _snapshot(env, jroot, proot, step, gkw=None):
    """Snapshot `step` in both roots, from the JAX trainer's params at
    seed `step` (another graph when `gkw` is given)."""
    jcm, pcm = ((env["jcm"], env["pcm"]) if gkw is None
                else (_jtrainer(gkw), _ptrainer(gkw)))
    jcm.init(seed=step)
    jcm._iteration = step
    jsave_durable(jcm, jroot, block=True)
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))
    pcm._iteration = step
    save_durable(pcm, proot, block=True)
    return jcm.params


def _probe_ids():
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 256, size=(4, 16)).astype(np.int32)
    return ids, np.array([16, 5, 9, 1], np.int32)


def _probe(env):
    ids, lengths = _probe_ids()
    j = np.asarray(env["jeng"].prefill(env["jeng"].params,
                                       jprompt_inputs(ids, lengths))[0])
    with torch.no_grad():
        p = env["peng"].prefill(env["peng"].params,
                                gpt2_prompt_inputs(ids, lengths))[0].numpy()
    np.testing.assert_allclose(p, j, atol=1e-4)
    return p


def _unwatch(env):
    for e in (env["jeng"], env["peng"]):
        e.unpin()
        e._watch_root = None


def _both(env, fn):
    return fn(env["jeng"]), fn(env["peng"])


def test_swap_rollback_pin_cycle_matches_jax(env, tmp_path):
    """Discover and swap to each new snapshot, roll back to the retained
    previous version bitwise, the pin blocks auto-advance, unpin resumes
    it: the same versions and SwapStats in both packages."""
    jroot, proot = str(tmp_path / "j"), str(tmp_path / "p")
    try:
        _snapshot(env, jroot, proot, 1)
        env["jeng"].watch(jroot, poll_interval_s=0.0, retain=2)
        env["peng"].watch(proot, poll_interval_s=0.0, retain=2)
        trail = []

        def step(fn):
            got = _both(env, fn)
            assert got[0] == got[1]
            trail.append((got[1], env["peng"].active_version))
            assert env["peng"].active_version == env["jeng"].active_version
            return got[1]
        assert step(lambda e: e.poll_swap(force=True))
        l1 = _probe(env)
        _snapshot(env, jroot, proot, 2)
        assert step(lambda e: e.poll_swap(force=True))
        l2 = _probe(env)
        assert not np.array_equal(l1, l2)
        assert step(lambda e: e.rollback()) == 1
        assert np.array_equal(_probe(env), l1)       # bitwise restore
        assert not step(lambda e: e.poll_swap(force=True))   # pinned
        env["jeng"].unpin()
        env["peng"].unpin()
        assert step(lambda e: e.poll_swap(force=True))
        assert np.array_equal(_probe(env), l2)
        assert [v for _, v in trail] == [1, 2, 1, 1, 2]
        jrep, prep = _both(env, lambda e: e.health_report()["serving"])
        assert set(prep) == set(jrep)
        for k in ("active_version", "swaps", "rollbacks", "rejected"):
            assert prep[k] == jrep[k], k
        assert (prep["swaps"], prep["rollbacks"]) == (3, 1)
        assert prep["swap_p99_s"] > 0
        assert set(SwapStats().report()) == set(
            env["jeng"].swap_stats.report())
    finally:
        _unwatch(env)


def test_mismatched_snapshot_rejected_with_jax_diffs(env, tmp_path):
    """A snapshot of another width is rejected with the same diff lines
    as JAX's, counted once and never read again; the live version stays."""
    jroot, proot = str(tmp_path / "j"), str(tmp_path / "p")
    _snapshot(env, jroot, proot, 5, gkw=dict(GPT2_KW, d_model=32))
    errs = []
    for eng, root, err in ((env["jeng"], jroot, JCheckpointMismatchError),
                           (env["peng"], proot, CheckpointMismatchError)):
        import os
        path = os.path.join(root, "ckpt-0000000005")
        with pytest.raises(err) as e:
            eng.hot_swap(path, 5)
        errs.append(str(e.value).splitlines()[1:])
    assert errs[0] == errs[1]
    assert any("different weight schema" in line for line in errs[1])
    try:
        before = _both(env, lambda e: (e.active_version,
                                       e.swap_stats.rejected))
        env["jeng"].watch(jroot, poll_interval_s=0.0)
        env["peng"].watch(proot, poll_interval_s=0.0)
        for _ in range(2):   # the second poll skips the blacklisted path
            assert _both(env, lambda e: e.poll_swap(force=True)) == \
                (False, False)
        after = _both(env, lambda e: (e.active_version,
                                      e.swap_stats.rejected))
        assert after[0] == after[1] == (before[1][0], before[1][1] + 1)
    finally:
        _unwatch(env)


@pytest.mark.parametrize("plan,swapped", [("{n}", True), ("{n}!", False)])
def test_param_swap_fault_site_matches_jax(env, tmp_path, plan, swapped):
    """A transient `serve/param_swap` fault costs one retry and the swap
    lands; a permanent one is a swap_failed (counted, not blacklisted) and
    the live version stays, in both packages."""
    jroot, proot = str(tmp_path / "j"), str(tmp_path / "p")
    _snapshot(env, jroot, proot, 7)
    pdir = str(tmp_path / "tel")
    try:
        env["jeng"].watch(jroot, poll_interval_s=0.0,
                          policy=JRetryPolicy(attempts=3, base_delay=0.0))
        env["peng"].watch(proot, poll_interval_s=0.0,
                          policy=RetryPolicy(attempts=3, base_delay=0.0))
        before = _both(env, lambda e: e.active_version)
        jn = jfaults.counts().get("serve/param_swap", 0) + 1
        pn = faults.counts().get("serve/param_swap", 0) + 1
        jfaults.configure("serve/param_swap@" + plan.format(n=jn))
        faults.configure("serve/param_swap@" + plan.format(n=pn))
        jf0 = jfaults.fired().get("serve/param_swap", 0)
        pf0 = faults.fired().get("serve/param_swap", 0)
        tel.configure(pdir)
        try:
            got = _both(env, lambda e: e.poll_swap(force=True))
            fired = (jfaults.fired().get("serve/param_swap", 0) - jf0,
                     faults.fired().get("serve/param_swap", 0) - pf0)
        finally:
            tel.shutdown()
            jfaults.clear()
            faults.clear()
        assert got == (swapped, swapped)
        assert fired[0] == fired[1] == (1 if swapped else 3)
        versions = _both(env, lambda e: e.active_version)
        assert versions[0] == versions[1] == (7 if swapped else before[1])
        names = [e["name"] for e in tel.read_events(pdir)]
        assert names.count("retry") == (1 if swapped else 2)
        assert ("serve/swap_failed" in names) == (not swapped)
        assert ("serve/param_swap" in names) == swapped
        if not swapped:
            # not blacklisted: the next poll, unfaulted, takes it
            assert _both(env, lambda e: e.poll_swap(force=True)) == \
                (True, True)
    finally:
        _unwatch(env)


def _requests(cls):
    rng = np.random.default_rng(3)
    return [cls(rid=i, prompt=[int(x) for x in rng.integers(1, 255, size=n)],
                max_new_tokens=6) for i, n in enumerate((5, 9, 3, 12, 7, 4))]


def test_mid_run_swap_in_a_scheduler_run_matches_jax(env, tmp_path):
    """Snapshot 12 lands in the watched root after the first admission
    wave: the loop swaps once, between windows, no request is lost, the
    streams (mixed across the swap) equal JAX's, and the requests admitted
    after it equal a fresh engine's on the new weights."""
    import os
    jroot, proot = str(tmp_path / "j"), str(tmp_path / "p")
    jstage, pstage = str(tmp_path / "js"), str(tmp_path / "ps")
    _snapshot(env, jroot, proot, 11)
    new_params = _snapshot(env, jstage, pstage, 12)
    out = {}
    try:
        for tag, eng, root, stage, sched_cls, req_cls, pfn, sfn in (
                ("jax", env["jeng"], jroot, jstage, JScheduler, JRequest,
                 jprompt_inputs, jstep_inputs),
                ("port", env["peng"], proot, pstage,
                 ContinuousBatchingScheduler, Request, gpt2_prompt_inputs,
                 gpt2_step_inputs)):
            eng.watch(root, poll_interval_s=0.0)
            assert eng.poll_swap(force=True) and eng.active_version == 11
            prefill = eng.prefill
            swaps = {}

            def publish(p, inputs, eng=eng, root=root, stage=stage,
                        prefill=prefill, swaps=swaps):
                out_ = prefill(p, inputs)
                if not swaps:
                    os.replace(os.path.join(stage, "ckpt-0000000012"),
                               os.path.join(root, "ckpt-0000000012"))
                    swaps["prefills_before"] = 1
                return out_
            eng.prefill = publish
            try:
                sched = sched_cls(eng, eng.params, pfn, sfn, eos_id=None,
                                  dispatch_ahead=2,
                                  reqtrace=True)
                done = sched.run(_requests(req_cls))
            finally:
                del eng.prefill
            out[tag] = (sched, {r.rid: list(r.tokens) for r in done})
            assert sched.stats["swaps"] == 1 and eng.active_version == 12
            assert len(done) == 6 and not sched.shed and not sched.failed
    finally:
        _unwatch(env)
    (js, jdone), (ps, pdone) = out["jax"], out["port"]
    assert pdone == jdone
    assert ps.materializations == js.materializations
    swaps = [tr for tr in ps.tracer.ring
             if any(s["stage"] == "swap" for s in tr["stages"])]
    assert swaps and all(tr["swaps"] == [12] for tr in swaps)
    # requests whose prefill came after the swap: a fresh engine's streams
    late = [tr["rid"] for tr in ps.tracer.ring if not tr["swaps"]
            and tr["rid"] not in [s["rid"] for s in swaps]
            and any(s["stage"] == "prefill" and s["start_s"] > 0
                    for s in tr["stages"])]
    fm = FFModel(FFConfig(**SERVE_KW))
    build_gpt2(fm, GPT2Config(**GPT2_KW), batch=8)
    fresh = compile_serving(fm, max_decode_len=6, device="cpu")
    fresh.load_params(params_from_jax(jax.device_get(new_params)))
    fdone = {r.rid: list(r.tokens) for r in ContinuousBatchingScheduler(
        fresh, fresh.params, gpt2_prompt_inputs, gpt2_step_inputs,
        dispatch_ahead=2).run(_requests(Request))}
    assert late
    assert all(pdone[r] == fdone[r] for r in late)


def test_snapshots_written_by_fit_swap_in(env, tmp_path):
    """The port's `fit` commits durable snapshots; the engine watching its
    root swaps to the newest one, whose weights it then serves (the
    trained params, placed), as JAX's engine does with JAX's fit."""
    proot, jroot = str(tmp_path / "p"), str(tmp_path / "j")
    rng = np.random.default_rng(9)
    ids = rng.integers(1, 256, size=(16, 16)).astype(np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (16, 1))
    y = rng.integers(1, 256, size=(16, 16)).astype(np.int32)
    jcm, pcm = env["jcm"], _ptrainer(GPT2_KW)
    jcm.init(seed=3)
    jcm._iteration = 0
    pcm.load_params(params_from_jax(jax.device_get(jcm.params)))
    jcm.fit([ids, pos], y, batch_size=8, epochs=1, verbose=False,
            checkpoint_dir=jroot, checkpoint_every_steps=1)
    pcm.fit([ids, pos], y, batch_size=8, epochs=1, verbose=False,
            checkpoint_dir=proot, checkpoint_every_steps=1)
    try:
        env["jeng"].watch(jroot, poll_interval_s=0.0)
        env["peng"].watch(proot, poll_interval_s=0.0)
        assert _both(env, lambda e: e.poll_swap(force=True)) == (True, True)
        versions = _both(env, lambda e: e.active_version)
        assert versions[0] == versions[1] == pcm._iteration == 2
        for name, d in pcm.params.items():
            for w, t in d.items():
                assert torch.equal(env["peng"].params[name][w], t), (name, w)
        _probe(env)
    finally:
        _unwatch(env)
