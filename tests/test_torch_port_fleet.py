"""The port's serving fleet (router, in-process replicas, the disaggregated
prefill/decode handoff, the rolling swap) against the JAX package's, on
the CPU.

The control-plane classes (histogram merge, router, rolling controller)
run side by side on the same inputs and fakes in both packages. The
handoff's payload is held element for element against JAX's, in both KV
dtypes. Real fleets serve a small GPT-2 (vocab 256, seq 16, d 64, 2 heads,
2 layers: tools/bench_fleet.py's shapes at 2 layers; 4 slots of pages of
4, 16 host pages, both KV dtypes) on the JAX engine's weights carried
across by `convert.params_from_jax`: the streams are held bitwise (per
request id) against the plain scheduler and JAX's fleet. Where the
assignment itself is compared, the router is `round_robin`: `least_loaded`
reads live signals whose values depend on thread timing.
"""

import dataclasses
import os
import threading

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import telemetry as jtel
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.search.cost_model import KVCacheSpec as JKVCacheSpec
from flexflow_tpu.serving import FleetRouter as JFleetRouter
from flexflow_tpu.serving import RollingSwapController as JRolling
from flexflow_tpu.serving import ServingFleet as JServingFleet
from flexflow_tpu.serving import compile_serving as jcompile_serving
from flexflow_tpu.serving import gpt2_prompt_inputs as jprompt_inputs
from flexflow_tpu.serving import gpt2_step_inputs as jstep_inputs
from flexflow_tpu.serving import merge_histograms as jmerge_histograms
from flexflow_tpu.serving import tracefmt as jtracefmt
from flexflow_tpu.serving.fleet import ReplicaHandle as JReplicaHandle
from flexflow_tpu.serving.kv_cache import PagedKVCache as JPagedKVCache
from flexflow_tpu.serving.reqtrace import \
    StreamingHistogram as JStreamingHistogram
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.runtime.resilience import save_durable
from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                        FleetRouter, KVCacheSpec,
                                        PagedKVCache, ReplicaHandle,
                                        RollingSwapController, ServingFleet,
                                        StreamingHistogram, compile_serving,
                                        gpt2_prompt_inputs, gpt2_step_inputs,
                                        merge_histograms, tracefmt)

GPT2_KW = dict(vocab=256, seq=16, d_model=64, heads=2, layers=2, dropout=0.0)
SERVE_KW = dict(max_batch_slots=4, kv_page_size=4, max_decode_len=4,
                kv_host_pages=16)
KV_DTYPES = ("auto", "int8")
N_REQ = 8


# ------------------------------------------------------------- aggregation
def test_merge_histograms_matches_jax_and_pooled_samples():
    """Bucket for bucket: the port's merge, JAX's merge and one histogram
    fed the pooled samples hold the same counts and quantiles."""
    rng = np.random.default_rng(0)
    per_replica = [np.abs(rng.lognormal(-3.0, 1.5, size=n))
                   for n in (137, 41, 260)]
    hists, jhists = [], []
    for samples in per_replica:
        h, jh = StreamingHistogram(), JStreamingHistogram()
        h.add_many(samples)
        jh.add_many(samples)
        hists.append(h)
        jhists.append(jh)
    merged, jmerged = merge_histograms(hists), jmerge_histograms(jhists)
    pooled = StreamingHistogram()
    pooled.add_many(np.concatenate(per_replica))
    assert np.array_equal(merged.counts, pooled.counts)
    assert np.array_equal(merged.counts, jmerged.counts)
    assert merged.count == jmerged.count == pooled.count == 438
    for q in (0.5, 0.9, 0.99):
        assert merged.quantile(q) == jmerged.quantile(q) == pooled.quantile(q)
    assert merged.mean() == pytest.approx(jmerged.mean(), rel=1e-12)


# ------------------------------------------------------------------ router
class _FakeSched:
    def __init__(self, queue_depth=0, ema_ms=50.0, done=0):
        self.queue_depth = queue_depth
        self._ema_serve_ms = ema_ms
        self.completed = [None] * done
        self.shed = []
        self.failed = []
        self.handoffs = 0


class _FakeSLO:
    def __init__(self, burn):
        self.objectives = {"ttft_p99_ms": {}}
        self._burn = burn
        self.requests = 0       # terminal records observed

    def report(self):
        return {"worst_burn_rate": self._burn}


class _FakeEngine:
    def __init__(self, burn=None, watching=True, swap_ok=True, version=0):
        if burn is not None:
            self.slo = _FakeSLO(burn)
        self.watching = watching
        self._swap_ok = swap_ok
        self.active_version = version
        self.rolled_back = False

    def poll_swap(self, force=False):
        if self._swap_ok:
            self.active_version += 1
            return True
        return False

    def rollback(self):
        self.rolled_back = True
        self.active_version -= 1


# (assigned, done, queue depth, EMA prefill ms, burn) per replica
POOLS = [
    [(5, 2, 0, 50.0, None), (3, 2, 0, 50.0, None)],
    [(3, 2, 4, 100.0, None), (3, 2, 1, 100.0, None), (3, 2, 1, 90.0, None)],
    [(0, 0, 0, 50.0, 3.0), (4, 0, 0, 50.0, 0.1)],
    [(9, 0, 0, 50.0, 3.0), (1, 0, 0, 50.0, 2.0)],
    [(2, 2, 0, 0.0, 0.5), (2, 2, 0, 0.0, None), (7, 1, 3, 20.0, 0.0)],
]


def _pool(handle_cls, rows):
    out = []
    for i, (assigned, done, depth, ema, burn) in enumerate(rows):
        h = handle_cls(i, _FakeEngine(burn=burn))
        h.sched = _FakeSched(queue_depth=depth, ema_ms=ema, done=done)
        h.assigned = assigned
        out.append(h)
    return out


@pytest.mark.parametrize("policy,burn_max", [
    ("least_loaded", 0.0), ("least_loaded", 1.0), ("round_robin", 0.0)])
def test_router_picks_match_jax(policy, burn_max):
    """The same picks, one after another over every pool (each pick adds
    an assignment, as the fleet's pump does), and the same TTFT estimate,
    in both policies and with the burn ceiling."""
    router, jrouter = (FleetRouter(policy, burn_max),
                       JFleetRouter(policy, burn_max))
    for rows in POOLS:
        pool, jpool = _pool(ReplicaHandle, rows), _pool(JReplicaHandle, rows)
        for _ in range(7):
            h, jh = router.pick(pool), jrouter.pick(jpool)
            assert h.index == jh.index
            assert router.estimated_ttft_s(h) == \
                jrouter.estimated_ttft_s(jh)
            h.assigned += 1
            jh.assigned += 1
    for cls in (FleetRouter, JFleetRouter):
        with pytest.raises(ValueError):
            cls("random")
        with pytest.raises(ValueError):
            cls().pick([])


# ------------------------------------------------------------ rolling swap
def _rollout_events(read, tdir):
    return [(e["args"]["replica"], e["args"]["action"], e["args"]["version"])
            for e in read(tdir) if e["name"] == "serve/fleet_rollout"]


def _drive_rollout(ctl_cls, engines, burn_max):
    """A fixed schedule of safe points; replica 0 starts burning after its
    first swap. Returns each call's answer and the controller."""
    ctl = ctl_cls(engines, burn_max=burn_max)
    out = [ctl.at_safe_point(i) for i in (1, 2, 0)]
    if getattr(engines[0], "slo", None) is not None:
        engines[0].slo._burn = 5.0
    out += [ctl.at_safe_point(i) for i in (0, 1, 2, 0, 1, 0)]
    return out, ctl


@pytest.mark.parametrize("burn", [None, 0.0])
def test_rolling_swap_controller_matches_jax(burn, tmp_path):
    """Over fake engines, the same answers at every safe point, the same
    swaps, rollbacks and freeze, and the same `serve/fleet_rollout`
    events in the same order: without SLO objectives the rollout goes
    round the fleet twice; with them, replica 0 burns after its swap, is
    rolled back, and replicas 1 and 2 never swap."""
    tel.configure(str(tmp_path / "port"))
    jtel.configure(str(tmp_path / "jax"))
    try:
        got, ctl = _drive_rollout(
            RollingSwapController, [_FakeEngine(burn=burn)
                                    for _ in range(3)], 1.0)
        want, jctl = _drive_rollout(
            JRolling, [_FakeEngine(burn=burn) for _ in range(3)], 1.0)
        tel.flush()
        jtel.flush()
        events = _rollout_events(tel.read_events, str(tmp_path / "port"))
        jevents = _rollout_events(jtel.read_events, str(tmp_path / "jax"))
    finally:
        tel.shutdown()
        jtel.shutdown()
    assert got == want
    assert ctl.swaps == jctl.swaps and ctl.rollbacks == jctl.rollbacks
    assert ctl.halted == jctl.halted == (burn is not None)
    assert events == jevents and events
    if burn is not None:
        assert events == [(0, "swap", 1), (0, "rollback", 0)]


class _Handoffs:
    def __init__(self, n=0):
        self.handoffs = n


@pytest.mark.parametrize("verdict", ["served", "handed_off", "burned"])
def test_rolling_swap_bakes_until_the_swapped_replica_is_judged(verdict):
    """With a burn ceiling, replica 1 may not swap until replica 0 has
    finished a request since its swap (a terminal record, or a handoff)
    and was judged under the ceiling; a burn in the meantime rolls
    replica 0 back and replica 1 never swaps. JAX's controller, on the
    same safe points, swaps replica 1 right after replica 0 (ROADMAP
    Queue 3)."""
    def drive(ctl_cls):
        engs = [_FakeEngine(burn=0.0) for _ in range(2)]
        ctl = ctl_cls(engs, burn_max=1.0)
        sched0 = _Handoffs()
        out = [ctl.at_safe_point(0, sched0), ctl.at_safe_point(1),
               ctl.at_safe_point(0, sched0), ctl.at_safe_point(1)]
        if verdict == "served":
            engs[0].slo.requests += 1
        elif verdict == "handed_off":
            sched0.handoffs += 1
        else:
            engs[0].slo._burn = 5.0
        out += [ctl.at_safe_point(0, sched0), ctl.at_safe_point(1),
                ctl.at_safe_point(0, sched0)]
        return out, ctl, engs

    got, ctl, engs = drive(RollingSwapController)
    jgot, jctl, _ = drive(JRolling)
    assert jgot[:2] == [True, True] and jctl.swaps[:2] == [(0, 1), (1, 1)]
    assert got[:4] == [True, False, False, False]
    assert ctl.bake_waits >= 2
    if verdict == "burned":
        assert got[4:] == [True, False, False]
        assert ctl.swaps == [(0, 1)] and ctl.rollbacks == [(0, 0)]
        assert ctl.halted and engs[1].active_version == 0
    else:
        assert got[4:] == [False, True, False]
        assert ctl.swaps == [(0, 1), (1, 1)] and not ctl.rollbacks
        assert not ctl.halted and ctl.bake_waits == 3


# ----------------------------------------------------------- the handoff
@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_export_parked_payload_matches_jax(kvd):
    """One committed slot in each package's cache, spilled and exported:
    the payload's position, page count and every layer's host rows (the
    int8 scales included) equal JAX's element for element. Both pools
    hold the JAX commit's values (JAX's jitted commit takes max|x|/127 as
    a product by 1/127, the last bit off the port's quotient on some
    rows). Imported into a second cache the slot lands parked, counts one
    handoff of the reckoned bytes, and its refill and rejoin put the
    exporter's rows back in the device pool."""
    quant = kvd == "int8"
    kw = dict(layers=2, heads=2, head_dim=32, slots=4, pages_per_slot=5,
              page_size=4, itemsize=1 if quant else 4,
              scale_itemsize=4 if quant else 0, host_pages=16,
              device_pages=5)
    layers = ["attn_0", "attn_1"]
    rng = np.random.default_rng(3)
    kvs = {n: {k: rng.standard_normal((4, 16, 2, 32)).astype(np.float32)
               for k in ("k", "v")} for n in layers}
    lengths = np.array([0, 11, 0, 0], np.int32)
    jc = JPagedKVCache(JKVCacheSpec(**kw), layers, quantized=quant)
    pc = PagedKVCache(KVCacheSpec(**kw), layers, device="cpu",
                      quantized=quant)
    for c in (jc, pc):
        c.admit(1, 11, 17)
        c.push()
    jc.commit_prefill(kvs, np.arange(4, dtype=np.int32), lengths)
    for n in layers:
        for key, leaf in jc.state[n].items():
            pc.state[n][key].copy_(torch.from_numpy(np.array(leaf)))
    caches = [pc, jc]
    for c in caches:
        c.spill(1, 0)
    got, want = caches[0].export_parked(1), caches[1].export_parked(1)
    assert got["pos"] == want["pos"] == 11
    assert got["pages"] == want["pages"] == 5
    for n in layers:
        assert set(got["layers"][n]) == set(want["layers"][n])
        for key, rows in want["layers"][n].items():
            np.testing.assert_array_equal(got["layers"][n][key].numpy(),
                                          np.asarray(rows))
    # import into another replica's cache, then the ordinary rotation
    src = caches[0]
    dst = PagedKVCache(src.spec, layers, device="cpu", quantized=quant)
    assert dst.can_import(got)
    dst.import_parked(2, got)
    assert dst.parked_slots() == [2] and dst._pos[2] == 11
    assert 2 not in dst.free_slots()
    tc = dst.tier_counters
    assert tc["kv_handoffs"] == 1
    assert tc["kv_handoff_bytes"] == 2 * 5 * src.spec.page_bytes()
    assert dst.prefetch(2, 0)
    assert not dst.join(2, 4, 2)        # a refill 4 steps ahead: a hit
    pages = torch.tensor(dst._slot_pages[2])
    for n in layers:
        for key, rows in got["layers"][n].items():
            assert torch.equal(dst.state[n][key].index_select(0, pages),
                               rows)
    assert len(dst.free_host_pages) == 16
    src.evict(1)
    short = PagedKVCache(dataclasses.replace(src.spec, host_pages=4),
                         layers, device="cpu", quantized=quant)
    assert not short.can_import(got)
    with pytest.raises(Exception, match="exhausted"):
        short.import_parked(0, got)


# ------------------------------------------------------------------ fleets
def _jax_engine(kvd, params=None):
    m = JFFModel(JFFConfig(mesh_shape={"data": 1}, log_level="warning",
                           kv_cache_dtype=kvd, **SERVE_KW))
    jbuild_gpt2(m, JGPT2Config(**GPT2_KW), batch=8)
    eng = jcompile_serving(m)
    if params is None:
        eng.init(seed=0)
    else:
        eng.load_params(params)
    return eng


def _port_engine(kvd, jparams, **cfg_kw):
    m = FFModel(FFConfig(kv_cache_dtype=kvd, **SERVE_KW, **cfg_kw))
    build_gpt2(m, GPT2Config(**GPT2_KW), batch=8)
    eng = compile_serving(m, device="cpu")
    eng.load_params(params_from_jax(jax.device_get(jparams)))
    return eng


@pytest.fixture(scope="module")
def engines():
    """{kv dtype: {"jax": [2 engines], "port": [2 engines]}}, all on the
    first JAX engine's weights."""
    out = {}
    for kvd in KV_DTYPES:
        j0 = _jax_engine(kvd)
        j1 = _jax_engine(kvd, j0.params)
        out[kvd] = {"jax": [j0, j1],
                    "port": [_port_engine(kvd, j0.params) for _ in range(2)]}
    return out


def _records(seed=1, n=N_REQ, rate=400.0):
    return tracefmt.poisson_records(np.random.default_rng(seed), n, rate,
                                    256, 4, 4)


def _requests(seed=1, **kw):
    return tracefmt.records_to_requests(_records(seed, **kw))


def _jrequests(seed=1, n=N_REQ, rate=400.0):
    return jtracefmt.records_to_requests(jtracefmt.poisson_records(
        np.random.default_rng(seed), n, rate, 256, 4, 4))


def _streams(done):
    return {r.rid: list(r.tokens) for r in done}


def _fleet(engines, **kw):
    return ServingFleet(engines, gpt2_prompt_inputs, gpt2_step_inputs,
                        dispatch_ahead=4, **kw)


def _jfleet(engines, **kw):
    return JServingFleet(engines, jprompt_inputs, jstep_inputs,
                         dispatch_ahead=4, **kw)


@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_one_replica_fleet_is_the_plain_scheduler(engines, kvd):
    """One colocated replica: the plain scheduler's path (no thread, no
    feed, the scheduler's private lock, nothing serialized), the same
    streams and the same prefills, decode steps and materializations
    (every request has arrived at the loop's first pass, so no count
    hangs on the wall clock)."""
    eng = engines[kvd]["port"][0]
    sched = ContinuousBatchingScheduler(eng, eng.params, gpt2_prompt_inputs,
                                        gpt2_step_inputs, dispatch_ahead=4)
    direct = _streams(sched.run(_requests(rate=1e9)))
    fleet = _fleet([eng])
    done = fleet.serve(_requests(rate=1e9))
    h = fleet.replicas[0]
    assert _streams(done) == direct and len(direct) == N_REQ
    assert h.thread is None and h.feed is None and fleet.rolling is None
    assert h.sched.feed is None and h.sched.exec_lock is None
    assert h.sched.engine is eng
    for c in ("prefills", "decode_steps", "materializations"):
        assert getattr(h.sched, c) == getattr(sched, c), c


@pytest.fixture(scope="module")
def fleet_runs(engines):
    """Per KV dtype: the plain scheduler, the port's colocated
    (round_robin) and disagg (1 + 1) fleets, and JAX's colocated
    (round_robin) and disagg fleets, on the same trace."""
    out = {}
    for kvd in KV_DTYPES:
        peng, jeng = engines[kvd]["port"], engines[kvd]["jax"]
        sched = ContinuousBatchingScheduler(
            peng[0], peng[0].params, gpt2_prompt_inputs, gpt2_step_inputs,
            dispatch_ahead=4)
        run = {"plain": _streams(sched.run(_requests()))}
        for name, make, engs, reqs in (("port", _fleet, peng, _requests),
                                       ("jax", _jfleet, jeng, _jrequests)):
            for topo in ("colocated", "disagg"):
                before = [dict(e.kv.tier_counters) for e in engs]
                fleet = make(engs, topology=topo, router="round_robin")
                done = fleet.serve(reqs())
                moved = [e.kv.tier_counters["kv_handoffs"] - b["kv_handoffs"]
                         for e, b in zip(engs, before)]
                moved_b = [e.kv.tier_counters["kv_handoff_bytes"]
                           - b["kv_handoff_bytes"]
                           for e, b in zip(engs, before)]
                run[(name, topo)] = {"streams": _streams(done),
                                     "fleet": fleet, "imports": moved,
                                     "import_bytes": moved_b}
        out[kvd] = run
    return out


@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_fleet_streams_match_each_other_and_jax(fleet_runs, kvd):
    """Per request id, bitwise: the port's colocated and disagg fleets,
    the plain scheduler, and JAX's colocated and disagg fleets. Round
    robin assigns the same requests to the same replicas as JAX's."""
    run = fleet_runs[kvd]
    want = run["plain"]
    assert len(want) == N_REQ
    for key in (("port", "colocated"), ("port", "disagg"),
                ("jax", "colocated"), ("jax", "disagg")):
        assert run[key]["streams"] == want, key
    for topo in ("colocated", "disagg"):
        got = [(h.role, h.assigned) for h in
               run[("port", topo)]["fleet"].replicas]
        jwant = [(h.role, h.assigned) for h in
                 run[("jax", topo)]["fleet"].replicas]
        assert got == jwant, topo


@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_disagg_hands_every_request_off_once(fleet_runs, kvd):
    """Disagg: the prefill replica hands off every request once, the
    decode replica imports each once, the bytes are the spec's reckoning
    and equal JAX's; colocated hands off nothing."""
    run = fleet_runs[kvd]
    port, jax_ = run[("port", "disagg")], run[("jax", "disagg")]
    fleet = port["fleet"]
    pre, dec = fleet.replicas
    assert (pre.role, dec.role) == ("prefill", "decode")
    assert fleet.stats["handoffs"] == pre.sched.handoffs == N_REQ
    assert dec.sched.handoffs == 0 and pre.sched.decode_steps == 0
    assert len(pre.sched.completed) == 0
    assert len(dec.sched.completed) == N_REQ
    assert port["imports"] == [0, N_REQ] == jax_["imports"]
    spec = fleet.engines[0].kv.spec
    pages = fleet.engines[0].kv.pages_needed(4 + 4 + 4)
    assert port["import_bytes"][1] == \
        N_REQ * spec.layers * pages * spec.page_bytes()
    assert port["import_bytes"] == jax_["import_bytes"]
    assert run[("port", "colocated")]["fleet"].stats["handoffs"] == 0
    for e in fleet.engines:
        assert len(e.kv.free_host_pages) == e.kv.host_pages
        assert len(e.kv.free_pages) == e.kv.spec.pool_pages - 1


def _keys(d):
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()
                if k not in ("per_replica",)}
    return None


@pytest.mark.parametrize("topo", ["colocated", "disagg"])
def test_report_keys_and_merged_counts_match_jax(fleet_runs, topo):
    """`report()` has JAX's keys, level by level; the merged histograms
    count what JAX's count for every per-request metric, and the decode
    step's count is each fleet's sum of decode steps."""
    run = fleet_runs["auto"]
    rep = run[("port", topo)]["fleet"].report()
    jrep = run[("jax", topo)]["fleet"].report()
    assert _keys(rep) == _keys(jrep)
    assert set(rep["stats"]["per_replica"][0]) == \
        set(jrep["stats"]["per_replica"][0])
    for m in ("ttft", "per_token", "queue_wait", "prefill"):
        assert rep["hists"][m]["count"] == jrep["hists"][m]["count"] == \
            N_REQ, m
    for r, fl in ((rep, run[("port", topo)]["fleet"]),
                  (jrep, run[("jax", topo)]["fleet"])):
        assert r["hists"]["decode_step"]["count"] == sum(
            h.sched.decode_steps for h in fl.replicas)
    assert rep["scaling"]["action"] == jrep["scaling"]["action"]


# ------------------------------------------------------------ rolling swap
def _trainer():
    m = FFModel(FFConfig(async_checkpoint=False, max_batch_slots=4,
                         kv_page_size=4))
    build_gpt2(m, GPT2Config(**GPT2_KW), batch=8)
    return m.compile(SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy",
                     [], device="cpu")


def test_rolling_swap_over_a_snapshot_root(engines, tmp_path):
    """Two replicas watch an empty root; a trainer commits a snapshot
    after the first prefill. Replica 0 swaps, then replica 1, each once
    and to it, and every request completes."""
    root = str(tmp_path / "root")
    stage = str(tmp_path / "stage")
    cm = _trainer()
    cm.init(seed=7)
    cm._iteration = 5
    staged = save_durable(cm, stage, block=True)
    engs = [_port_engine("auto", engines["auto"]["jax"][0].params)
            for _ in range(2)]
    published = threading.Event()
    prefill = engs[0].prefill

    def prefill_then_publish(p, inputs):
        out = prefill(p, inputs)
        if not published.is_set():
            os.makedirs(root, exist_ok=True)
            os.replace(staged, os.path.join(root, os.path.basename(staged)))
            published.set()
        return out
    engs[0].prefill = prefill_then_publish
    os.makedirs(root)
    fleet = _fleet(engs, router="round_robin")
    done = fleet.serve(_requests(rate=100.0), watch_root=root,
                       poll_interval_s=0.0)
    assert published.is_set()
    assert len(done) == N_REQ and not fleet.shed and not fleet.failed
    assert fleet.rolling.swaps == [(0, 5), (1, 5)]
    assert not fleet.rolling.rollbacks and not fleet.rolling.halted
    assert [e.active_version for e in engs] == [5, 5]
    assert fleet.stats["rollout_swaps"] == 2
    assert [h.sched.stats["swaps"] for h in fleet.replicas] == [1, 1]


def test_a_replica_threads_exception_comes_out_of_serve(engines):
    """A replica thread that dies raises its exception from `serve`, after
    the other replica has been joined (it served its share)."""
    engs = [_port_engine("auto", engines["auto"]["jax"][0].params)
            for _ in range(2)]

    def broken(*a, **kw):
        raise RuntimeError("replica 1's cache is broken")
    engs[1].kv.commit_prefill = broken
    fleet = _fleet(engs, router="round_robin")
    with pytest.raises(RuntimeError, match="replica 1's cache is broken"):
        fleet.serve(_requests())
    assert fleet.replicas[1].error is not None
    assert fleet.replicas[0].error is None
    assert not fleet.replicas[0].thread.is_alive()
    assert len(fleet.replicas[0].sched.completed) == N_REQ // 2


def test_many_replicas_count_every_device_call_under_the_lock(engines):
    """Six replicas (more threads than this machine's cores) under a
    short switch interval: one counter that every replica's prefill and
    decode step bump (a read-modify-write from six threads, serialized by
    the fleet's lock, as the kernels' launch counters are) equals the
    replicas' prefills and decode steps, and every request completes once
    with the plain scheduler's stream."""
    import sys

    jparams = engines["auto"]["jax"][0].params
    engs = [_port_engine("auto", jparams) for _ in range(6)]
    calls = [0]
    for e in engs:
        for name in ("prefill", "decode_step"):
            def bump(*a, __fn=getattr(e, name), **kw):
                n = calls[0]
                out = __fn(*a, **kw)
                calls[0] = n + 1
                return out
            setattr(e, name, bump)
    reqs = _requests(seed=2, n=24, rate=2000.0)
    want = {r.rid: list(r.tokens) for r in ContinuousBatchingScheduler(
        engs[0], engs[0].params, gpt2_prompt_inputs, gpt2_step_inputs,
        dispatch_ahead=4).run(_requests(seed=2, n=24, rate=2000.0))}
    calls[0] = 0
    fleet = _fleet(engs, router="round_robin")
    box = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=lambda: box.setdefault(
            "done", fleet.serve(reqs)))
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive()
    assert _streams(box["done"]) == want and len(want) == 24
    assert [h.assigned for h in fleet.replicas] == [4] * 6
    assert calls[0] == sum(h.sched.prefills + h.sched.decode_steps
                           for h in fleet.replicas)
    locks = {id(h.sched.exec_lock) for h in fleet.replicas}
    assert len(locks) == 1 and fleet.replicas[0].sched.exec_lock is not None
