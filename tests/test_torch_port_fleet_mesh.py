"""The port's serving fleet over a mesh (two replicas, each SPMD over the
same gloo ranks) against the JAX package's fleet on its CPU mesh.

World 2 ({"model": 2}: the decode search puts the slots on the axis) and
world 4 ({"data": 2, "model": 2}: it shards the heads and the KV pools
with them), GPT-2 at tests/test_torch_port_serving_mesh.py's widths
(vocab 256, seq 16, d 64, 4 heads, 1 layer), 4 slots, pages of 4, 16
host pages on every engine, f32, JAX's weights (`params_from_jax`). 8
requests of 4 new tokens from `tracefmt.poisson_records`. Held, with no
tolerance (every comparison is exact):

- per request id, the port's colocated (least_loaded) and disaggregated
  (1 prefill + 1 decode) streams equal each other, the plain mesh
  scheduler's and JAX's colocated and disaggregated fleets';
- disaggregated, every request is handed off once, imported once, and
  `kv_handoff_bytes` equals JAX's (every head); each rank's host tier took
  that over the heads' degree (`handoff_bytes_rank`);
- every rank's routes, handoff routes and swaps (`fleet.decisions`, also
  `report()["stats"]["order"]`) equal rank 0's; rank 0 alone writes the
  fleet's trace;
- `TwinSpec.from_engine` of the port's engine equals JAX's of JAX's, and
  the twin replays rank 0's trace with costs from the live report, every
  request completing and its report holding the live report's keys;
- at world 4 the rolling swap: replica 0 swaps, then replica 1, nothing
  dropped; with a burn ceiling and an objective every request breaks,
  replica 0 swaps, is rolled back and the rollout freezes (replica 1
  stays), as the port's one-card fleet does;
- a disaggregated fleet of replicas holding other KV heads raises
  `ValueError` naming both layouts;
- the mutation check: the same world-4 fleet with every rank's lock its
  own (a plain `RLock` in place of the turnstile) and the replicas reaching the card
  in another order on alternate ranks wedges in a collective, which the
  rank group's watchdog catches; with the turnstile the same skew serves
  (the colocated run at world 4 carries it).
"""

import numpy as np
import pytest

import _torch_port_ranks as ranks

MOD = __name__
MESHES = {2: {"model": 2}, 4: {"data": 2, "model": 2}}
GC = dict(vocab=256, seq=16, d_model=64, heads=4, layers=1, dropout=0.1)
SERVE = dict(max_batch_slots=4, kv_page_size=4, max_decode_len=4,
             kv_host_pages=16, search_budget=16, strategy_cache=False)
N_REQ = 8
# the mutation check's skew: before each of its first SKEW_CALLS device
# calls, replica (rank % 2) waits SKEW_S, so the replicas reach the card
# in one order on even ranks and the other on odd ones; with the
# turnstile the skewed world-4 fleet serves in ~1 s, so a case still out
# after WEDGE_TIMEOUT_S is wedged
SKEW_S, SKEW_CALLS = 0.05, 30
WEDGE_TIMEOUT_S = 10
# the watchdog of the cases that serve several fleets (~10 s alone; the
# driver's six workers have made such a case 3-6x slower)
RANK_TIMEOUT_S = 180


@pytest.fixture(scope="module", autouse=True)
def _close_groups():
    yield
    ranks.close_all()


def _requests(pkg, seed=1, **kw):
    mod = __import__(f"{pkg}.serving", fromlist=["x"])
    return mod.tracefmt.records_to_requests(mod.tracefmt.poisson_records(
        np.random.default_rng(seed), kw.get("n", N_REQ),
        kw.get("rate", 400.0), 256, 4, 4))


def _streams(done):
    return {r.rid: list(r.tokens) for r in done}


def _jax_engine(mesh, params=None):
    from flexflow_tpu import FFConfig, FFModel
    from flexflow_tpu.models import GPT2Config, build_gpt2
    from flexflow_tpu.serving import compile_serving

    m = FFModel(FFConfig(mesh_shape=dict(mesh), log_level="warning",
                         **SERVE))
    build_gpt2(m, GPT2Config(**GC), batch=8)
    eng = compile_serving(m)
    if params is None:
        eng.init(seed=0)
    else:
        eng.load_params(params)
    return eng


def _port_engine(mesh, **kw):
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2
    from flexflow_tpu_torch.serving import compile_serving

    m = FFModel(FFConfig(mesh_shape=dict(mesh), **{**SERVE, **kw}))
    build_gpt2(m, GPT2Config(**GC), batch=8)
    return compile_serving(m, device="cpu")


def _fleet(pkg, engines, **kw):
    mod = __import__(f"{pkg}.serving", fromlist=["x"])
    return mod.ServingFleet(engines, mod.gpt2_prompt_inputs,
                            mod.gpt2_step_inputs, dispatch_ahead=4, **kw)


def _handoffs(engines, before):
    return ([e.kv.tier_counters["kv_handoffs"] - b["kv_handoffs"]
             for e, b in zip(engines, before)],
            [e.kv.tier_counters["kv_handoff_bytes"] - b["kv_handoff_bytes"]
             for e, b in zip(engines, before)])


def _twin_spec(pkg, engine):
    import dataclasses

    twin = __import__(f"{pkg}.serving.twin", fromlist=["x"])
    return dataclasses.asdict(twin.TwinSpec.from_engine(
        engine, replicas=2, dispatch_ahead=4))


# ------------------------------------------------------------- rank code
class _Skewed:
    """The fleet's device lock, entered late by replica (rank % 2) for its
    first SKEW_CALLS calls."""

    def __init__(self, lock, late: int):
        import threading

        self._inner, self._late = lock, f"fleet-replica-{late}"
        self._local = threading.local()
        self._calls = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __enter__(self):
        import threading
        import time

        depth = getattr(self._local, "depth", 0)
        if not depth and threading.current_thread().name == self._late \
                and self._calls < SKEW_CALLS:
            self._calls += 1
            time.sleep(SKEW_S)
        self._local.depth = depth + 1
        return self._inner.__enter__()

    def __exit__(self, *exc):
        self._local.depth -= 1
        return self._inner.__exit__(*exc)


def _skew_locks():
    """Every fleet built after this call enters its lock skewed."""
    import torch.distributed as dist

    from flexflow_tpu_torch.serving import fleet as fleet_mod

    make = fleet_mod.ServingFleet._device_lock
    if getattr(make, "skewed", False):
        return

    def skewed(self):
        return _Skewed(make(self), dist.get_rank() % 2)
    skewed.skewed = True
    fleet_mod.ServingFleet._device_lock = skewed


def _engines(mesh, params, n=2, **kw):
    """`n` engines on `params` (a full tree; None: each from seed 0)."""
    engs = [_port_engine(mesh, **kw) for _ in range(n)]
    for e in engs:
        if params is None:
            e.init(seed=0)
        else:
            e.load_params(params)
    return engs


def rank_fleets(mesh, params, trace_base, skew):
    import os

    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            gpt2_prompt_inputs,
                                            gpt2_step_inputs)

    me = dist.get_rank()
    engs = _engines(mesh, params)
    out = {"degree": engs[0].kv_shard_degree,
           "twin": _twin_spec("flexflow_tpu_torch", engs[0])}
    with torch.no_grad():
        sched = ContinuousBatchingScheduler(
            engs[0], engs[0].params, gpt2_prompt_inputs, gpt2_step_inputs,
            dispatch_ahead=4)
        out["plain"] = _streams(sched.run(
            _requests("flexflow_tpu_torch", rate=1e9)))
        if skew:
            _skew_locks()
        trace = f"{trace_base}.rank{me}"
        engs[0].cfg.serve_trace_out = trace
        fleet = _fleet("flexflow_tpu_torch", engs, topology="colocated",
                       router="least_loaded")
        out["colocated"] = _streams(fleet.serve(
            _requests("flexflow_tpu_torch")))
        engs[0].cfg.serve_trace_out = ""
        out["report"] = fleet.report()
        out["colocated_decisions"] = out["report"]["stats"]["order"]
        out["wrote_trace"] = os.path.exists(trace)
        out["colocated_assigned"] = [h.assigned for h in fleet.replicas]
        before = [dict(e.kv.tier_counters) for e in engs]
        rank_before = [e.kv.handoff_bytes_rank for e in engs]
        fleet = _fleet("flexflow_tpu_torch", engs, topology="disagg")
        out["disagg"] = _streams(fleet.serve(_requests("flexflow_tpu_torch")))
    out["imports"], out["import_bytes"] = _handoffs(engs, before)
    out["rank_bytes"] = [e.kv.handoff_bytes_rank - b
                         for e, b in zip(engs, rank_before)]
    out["handoffs"] = [h.sched.handoffs for h in fleet.replicas]
    out["disagg_decisions"] = fleet.decisions
    out["free"] = [(len(e.kv.free_host_pages), len(e.kv.free_pages))
                   for e in engs]
    return out


def rank_rolling(mesh, params, staged, root):
    """Run 1: an empty root, snapshot 5 published after the first prefill.
    Run 2: a burn ceiling, every request breaking its objective, snapshot
    6 published after the first prefill. Both snapshots hold the served
    weights, so the streams stay the plain scheduler's."""
    import os

    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.health import SLOTracker, parse_slo

    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            gpt2_prompt_inputs,
                                            gpt2_step_inputs)

    engs = _engines(mesh, params)
    with torch.no_grad():
        out = {"plain": _streams(ContinuousBatchingScheduler(
            engs[0], engs[0].params, gpt2_prompt_inputs, gpt2_step_inputs,
            dispatch_ahead=4).run(_requests("flexflow_tpu_torch",
                                            rate=1e9)))}
        for step, burn in ((5, 0.0), (6, 1.0)):
            if burn:
                for e in engs:
                    e.slo = SLOTracker(parse_slo("ttft_p99_ms=0.001"))
            prefill, published = engs[0].prefill, []

            def publish(p, inputs, prefill=prefill, published=published,
                        step=step):
                res = prefill(p, inputs)
                if not published and dist.get_rank() == 0:
                    os.replace(staged[step], os.path.join(
                        root, os.path.basename(staged[step])))
                published.append(1)
                return res
            engs[0].prefill = publish
            fleet = _fleet("flexflow_tpu_torch", engs,
                           router="round_robin", rollout_burn_max=burn)
            done = fleet.serve(_requests("flexflow_tpu_torch", rate=100.0),
                               watch_root=root, poll_interval_s=0.0)
            del engs[0].prefill
            out[step] = {"streams": _streams(done),
                         "shed": len(fleet.shed), "failed": len(fleet.failed),
                         "swaps": list(fleet.rolling.swaps),
                         "rollbacks": list(fleet.rolling.rollbacks),
                         "halted": fleet.rolling.halted,
                         "versions": [e.active_version for e in engs],
                         "decisions": fleet.decisions}
    return out


def rank_layout_mismatch(mesh):
    """A searched engine (the heads sharded) beside a data-parallel one
    (every head on every rank): disagg refuses them."""
    from flexflow_tpu_torch.serving import (ServingFleet, gpt2_prompt_inputs,
                                            gpt2_step_inputs)

    engs = [_port_engine(mesh), _port_engine(mesh, search_budget=0)]
    layouts = [e.kv.head_layout() for e in engs]
    try:
        ServingFleet(engs, gpt2_prompt_inputs, gpt2_step_inputs,
                     topology="disagg")
    except ValueError as e:
        return layouts, str(e)
    return layouts, None


_KEPT = {}


def rank_engines(mesh):
    """Compile the mutation check's engines (outside its short watchdog)."""
    _KEPT["engines"] = _engines(mesh, None)


def rank_unagreed():
    """The mutation: the fleet's groups made, but each rank's own lock in
    place of the turnstile."""
    import threading

    from flexflow_tpu_torch.serving import fleet as fleet_mod

    agreed = fleet_mod.ServingFleet._device_lock

    def unagreed(self):
        agreed(self)
        return threading.RLock()
    fleet_mod.ServingFleet._device_lock = unagreed
    _skew_locks()
    fleet = _fleet("flexflow_tpu_torch", _KEPT["engines"],
                   router="round_robin")
    return len(fleet.serve(_requests("flexflow_tpu_torch", rate=1e9)))


# ------------------------------------------------------------------ tests
def _jax_params(eng):
    import jax

    from flexflow_tpu_torch.convert import params_from_jax

    return params_from_jax(jax.device_get(eng.params))


@pytest.mark.parametrize("world", [2, 4])
def test_fleets_match_jax_and_each_other(world, tmp_path):
    """Colocated and disaggregated streams, the handoffs and their bytes,
    the decisions on every rank, the trace writer and the twin's spec."""
    from flexflow_tpu_torch.serving import tracefmt, twin

    mesh = MESHES[world]
    j0 = _jax_engine(mesh)
    jengs = [j0, _jax_engine(mesh, j0.params)]
    want = {}
    for topo in ("colocated", "disagg"):
        before = [dict(e.kv.tier_counters) for e in jengs]
        fleet = _fleet("flexflow_tpu", jengs, topology=topo)
        want[topo] = _streams(fleet.serve(_requests("flexflow_tpu")))
    jimports, jbytes = _handoffs(jengs, before)
    assert jimports == [0, N_REQ]
    base = str(tmp_path / "fleet_trace.jsonl")
    outs = ranks.shared(world, MOD).run("rank_fleets", mesh,
                                        _jax_params(j0), base, world == 4,
                                        timeout=RANK_TIMEOUT_S)
    first = outs[0]
    assert len(first["plain"]) == N_REQ
    assert want["colocated"] == want["disagg"] == first["plain"]
    for o in outs:
        assert o["colocated"] == o["disagg"] == o["plain"] == first["plain"]
        assert o["imports"] == jimports
        assert o["import_bytes"] == jbytes
        assert o["handoffs"] == [N_REQ, 0]
        assert o["rank_bytes"] == [b // o["degree"] for b in jbytes]
        assert o["colocated_decisions"] == first["colocated_decisions"]
        assert o["disagg_decisions"] == first["disagg_decisions"]
        assert o["colocated_assigned"] == first["colocated_assigned"]
        assert o["twin"] == _twin_spec("flexflow_tpu", j0)
        assert o["free"] == [(16, e.kv_spec.pool_pages - 1) for e in jengs]
    assert first["degree"] == (2 if world == 4 else 1)
    routes = first["colocated_decisions"]["routes"]
    assert sorted(r for r, _ in routes) == list(range(N_REQ))
    assert set(first["disagg_decisions"]["handoffs"].values()) == {1}
    assert [o["wrote_trace"] for o in outs] == [True] + [False] * (world - 1)
    trace = tracefmt.load_trace(f"{base}.rank0")
    assert len(trace) == N_REQ and trace.meta["source"] == "fleet"
    # the twin replays rank 0's trace with costs from the live report
    spec = twin.TwinSpec(**first["twin"])
    costs = twin.TwinCosts.resolve(spec.kv_spec(), slots=spec.slots,
                                   live_report=first["report"])
    rep = twin.simulate(trace.records, spec, costs).report()
    assert rep["stats"]["completed"] == N_REQ
    assert set(first["report"]) <= set(rep)


def test_rolling_swap_and_rollback_over_the_mesh(tmp_path):
    """Run 1: replica 0 swaps, then replica 1, nothing dropped. Run 2:
    replica 0 swaps, burns, is rolled back, and replica 1 never swaps.
    Every rank saw the same swaps and routes, and the streams are the
    plain scheduler's on those weights."""
    import os

    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2
    from flexflow_tpu_torch.runtime.resilience import save_durable

    mesh = MESHES[4]
    m = FFModel(FFConfig(async_checkpoint=False, max_batch_slots=4))
    build_gpt2(m, GPT2Config(**GC), batch=8)
    pcm = m.compile(SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy",
                    [], device="cpu")
    pcm.init(seed=0)
    params = {n: {w: t.detach().numpy().copy() for w, t in d.items()}
              for n, d in pcm.params.items()}
    staged = {}
    for step in (5, 6):
        pcm._iteration = step
        staged[step] = save_durable(pcm, str(tmp_path / f"stage{step}"),
                                    block=True)
    root = str(tmp_path / "live")
    os.makedirs(root)
    outs = ranks.shared(4, MOD).run("rank_rolling", mesh, params, staged,
                                    root, timeout=RANK_TIMEOUT_S)
    for o in outs:
        assert o == outs[0]
    want, run1, run2 = outs[0]["plain"], outs[0][5], outs[0][6]
    assert len(want) == N_REQ
    for run in (run1, run2):
        assert run["streams"] == want and not run["shed"] and \
            not run["failed"]
    assert run1["swaps"] == [(0, 5), (1, 5)] and not run1["rollbacks"]
    assert not run1["halted"] and run1["versions"] == [5, 5]
    assert run2["swaps"] == [(0, 6)] and run2["rollbacks"] == [(0, 5)]
    assert run2["halted"] and run2["versions"] == [5, 5]
    assert run2["decisions"]["swaps"] == [(0, 6)]


def test_disagg_refuses_replicas_holding_other_heads():
    """The searched engine's pools hold half the heads a rank, the
    data-parallel one's every head: the handoff could not move a rank's
    block, so the fleet raises on every rank, naming both layouts."""
    for layouts, msg in ranks.shared(4, MOD).run("rank_layout_mismatch",
                                                 MESHES[4]):
        assert layouts[0][:2] == (2, 2) and layouts[1][:2] == (1, 4)
        assert msg is not None and "replica 0 (2, 2" in msg and \
            "replica 1 (1, 4" in msg


def test_unagreed_grant_order_wedges():
    """The mutation check: each rank's own lock order (the skew puts the
    replicas on the card in opposite orders on alternate ranks) leaves
    rank 0 inside one replica's collective and rank 1 inside the other's:
    the case does not finish, and the watchdog ends it."""
    group = ranks.shared(4, MOD)
    group.run("rank_engines", MESHES[4])
    with pytest.raises(AssertionError, match="did not finish"):
        group.run("rank_unagreed", timeout=WEDGE_TIMEOUT_S)
