"""The port's serving engine over a mesh against the JAX package's, on the
CPU.

`compile_serving` with `search_budget=16` runs over gloo ranks at world 2
({"model": 2}: the decode search puts the slots on the one axis) and
world 4 ({"data": 2, "model": 2}: it shards the heads, and the KV pools
with them), against JAX's searched engine over its CPU mesh of the same
shape. GPT-2 at tests/test_serving.py's widths (vocab 256, seq 16, d 64,
4 heads, 1 layer), dropout 0.1 in the config (the clones zero it), 4
slots, pages of 4, 6 new tokens, f32. The port loads JAX's weights
(`params_from_jax`); each rank keeps its block. Held:

- the searched strategies identical; `kv_shard_degree`, each rank's pool
  block and `memory_stats`' bytes a device JAX's; with the int8 cache,
  `op_attribution`'s rows (each op's compiled candidate under the
  searched strategies and its serving price) JAX's;
- the prefill's and 4 teacher-forced decode steps' last-position logits
  within `LOGIT_TOL` of the largest |logit| of JAX's call (1e-5 in f32;
  1e-3 for int8 KV, where a K value may land one quantization step away
  when the two packages' f32 projections straddle a rounding boundary);
- the scheduler's continuous batching (7 requests over 4 slots), EOS
  eviction and page backpressure: JAX's tokens and finish order;
- speculative decoding (a self-draft, K = 2; the verify program on the
  decode strategy), the int8 cache, the host tier (12 of the 24 data
  pages on the host: spills and refills) and a hot-swap into the sharded
  layout: JAX's streams (and tier counters);
- clock-driven decisions (open-loop arrivals into free slots, admission
  waves, a deadline shed) made alike on both ranks although rank 1's own clock
  runs 50x faster: the lockstep scheduler takes rank 0's clock. A wedged
  rank would time the case out (the rank group's watchdog).
"""

import numpy as np
import pytest

import _torch_port_ranks as ranks

MOD = __name__
MESHES = {2: {"model": 2}, 4: {"data": 2, "model": 2}}
GC = dict(vocab=256, seq=16, d_model=64, heads=4, layers=1, dropout=0.1)
SERVE = dict(max_batch_slots=4, kv_page_size=4, max_decode_len=6,
             search_budget=16, strategy_cache=False)
LOGIT_TOL = {"auto": 1e-5, "int8": 1e-3}
TF_STEPS = 4
PROMPT_LENS = (3, 5, 7, 2)
MEM_KEYS = ("kv_shard_degree", "predicted_kv_cache_bytes",
            "actual_kv_cache_bytes_per_device", "predicted_param_bytes",
            "actual_param_bytes_per_device", "predicted_kv_host_bytes",
            "actual_kv_host_bytes")


@pytest.fixture(scope="module", autouse=True)
def _close_groups():
    yield
    ranks.close_all()


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 256, size=n)] for n in lens]


def _jax_engine(mesh, gc=GC, draft=False, **kw):
    from flexflow_tpu import FFConfig, FFModel
    from flexflow_tpu.models import GPT2Config, build_gpt2
    from flexflow_tpu.serving import compile_serving

    def build():
        m = FFModel(FFConfig(mesh_shape=dict(mesh), log_level="warning",
                             **SERVE, **kw))
        build_gpt2(m, GPT2Config(**gc), batch=8)
        return m
    if draft:
        return compile_serving(build(), draft=build(), spec_tokens=2)
    return compile_serving(build())


def _port_engine(mesh, gc=GC, draft=False, **kw):
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2
    from flexflow_tpu_torch.serving import compile_serving

    def build():
        m = FFModel(FFConfig(mesh_shape=dict(mesh), **SERVE, **kw))
        build_gpt2(m, GPT2Config(**gc), batch=8)
        return m
    if draft:
        return compile_serving(build(), draft=build(), spec_tokens=2,
                               device="cpu")
    return compile_serving(build(), device="cpu")


def _strategy(st):
    return {n: ({w: list(d) for w, d in sh.weights.items()},
                [list(o) for o in sh.outputs], dict(sh.attrs))
            for n, sh in st.op_shardings.items()}


def _serve(pkg, eng, prompts, max_new=4, dispatch_ahead=3, eos_id=None,
           **kw):
    """(streams, finish order, scheduler) of one scheduler run."""
    mod = __import__(f"{pkg}.serving", fromlist=["x"])
    reqs = [mod.Request(rid=i, prompt=list(p), max_new_tokens=max_new,
                        arrival_s=0.0) for i, p in enumerate(prompts)]
    sched = mod.ContinuousBatchingScheduler(
        eng, eng.params, mod.gpt2_prompt_inputs, mod.gpt2_step_inputs,
        eos_id=eos_id, dispatch_ahead=dispatch_ahead, **kw)
    done = sched.run(reqs)
    return ({r.rid: list(r.tokens) for r in done},
            [r.rid for r in sched.completed], sched)


def _teacher(pkg, eng, prompts, feed=None):
    """Last-position logits (f32 numpy) of a prefill of `prompts` into the
    slots and TF_STEPS decode steps fed `feed` (greedy when None), and
    the tokens fed; the cache is left empty."""
    mod = __import__(f"{pkg}.serving", fromlist=["x"])
    if pkg == "flexflow_tpu":
        import jax.numpy as jnp
        dev = jnp.asarray
    else:
        import torch
        dev = torch.as_tensor
    kv, slots = eng.kv, eng.slots
    seq = int(eng.prefill_model.input_tensors[0].spec.shape[1])
    ids = np.zeros((slots, seq), np.int32)
    lengths = np.zeros((slots,), np.int32)
    for s, p in enumerate(prompts):
        ids[s, :len(p)], lengths[s] = p, len(p)
        kv.admit(s, len(p), len(p) + TF_STEPS + 2)
    kv.push()
    logits, kv_state = eng.prefill(eng.params,
                                   mod.gpt2_prompt_inputs(ids, lengths))
    kv.commit_prefill(kv_state, np.arange(slots, dtype=np.int32), lengths)
    out = [np.asarray(logits)[np.arange(slots), lengths - 1]]
    state, fed = kv.state, []
    for t in range(TF_STEPS):
        tok = (out[-1].argmax(-1) if feed is None else feed[t]).astype(
            np.int32)
        fed.append(tok)
        logits, state = eng.decode_step(
            eng.params, state, mod.gpt2_step_inputs(dev(tok[:, None]),
                                                    state))
        out.append(np.asarray(logits)[:, -1])
    kv.adopt(state)
    kv.sync_after(TF_STEPS)
    for s in range(slots):
        kv.evict(s)
    kv.push()
    return np.stack(out).astype(np.float32), np.stack(fed)


def _priced(eng):
    """op_attribution's rows by program: (layer, candidate, predicted s),
    each op priced by the serving cost functions on its compiled
    candidate (measured beside, on each package's own device)."""
    rep = eng.op_attribution(step_time_s=0.01, prefill_step_time_s=0.02)
    return {tag: sorted((r["layer"], r["candidate"], r["predicted_s"])
                        for r in v["rows"]) for tag, v in rep.items()}


def _jax_params(eng):
    import jax

    from flexflow_tpu_torch.convert import params_from_jax

    return params_from_jax(jax.device_get(eng.params))


# ------------------------------------------------------------- rank code
def rank_programs(mesh, kv, params, feed):
    import torch

    eng = _port_engine(mesh, kv_cache_dtype=kv)
    eng.load_params(params)
    with torch.no_grad():
        logits, _ = _teacher("flexflow_tpu_torch", eng,
                             _prompts(PROMPT_LENS), feed)
        streams, order, _ = _serve("flexflow_tpu_torch", eng,
                                   _prompts([3] * 7, seed=1))
    k = eng.kv.state[eng.attn_layers[0]]["k"]
    mem = eng.memory_stats()
    return {"attribution": _priced(eng) if kv == "int8" else None,
            "prefill": _strategy(eng.prefill_strategy),
            "decode": _strategy(eng.decode_strategy),
            "pool": tuple(k.shape), "mem": {n: mem[n] for n in MEM_KEYS},
            "logits": logits, "streams": streams, "order": order,
            "free": (len(eng.kv.free_slots()), len(eng.kv.free_pages))}


def rank_eos_backpressure(mesh, params):
    import torch

    eng = _port_engine(mesh)
    eng.load_params(params)
    prompt = _prompts([3], seed=2)
    with torch.no_grad():
        ref = _serve("flexflow_tpu_torch", eng, prompt, max_new=5,
                     dispatch_ahead=2)[0][0]
        eos = _serve("flexflow_tpu_torch", eng, prompt, max_new=5,
                     dispatch_ahead=2, eos_id=ref[2])[0][0]
        kvc = eng.kv
        for s in range(eng.slots):
            kvc.admit(s, 1, kvc.spec.padded_len)
        drained = (len(kvc.free_pages), kvc.can_admit(1))
        for s in range(eng.slots):
            kvc.evict(s)
        kvc.push()
        after = _serve("flexflow_tpu_torch", eng, _prompts([2, 2], seed=3),
                       max_new=3, dispatch_ahead=2)[0]
    return {"ref": ref, "eos": eos, "drained": drained, "after": after}


def rank_spec_tier(mesh, params, host_pages):
    import torch

    out = {}
    with torch.no_grad():
        spec = _port_engine(mesh, draft=True)
        spec.load_params(params)
        spec.draft.load_params(params)
        out["verify_on_decode"] = \
            spec._verify_fwd.strategy is spec.decode_strategy
        s, _, sched = _serve("flexflow_tpu_torch", spec,
                             _prompts([3] * 4, seed=4), max_new=6)
        out["spec"] = s
        out["spec_rounds"] = sched.stats["spec_rounds"]
        del spec
        tier = _port_engine(mesh, kv_host_pages=host_pages,
                            kv_prefetch_ahead=2, kv_cache_dtype="int8")
        tier.load_params(params)
        s, _, sched = _serve("flexflow_tpu_torch", tier,
                             _prompts([8] * 6, seed=5), max_new=6,
                             dispatch_ahead=2)
        out["tier"] = s
        out["tier_counters"] = dict(tier.kv.tier_counters)
        out["host_block"] = tuple(
            tier.kv._host[tier.attn_layers[0]]["k"].shape)
    return out


def rank_swap(mesh, params, root):
    import torch
    from torch.distributed.tensor import DTensor

    eng = _port_engine(mesh)
    eng.load_params(params)
    eng.watch(root, poll_interval_s=0.0)
    with torch.no_grad():
        swapped = eng.poll_swap(force=True)
        st, _, _ = _serve("flexflow_tpu_torch", eng, _prompts([4] * 4,
                                                              seed=6))
    wq = eng.params[eng.attn_layers[0]]["wq"]
    return {"swapped": swapped, "version": eng.active_version,
            "streams": st, "wq_placements": [str(p) for p in wq.placements],
            "want_placements": [str(p) for p in
                                eng._w_pl[eng.attn_layers[0], "wq"]],
            "dtensor": isinstance(wq, DTensor)}


def rank_clock(mesh, params):
    """Open-loop arrivals (2 at 0 s, then one every 0.4 s, the last with a
    deadline it cannot meet) into free slots: when each is enqueued,
    admitted or shed is the clock's decision. Rank 1's scheduler clock
    runs 50x fast: without rank 0's clock it would admit other waves than
    rank 0 (and wedge in a collective)."""
    import time

    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.serving import (ContinuousBatchingScheduler,
                                            Request, gpt2_prompt_inputs,
                                            gpt2_step_inputs)
    from flexflow_tpu_torch.serving import scheduler as sch

    eng = _port_engine(mesh)
    eng.load_params(params)
    prompts = _prompts([3] * 9, seed=7)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4,
                    arrival_s=0.0 if i < 2 else 0.4 * (i - 1),
                    deadline_s=1e-9 if i == 8 else None)
            for i, p in enumerate(prompts)]
    if dist.get_rank() == 1:
        t0 = time.perf_counter()

        class Fast:
            @staticmethod
            def perf_counter():
                return t0 + 50.0 * (time.perf_counter() - t0)

            sleep = staticmethod(time.sleep)
        sch.time = Fast
    try:
        with torch.no_grad():
            sched = ContinuousBatchingScheduler(
                eng, eng.params, gpt2_prompt_inputs, gpt2_step_inputs,
                dispatch_ahead=2)
            done = sched.run(reqs)
    finally:
        sch.time = time
    return {"lockstep": sched._lockstep,
            "streams": {r.rid: list(r.tokens) for r in done},
            "order": [r.rid for r in sched.completed],
            "prefills": sched.prefills,
            "shed": sorted((r.rid, r.shed_reason) for r in sched.shed)}


# ------------------------------------------------------------------ tests
def _close_logits(got, want, tol):
    scale = np.abs(want).max(axis=(1, 2))
    err = np.abs(got - want).max(axis=(1, 2)) / scale
    assert (err <= tol).all(), (err, tol)


@pytest.mark.parametrize("world,kv", [(2, "auto"), (4, "auto"),
                                      (4, "int8")])
def test_programs_match_jax(world, kv):
    """The searched programs, the pools' blocks and bytes, the logits and
    the scheduler's streams and finish order: JAX's."""
    mesh = MESHES[world]
    jeng = _jax_engine(mesh, kv_cache_dtype=kv)
    jeng.init(seed=0)
    params = _jax_params(jeng)
    jlogits, feed = _teacher("flexflow_tpu", jeng, _prompts(PROMPT_LENS))
    jstreams, jorder, _ = _serve("flexflow_tpu", jeng,
                                 _prompts([3] * 7, seed=1))
    jk = jeng.kv.state[jeng.attn_layers[0]]["k"]
    jmem = jeng.memory_stats()
    outs = ranks.shared(world, MOD).run("rank_programs", mesh, kv, params,
                                        feed)
    jpriced = _priced(jeng) if kv == "int8" else {}
    for o in outs:
        for tag, rows in jpriced.items():
            got = o["attribution"][tag]
            assert [r[:2] for r in got] == [r[:2] for r in rows], tag
            for g, w in zip(got, rows):
                assert g[2] == pytest.approx(w[2], rel=1e-9), (tag, g, w)
        assert o["prefill"] == _strategy(jeng.prefill_strategy)
        assert o["decode"] == _strategy(jeng.decode_strategy)
        assert o["pool"] == tuple(jk.addressable_shards[0].data.shape)
        assert o["mem"] == {n: jmem[n] for n in MEM_KEYS}
        _close_logits(o["logits"], jlogits, LOGIT_TOL[kv])
        assert o["streams"] == jstreams
        assert o["order"] == jorder
        assert o["free"] == (jeng.slots, jeng.kv_spec.pool_pages - 1)
    assert outs[0]["mem"]["kv_shard_degree"] == (2 if world == 4 else 1)


@pytest.mark.parametrize("world", [2, 4])
def test_eos_eviction_and_page_backpressure_match_jax(world):
    """JAX's `test_scheduler_eos_eviction` and `_page_backpressure` over
    the mesh: the same truncated stream, the same drained free list, the
    same streams once the pages come back."""
    mesh = MESHES[world]
    jeng = _jax_engine(mesh)
    jeng.init(seed=0)
    prompt = _prompts([3], seed=2)
    ref = _serve("flexflow_tpu", jeng, prompt, max_new=5,
                 dispatch_ahead=2)[0][0]
    eos = _serve("flexflow_tpu", jeng, prompt, max_new=5, dispatch_ahead=2,
                 eos_id=ref[2])[0][0]
    assert eos == ref[:ref.index(ref[2]) + 1]
    after = _serve("flexflow_tpu", jeng, _prompts([2, 2], seed=3),
                   max_new=3, dispatch_ahead=2)[0]
    for o in ranks.shared(world, MOD).run("rank_eos_backpressure", mesh,
                                          _jax_params(jeng)):
        assert (o["ref"], o["eos"], o["after"]) == (ref, eos, after)
        assert o["drained"] == (0, False)


def test_speculative_int8_and_host_tier_match_jax():
    """At world 4: the self-draft's speculative streams (the verify
    program on the decode strategy) and the int8 host tier's streams and
    tier counters are JAX's; each rank's host rows hold its heads."""
    mesh, H = MESHES[4], 12
    base = _jax_engine(mesh)
    base.init(seed=0)
    params = _jax_params(base)
    jspec = _jax_engine(mesh, draft=True)
    jspec.load_params(base.params)
    jspec.draft.load_params(base.params)
    want_spec = _serve("flexflow_tpu", jspec, _prompts([3] * 4, seed=4),
                       max_new=6)[0]
    jtier = _jax_engine(mesh, kv_host_pages=H, kv_prefetch_ahead=2,
                        kv_cache_dtype="int8")
    jtier.load_params(base.params)
    want_tier, _, jsched = _serve("flexflow_tpu", jtier,
                                  _prompts([8] * 6, seed=5), max_new=6,
                                  dispatch_ahead=2)
    assert jtier.kv.tier_counters["kv_spills"] > 0
    for o in ranks.shared(4, MOD).run("rank_spec_tier", mesh, params, H):
        assert o["verify_on_decode"] and o["spec_rounds"] > 0
        assert o["spec"] == want_spec
        assert o["tier"] == want_tier
        assert o["tier_counters"] == jtier.kv.tier_counters
        assert o["host_block"] == (H, 4, 4 // jtier.kv_shard_degree, 16)


def test_hot_swap_into_the_sharded_layout(tmp_path):
    """A committed snapshot of other weights, polled over the mesh (rank 0
    reads the root, every rank swaps): each weight lands as the DTensor of
    its decode layout and the streams are JAX's on those weights."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import GPT2Config, build_gpt2
    from flexflow_tpu_torch.runtime.resilience import save_durable

    mesh = MESHES[4]
    jeng = _jax_engine(mesh)
    jeng.init(seed=0)
    first = _jax_params(jeng)
    jeng.init(seed=1)
    second = _jax_params(jeng)
    want = _serve("flexflow_tpu", jeng, _prompts([4] * 4, seed=6))[0]
    m = FFModel(FFConfig(async_checkpoint=False, max_batch_slots=4))
    build_gpt2(m, GPT2Config(**GC), batch=8)
    pcm = m.compile(SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy",
                    [], device="cpu")
    pcm.load_params(second)
    pcm._iteration = 5
    root = str(tmp_path / "snaps")
    save_durable(pcm, root, block=True)
    for o in ranks.shared(4, MOD).run("rank_swap", mesh, first, root):
        assert o["swapped"] and o["version"] == 5
        assert o["dtensor"] and o["wq_placements"] == o["want_placements"]
        assert "S(1)" in o["wq_placements"]
        assert o["streams"] == want


def test_clock_driven_admission_and_shed_keep_the_ranks_in_lockstep():
    """Arrivals, admission waves and a deadline shed decided by the clock:
    both ranks make the same ones, although rank 1's own clock runs 50x
    fast, and serve the same tokens in the same order."""
    mesh = MESHES[2]
    jeng = _jax_engine(mesh)
    jeng.init(seed=0)
    a, b = ranks.shared(2, MOD).run("rank_clock", mesh, _jax_params(jeng),
                                    timeout=60)
    assert a == b and a["lockstep"]
    assert a["shed"] == [(8, "deadline")]
    assert sorted(a["streams"]) == list(range(8))
