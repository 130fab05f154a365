"""The port's learned cost model, its refit loop and the learned search
tier against the JAX package's (tests/test_learned_cost.py, without its
two tool smokes of the JAX repo's tools/), on the CPU.

The model is numpy only in both packages: a ridge fit on the same corpus
rows gives equal payloads (to_json) and the same fingerprint, and equal
predictions. Both packages featurize a placed op to the same feature key
(attribution.feature_key over equal feature dicts), so a learned search
of a tiny GPT-2 with the same model file picks the same strategy. The
port's model file defaults under ~/.cache/flexflow_tpu_torch/; every test
here passes its own path.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from flexflow_tpu import AdamOptimizer as JAdamOptimizer
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.parallel.machine import MachineSpec as JMachineSpec
from flexflow_tpu.search import learned_cost as jlc
from flexflow_tpu.search.candidates import layer_candidates as jlayer_candidates
from flexflow_tpu.search.dp import SEARCH_STATS as JSEARCH_STATS
from flexflow_tpu.search.optimize import graph_optimize as jgraph_optimize
from flexflow_tpu.serving import kv_cache as jkv_cache
from flexflow_tpu.serving import twin as jtwin
from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.attribution import OP_EVENT, feature_key
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.search import learned_cost as lc
from flexflow_tpu_torch.search import memo
from flexflow_tpu_torch.search import strategy_cache as sc
from flexflow_tpu_torch.search.candidates import layer_candidates
from flexflow_tpu_torch.search.dp import SEARCH_STATS, reset_search_stats
from flexflow_tpu_torch.search.optimize import graph_optimize
from flexflow_tpu_torch.serving import kv_cache, twin
from flexflow_tpu_torch.tools import refit_cost_model, span_dataset

REL = 1e-12
MESH = {"mesh_axes": {"data": 4, "model": 2}, "chip": "h100"}


def _machines(d=MESH):
    p = MachineSpec.from_json(dict(d))
    return p, JMachineSpec.from_json(p.to_json())


@pytest.fixture(autouse=True)
def _fresh_fastpath():
    memo.clear()
    reset_search_stats()
    yield
    memo.clear()


# ------------------------------------------------------- synthetic corpus
def _features(i, kind="linear", n=64, dtype="float32"):
    return {"op": kind, "dtype": dtype,
            "in_shapes": [[8, n]], "out_shapes": [[8, 2 * n]],
            "weight_shapes": {"kernel": [n, 2 * n]},
            "sharding": {"out": [["data"], []],
                         "weights": {"kernel": [[], []]}},
            "machine": "m0", "name": f"op{i}"}


def _row(i, kind="linear", n=64, measured=None, dtype="float32"):
    feats = _features(i, kind, n, dtype)
    m = measured if measured is not None else 2e-9 * n * n
    return {"schema_version": span_dataset.SCHEMA_VERSION,
            "key": feature_key(feats), "features": feats, "machine": "m0",
            "n": 3, "measured_s": {"mean": m},
            "predicted_s": m * 0.5, "roofline_s": m * 0.25}


def _corpus(k=8, dtype="float32"):
    rows = [_row(i, n=32 * (i + 1), dtype=dtype) for i in range(k)]
    rows += [_row(20 + i, kind="layer_norm", n=16 * (i + 2),
                  measured=1e-6 * (i + 1), dtype=dtype) for i in range(4)]
    return rows


# ------------------------------------------------------- train / predict
@pytest.mark.parametrize("k,dtype", [(8, "float32"), (12, "bfloat16")])
def test_payload_fingerprint_and_predictions_equal_jax(k, dtype, tmp_path):
    rows = _corpus(k, dtype)
    pm, jm = lc.train(rows), jlc.train(rows)
    assert pm.to_json() == jm.to_json()
    assert pm.fingerprint == jm.fingerprint
    # bfloat16 rows (DataType.value, as attribution writes it) read as 2
    # bytes an element
    assert lc._dtype_bytes(dtype) == jlc._dtype_bytes(dtype) == \
        {"float32": 4.0, "bfloat16": 2.0}[dtype]
    queries = [rows[0], _row(99, n=48, dtype=dtype),
               _row(98, kind="layer_norm", n=100, dtype=dtype),
               _row(97, kind="conv2d", dtype=dtype)]
    queries[1]["key"] = queries[2]["key"] = "unseen-key"
    for q in queries:
        p, j = pm.predict_row(q), jm.predict_row(q)
        assert (p is None) == (j is None)
        if p is not None:
            assert p == pytest.approx(j, rel=REL, abs=0.0)
    assert pm.predict_row(rows[0]) == rows[0]["measured_s"]["mean"]
    assert pm.predict_row(queries[3]) is None          # an unseen kind
    mp = str(tmp_path / "cm.json")
    fp = pm.save(mp)
    assert jlc.LearnedCostModel.load(mp).fingerprint == fp
    assert lc.LearnedCostModel.load(mp).to_json() == pm.to_json()
    payload = pm.to_json()
    payload["schema_version"] = 99
    with pytest.raises(ValueError, match="schema"):
        lc.LearnedCostModel.from_json(payload)
    assert lc.mape([(1.1, 1.0), (0.8, 1.0)]) == jlc.mape(
        [(1.1, 1.0), (0.8, 1.0)])


def test_train_skips_unusable_and_small_kinds():
    rows = [_row(i, n=32 * (i + 1)) for i in range(6)]
    rows.append(_row(50, kind="softmax", n=64))
    rows.append({"key": "broken", "features": None,
                 "measured_s": {"mean": None}})
    model = lc.train(rows)
    assert model.meta["kinds_fitted"] == ["linear"]
    assert model.to_json() == jlc.train(rows).to_json()
    assert model.predict_row(rows[6]) == rows[6]["measured_s"]["mean"]
    assert model.predict_features(_features(51, kind="softmax",
                                            n=128)) is None


# ------------------------------------------- the runtime adapter
def _probe(ffm, ffc, batch=16):
    m = ffm(ffc(batch_size=batch))
    x = m.create_tensor([batch, 64], name="x")
    h = m.dense(x, 128, activation="gelu", name="fc1")
    h = m.layer_norm(h, name="ln")
    m.dense(h, 32, name="fc2")
    return m


def test_op_time_coverage_and_pruning_equal_jax():
    """Over every candidate of a dense/layer-norm/dense graph: the learned
    op times, hits and misses, and the pruned candidate sets are JAX's; an
    unseen kind falls back to the analytic price (coverage below 1)."""
    rows = [_row(i, n=32 * (i + 1)) for i in range(8)]
    p_m, j_m = _machines()
    pl = lc.LearnedCost(lc.train(rows), p_m)
    jl = jlc.LearnedCost(jlc.train(rows), j_m)
    pm, jm = _probe(FFModel, FFConfig), _probe(JFFModel, JFFConfig)
    for pl_, jl_ in zip(pm.layers, jm.layers):
        pc = layer_candidates(pl_, p_m, {16})
        jc = jlayer_candidates(jl_, j_m, {16})
        for a, b in zip(pc, jc):
            if a.passthrough:
                continue
            assert pl.op_time(pl_, a) == pytest.approx(
                jl.op_time(jl_, b), rel=REL, abs=0.0)
        pk, pd = pl.prune_candidates(pl_, pc)
        jk, jd = jl.prune_candidates(jl_, jc)
        assert [c.name for c in pk] == [c.name for c in jk] and pd == jd
        assert all(c in pk for c in pc if c.passthrough)
    assert (pl.hits, pl.misses) == (jl.hits, jl.misses)
    assert pl.hits > 0 and pl.misses > 0 and 0 < pl.coverage() < 1
    pl.prune_ratio = None
    fc1 = pm.layers[0]
    cands = layer_candidates(fc1, p_m, {16})
    assert pl.prune_candidates(fc1, cands) == (cands, 0)


# ------------------------------------ the learned search and the cache
def _gpt2_pair(**cfg):
    kw = dict(batch_size=8, strategy_cache=False, **cfg)
    jm, pm = JFFModel(JFFConfig(**kw)), FFModel(FFConfig(**kw))
    jbuild_gpt2(jm, JGPT2Config.tiny(seq=128), batch=8)
    build_gpt2(pm, GPT2Config.tiny(seq=128), batch=8)
    return jm, pm


def _gpt2_rows(pm, p_m):
    """Corpus rows of the tiny GPT-2's own ops on `p_m`: every candidate
    of every linear layer, measured at 0.7x the analytic price, so the
    learned model differs from the roofline."""
    from flexflow_tpu_torch import attribution

    rows = {}
    for layer in pm.layers:
        for cand in layer_candidates(layer, p_m, {8}):
            if cand.passthrough or layer.op_type.value != "linear":
                continue
            feats = attribution.op_features(layer, cand, p_m)
            t = cand.op_time(layer, p_m)
            rows[feature_key(feats)] = {
                "key": feature_key(feats), "features": feats, "n": 1,
                "measured_s": {"mean": 0.7 * t}, "predicted_s": t,
                "roofline_s": t}
    return list(rows.values())


def test_learned_search_picks_jax_s_strategy(tmp_path):
    """A tiny GPT-2 searched under simulator_mode="learned" with the same
    model file in both packages: the same strategy and predicted cost, the
    same pruning, and the port's `search/learned_cost` event carries the
    coverage, hits, misses and fingerprint."""
    mp = str(tmp_path / "cm.json")
    p_m, j_m = _machines()
    _, probe = _gpt2_pair()
    lc.train(_gpt2_rows(probe, p_m)).save(mp)
    jm, pm = _gpt2_pair(search_budget=8, simulator_mode="learned",
                        cost_model_path=mp, simulator_topk=3,
                        telemetry_dir=str(tmp_path / "tele"))
    jm.config.telemetry_dir = ""
    p0, j0 = dict(SEARCH_STATS), dict(JSEARCH_STATS)
    tel.configure(str(tmp_path / "tele"))
    try:
        pst = graph_optimize(pm, p_m, optimizer=AdamOptimizer())
        tel.flush()
        events = tel.read_events(str(tmp_path / "tele"))
    finally:
        tel.shutdown()
    jst = jgraph_optimize(jm, j_m, optimizer=JAdamOptimizer())
    assert pst.to_json() == jst.to_json()
    assert pst._predicted_cost == pytest.approx(jst._predicted_cost,
                                                rel=REL, abs=0.0)
    for k in ("calls", "expansions", "cands_pruned", "finalists_pruned"):
        assert SEARCH_STATS[k] - p0[k] == JSEARCH_STATS[k] - j0[k], k
    ev = [e for e in events if e["name"] == "search/learned_cost"]
    assert len(ev) == 1
    args = ev[0]["args"]
    assert args["coverage"] > 0 and args["hits"] == pst._learned.hits
    assert args["fingerprint"] == lc.LearnedCostModel.load(mp).fingerprint
    assert SEARCH_STATS["cands_pruned"] - p0["cands_pruned"] > 0


def _mlp(cache_dir, model_path, mode="learned", batch=32):
    m = FFModel(FFConfig(batch_size=batch, search_budget=8,
                         strategy_cache_dir=str(cache_dir),
                         simulator_mode=mode, cost_model_path=model_path))
    x = m.create_tensor([batch, 512], name="x")
    h = m.dense(x, 1024, activation="gelu", name="up")
    h = m.dense(h, 512, name="down")
    m.dense(h, 16, name="head")
    return m


def test_refit_invalidates_strategy_cache(tmp_path):
    """The cache key carries the model's content fingerprint: a warm hit
    before a refit, a miss and a new search after; the stored meta carries
    the learned fingerprint and coverage."""
    mp = str(tmp_path / "cm.json")
    lc.train(_corpus()).save(mp)
    p_m, _ = _machines()
    cache = tmp_path / "sc"
    st1 = graph_optimize(_mlp(cache, mp), p_m)
    assert st1._cache_info["event"] == "store" and st1._learned is not None
    meta = json.load(open(next(cache.glob("*.json"))))["meta"]
    assert meta["learned_fingerprint"] == st1._learned.model.fingerprint
    assert meta["learned_coverage"] == st1._learned.coverage()
    fp_before = sc.learned_fingerprint(mp)
    memo.clear()
    reset_search_stats()
    st2 = graph_optimize(_mlp(cache, mp), p_m)
    assert st2._cache_info["event"] == "hit" and SEARCH_STATS["calls"] == 0
    assert st1.to_json() == st2.to_json()
    lc.train(_corpus(10)).save(mp)
    assert sc.learned_fingerprint(mp) != fp_before
    memo.clear()
    reset_search_stats()
    st3 = graph_optimize(_mlp(cache, mp), p_m)
    assert st3._cache_info["event"] == "store" and SEARCH_STATS["calls"] > 0


def test_learned_fingerprint_and_key(tmp_path):
    assert sc.learned_fingerprint(None) == sc.learned_fingerprint("") == ""
    assert sc.learned_fingerprint(str(tmp_path / "no.json")) == \
        "learned:absent"
    mp = str(tmp_path / "cm.json")
    lc.train(_corpus()).save(mp)
    fp = sc.learned_fingerprint(mp)
    from flexflow_tpu.search import strategy_cache as jsc
    assert fp == jsc.learned_fingerprint(mp) and fp.startswith("learned:")
    p_m, _ = _machines()
    m = _mlp(tmp_path / "sc", "", mode="additive")
    base = sc.cache_key(m, p_m, m.config, "", "")
    assert sc.cache_key(m, p_m, m.config, "", "", learned_fp="") == base
    assert sc.cache_key(m, p_m, m.config, "", "", learned_fp=fp) != base


def test_load_for_config_gate_and_default_path(tmp_path, monkeypatch):
    """The learned tier needs simulator_mode="learned" and a readable model
    file; the default path is the port's, never the JAX package's."""
    mp = str(tmp_path / "cm.json")
    lc.train(_corpus()).save(mp)
    p_m, _ = _machines()
    ok = lc.load_for_config(
        FFConfig(simulator_mode="learned", cost_model_path=mp), p_m)
    assert ok is not None and ok.path == mp
    assert lc.load_for_config(
        FFConfig(simulator_mode="additive", cost_model_path=mp), p_m) is None
    assert lc.load_for_config(FFConfig(
        simulator_mode="learned", cost_model_path=str(tmp_path / "no.json")),
        p_m) is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert lc.load_for_config(FFConfig(simulator_mode="learned",
                                       cost_model_path=str(bad)), p_m) is None
    monkeypatch.delenv("FF_COST_MODEL_PATH", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert lc.resolve_model_path(FFConfig()) == os.path.join(
        str(tmp_path), ".cache", "flexflow_tpu_torch", "cost_model.json")
    monkeypatch.setenv("FF_COST_MODEL_PATH", "/x/env.json")
    assert lc.resolve_model_path(FFConfig()) == "/x/env.json"
    assert lc.resolve_model_path(FFConfig(cost_model_path=mp)) == mp


# ------------------------------------------------- telemetry -> refit loop
def _emit_synthetic_ops(tdir, k=5):
    tel.configure(tdir)
    for i in range(k):
        feats = _features(i, n=32 * (i + 1))
        m = 2e-9 * (32 * (i + 1)) ** 2
        tel.event(OP_EVENT, cat="profile", key=feature_key(feats),
                  features=feats, measured_s=m, predicted_s=m * 0.5,
                  roofline_s=m * 0.25, source="measure")
    tel.flush()


def test_refit_roundtrip_and_auto_refit(tmp_path):
    """refit folds a telemetry dir through span_dataset into a model whose
    payload is the one JAX's train gives on the same corpus; auto_refit is
    the same loop behind auto_refit and telemetry_dir, and returns None
    without them."""
    tdir, mp, cp = (str(tmp_path / n)
                    for n in ("tele", "cm.json", "corpus.jsonl"))
    try:
        _emit_synthetic_ops(tdir)
        info = refit_cost_model.refit(tdir, model_path=mp, corpus_path=cp)
        assert info is not None and info["rows"] == 5
        assert "linear" in info["kinds"]
        model = lc.LearnedCostModel.load(mp)
        assert model.fingerprint == info["fingerprint"]
        rows = span_dataset.read_jsonl(cp)
        assert model.to_json() == jlc.train(rows).to_json()
        info2 = refit_cost_model.refit(tdir, model_path=mp, corpus_path=cp)
        assert info2["fingerprint"] == info["fingerprint"]
        assert lc.auto_refit(FFConfig(auto_refit=True)) is None
        assert lc.auto_refit(FFConfig(telemetry_dir=tdir)) is None
        mp2 = str(tmp_path / "cm2.json")
        info3 = lc.auto_refit(FFConfig(telemetry_dir=tdir, auto_refit=True,
                                       cost_model_path=mp2))
        assert info3 is not None and os.path.exists(mp2)
    finally:
        tel.shutdown()
    empty = tmp_path / "empty"
    empty.mkdir()
    fp = lc.LearnedCostModel.load(mp).fingerprint
    assert refit_cost_model.refit(str(empty), model_path=mp,
                                  corpus_path=str(tmp_path / "c.jsonl")) \
        is None
    assert lc.LearnedCostModel.load(mp).fingerprint == fp


def test_auto_refit_fires_after_op_attribution(tmp_path):
    """auto_refit=True on a profiled CPU fit folds that fit's own op/attr
    rows: a model lands at cost_model_path with the fit's measurements in
    its exact table, and the compiled model keeps the info."""
    mp = str(tmp_path / "cm.json")
    try:
        cfg = FFConfig(batch_size=16, only_data_parallel=True,
                       telemetry_dir=str(tmp_path / "tele"),
                       profile_ops=True, auto_refit=True,
                       cost_model_path=mp, epochs=1)
        m = FFModel(cfg)
        x = m.create_tensor([16, 32], name="x")
        m.dense(m.dense(x, 64, activation="relu", name="up"), 4, name="head")
        cm = m.compile(SGDOptimizer(lr=0.05),
                       "sparse_categorical_crossentropy", [], device="cpu")
        cm.fit(np.zeros((32, 32), np.float32), np.zeros((32,), np.int32),
               verbose=False)
    finally:
        tel.shutdown()
    model = lc.LearnedCostModel.load(mp)
    assert model.exact and model.meta["rows"] > 0
    assert cm.refit_info is not None and cm.refit_info["path"] == mp


def test_learned_flags_parse_into_jax_fields():
    argv = ["--simulator-mode", "learned", "--cost-model-path", "/t/cm.json",
            "--auto-refit", "--simulator-topk", "3",
            "--simulator-segment-size", "1048576",
            "--simulator-trace", "t.json"]
    for a in (argv, []):
        p, j = FFConfig.parse_args(a), JFFConfig.parse_args(a)
        for f in ("simulator_mode", "cost_model_path", "auto_refit",
                  "simulator_topk", "simulator_segment_size",
                  "simulator_trace"):
            assert getattr(p, f) == getattr(j, f), f
    with pytest.raises(SystemExit):
        FFConfig.parse_args(["--simulator-mode", "psychic"])
    vf = FFConfig.launcher_value_flags()
    assert {"--cost-model-path", "--simulator-topk"} <= vf
    assert "--auto-refit" not in vf


@pytest.mark.parametrize("tool", [span_dataset, refit_cost_model])
def test_tool_check_on_the_cpu(tool):
    """`python -m flexflow_tpu_torch.tools.<tool> --check --device cpu`:
    a profiled fit, its corpus (and its refit), validated."""
    assert tool.main(["--check", "--device", "cpu"]) == 0
    assert not tel.enabled()


# ----------------------------------------------- the serving rungs
def _serving_rows(pspec, p_m, layers):
    """Twin rows of both kinds and kv_transfer rows, as the twin and the
    KV tier write them."""
    rows = []
    for slots in (1, 2, 4, 8):
        for kind, t in (("twin_decode_step", 1e-3), ("twin_prefill", 5e-3)):
            f = twin._twin_features(kind, pspec, slots, p_m)
            rows.append({"key": feature_key(f), "features": f,
                         "measured_s": {"mean": t * (1 + 0.1 * slots)}})
    for pages in (2, 4, 8, 16):
        moved = layers * pages * pspec.page_bytes()
        f = {"op": "kv_transfer",
             "in_shapes": [[pages, 16, 4, 16]],
             "out_shapes": [[pages, 16, 4, 16]], "weight_shapes": [],
             "dtype": "float32", "params": 0, "layout": "prefetch",
             "sharding": {"out": [], "weights": []},
             "machine": memo.machine_fingerprint(p_m)}
        rows.append({"key": feature_key(f), "features": f,
                     "measured_s": {"mean": moved / 8e9},
                     "predicted_s": moved / p_m.host_bw,
                     "roofline_s": moved / p_m.host_bw})
    return rows


def test_serving_rungs_price_from_a_refit_model(tmp_path):
    """The twin's step/prefill rung and the cache's kv_transfer rung query
    the features `emit_residual_rows` and `_transfer_row` write: with a
    model trained on such rows, both packages return the same prices;
    without a model file, {} and None."""
    from flexflow_tpu.serving.kv_cache import KVCacheSpec as JKVCacheSpec
    from flexflow_tpu_torch.serving import KVCacheSpec

    p_m, j_m = _machines({"mesh_axes": {"data": 1}, "chip": "h100"})
    kw = dict(layers=4, heads=4, head_dim=16, slots=4, pages_per_slot=8,
              page_size=16, host_pages=8)
    pspec, jspec = KVCacheSpec(**kw), JKVCacheSpec(**kw)
    rows = _serving_rows(pspec, p_m, kw["layers"])
    cfg = dataclasses.replace(FFConfig(),
                              cost_model_path=str(tmp_path / "none.json"))
    assert twin._learned_costs(pspec, cfg, p_m, 4) == {}
    assert kv_cache.learned_kv_transfer_seconds(cfg, pspec,
                                                machine=p_m) is None
    mp = str(tmp_path / "cm.json")
    lc.train(rows).save(mp)
    cfg = dataclasses.replace(cfg, cost_model_path=mp)
    jcfg = JFFConfig(cost_model_path=mp)
    got = twin._learned_costs(pspec, cfg, p_m, 4)
    assert set(got) == {"decode_step_s", "prefill_base_s"}
    assert got == jtwin._learned_costs(jspec, jcfg, j_m, 4)
    assert got["decode_step_s"] == pytest.approx(1.4e-3, rel=1e-12)
    costs = twin.TwinCosts.resolve(pspec, cfg, p_m)
    assert costs.source == "learned"
    t = kv_cache.learned_kv_transfer_seconds(cfg, pspec, machine=p_m)
    assert t == pytest.approx(kw["layers"] * 8 * pspec.page_bytes() / 8e9,
                              rel=1e-12)
    assert t == jkv_cache.learned_kv_transfer_seconds(jcfg, jspec,
                                                      machine=j_m)


def test_serving_rungs_read_only_a_model_the_config_names(tmp_path,
                                                          monkeypatch):
    """A model at $FF_COST_MODEL_PATH (or the default path) prices the
    twin and the KV tier only when the config asks for the learned tier:
    a cost_model_path, or simulator_mode="learned"; a corrupt model it
    names raises."""
    from flexflow_tpu_torch.serving import KVCacheSpec

    p_m, _ = _machines({"mesh_axes": {"data": 1}, "chip": "h100"})
    pspec = KVCacheSpec(layers=4, heads=4, head_dim=16, slots=4,
                        pages_per_slot=8, page_size=16, host_pages=8)
    mp = str(tmp_path / "cm.json")
    lc.train(_serving_rows(pspec, p_m, 4)).save(mp)
    monkeypatch.setenv("FF_COST_MODEL_PATH", mp)
    for cfg in (None, FFConfig(), FFConfig(simulator_mode="taskgraph")):
        assert lc.named_model_path(cfg) is None
        assert twin._learned_costs(pspec, cfg, p_m, 4) == {}
        assert kv_cache.learned_kv_transfer_seconds(cfg, pspec,
                                                    machine=p_m) is None
    assert twin.TwinCosts.resolve(pspec, FFConfig(), p_m).source == \
        "analytic"
    for cfg in (FFConfig(simulator_mode="learned"),
                FFConfig(cost_model_path=mp)):
        assert lc.named_model_path(cfg) == mp
        assert set(twin._learned_costs(pspec, cfg, p_m, 4)) == {
            "decode_step_s", "prefill_base_s"}
        assert kv_cache.learned_kv_transfer_seconds(
            cfg, pspec, machine=p_m) > 0
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(ValueError):
        twin._learned_costs(pspec, FFConfig(cost_model_path=str(bad)),
                            p_m, 4)


def test_learned_cost_raises_what_is_not_a_miss(monkeypatch):
    """Only an op the model cannot price is a miss: an error in
    featurizing an op propagates out of op_time and the pruner and is not counted
    as an analytic fallback."""
    from flexflow_tpu_torch import attribution

    p_m, _ = _machines()
    pl = lc.LearnedCost(lc.train([_row(i, n=32 * (i + 1))
                                  for i in range(8)]), p_m)
    pm = _probe(FFModel, FFConfig)
    layer = pm.layers[0]
    cands = [c for c in layer_candidates(layer, p_m, {16})
             if not c.passthrough]
    assert len(cands) > 2

    def broken(*_a, **_k):
        raise RuntimeError("featurization bug")

    monkeypatch.setattr(attribution, "op_features", broken)
    with pytest.raises(RuntimeError, match="featurization bug"):
        pl.op_time(layer, cands[0])
    with pytest.raises(RuntimeError, match="featurization bug"):
        pl.prune_candidates(layer, cands)
    assert (pl.hits, pl.misses) == (0, 0)
