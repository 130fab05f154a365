"""The port's capacity twin (serving/twin.py, tools/twin.py) against the
JAX package's, on the CPU.

Each package replays the same `tracefmt` trace (the generators draw in
the same order from one numpy seed) under the same spec and the same
explicit machine (one object carrying both packages' field names), and
the reports must be equal: stats, histograms, the SLO scoreboard, the
scaling signals. With no machine the port prices by its H100 preset, not
by the TPU constants the JAX twin falls back to. The twin's command line
passes its smoke, and the fleet's and twin's eight flags parse into the
JAX package's fields.
"""

import dataclasses
import json
import subprocess
import sys
import types

import numpy as np
import pytest

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import telemetry as jtel
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.serving import compile_serving as jcompile_serving
from flexflow_tpu.serving import tracefmt as jtracefmt
from flexflow_tpu.serving import twin as jtwin
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.parallel.machine import CHIP_PRESETS
from flexflow_tpu_torch.serving import compile_serving, tracefmt, twin
from flexflow_tpu_torch.tools import twin as twin_cli

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
# one machine both packages read: the port's MachineSpec names its peak
# `flops`, the JAX twin reads `flops_per_chip`
MACHINE = types.SimpleNamespace(hbm_bw=2.0e12, host_bw=25e9, flops=5e14,
                                flops_per_chip=5e14)

SPECS = {
    "one": dict(replicas=1, slo="ttft_p99_ms=500"),
    "two_least_loaded": dict(replicas=2, slo="ttft_p99_ms=200,"
                                            "availability=0.99"),
    "two_round_robin": dict(replicas=2, router="round_robin",
                            slo="ttft_p99_ms=200"),
    "disagg": dict(replicas=3, topology="disagg", prefill_replicas=1,
                   slo="ttft_p99_ms=200"),
    "tiered_int8": dict(replicas=1, host_pages=12, device_pages=8,
                        itemsize=1, scale_itemsize=4, slots=6),
    "spec_admission": dict(replicas=2, spec_tokens=3, queue_cap=3,
                           ttft_budget_ms=150.0, max_context=20,
                           slo="ttft_p99_ms=100,availability=0.9"),
}


def _spec(mod, **kw):
    base = dict(slots=4, seq=16, page_size=4, max_decode_len=8, layers=2,
                heads=2, head_dim=32)
    base.update(kw)
    return mod.TwinSpec(**base)


def _recs(mod, n=40, rate=30.0, seed=0, max_new=8, prompt_len=4):
    return mod.poisson_records(np.random.default_rng(seed), n, rate=rate,
                               vocab=256, prompt_len=prompt_len,
                               max_new=max_new)


def _pair(name, param_bytes=50_000_000, **rec_kw):
    """(port spec, costs, records), (JAX spec, costs, records)."""
    out = []
    for tw, tf in ((twin, tracefmt), (jtwin, jtracefmt)):
        spec = _spec(tw, **SPECS[name])
        costs = tw.TwinCosts.analytic(spec.kv_spec(), MACHINE,
                                      param_bytes=param_bytes)
        out.append((spec, costs, _recs(tf, **rec_kw)))
    return out


def _clean(x):
    """A report with tuples as lists (the comparison is of values)."""
    return json.loads(json.dumps(x, default=float))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_simulate_report_equals_jax(name):
    """The same report, key for key and value for value: stats, the
    histograms, the SLO scoreboard, the scaling signal and its timeline,
    and the costs' source."""
    (spec, costs, recs), (jspec, jcosts, jrecs) = _pair(name)
    assert dataclasses.asdict(costs) == dataclasses.asdict(jcosts)
    res, jres = (twin.simulate(recs, spec, costs, signal_every_s=0.5),
                 jtwin.simulate(jrecs, jspec, jcosts, signal_every_s=0.5))
    assert _clean(res.report()) == _clean(jres.report())
    assert res.completed == jres.completed and res.shed == jres.shed
    assert res.stats["requests"] == 40


def test_simulate_sheds_and_handoffs_match_jax():
    """A load that overflows: sheds by reason and the disagg handoffs
    equal JAX's."""
    for name in ("spec_admission", "disagg"):
        (spec, costs, recs), (jspec, jcosts, jrecs) = _pair(
            name, rate=400.0, prompt_len=6)
        res, jres = (twin.simulate(recs, spec, costs),
                     jtwin.simulate(jrecs, jspec, jcosts))
        assert _clean(res.stats) == _clean(jres.stats)
        assert [r["outcome_reason"] for r in res.shed] == \
            [r["outcome_reason"] for r in jres.shed]
    assert res.stats["handoffs"] == res.stats["completed"] > 0


@pytest.mark.parametrize("name", ["one", "two_least_loaded", "disagg"])
def test_capacity_curve_equals_jax(name):
    (spec, costs, recs), (jspec, jcosts, jrecs) = _pair(name)
    got = twin.capacity_curve(recs, spec, costs, replicas=(1, 2, 3),
                              iters=4)
    want = jtwin.capacity_curve(jrecs, jspec, jcosts, replicas=(1, 2, 3),
                                iters=4)
    assert got == want
    assert [c["replicas"] for c in got] == [1, 2, 3]
    assert all(c["capacity_rps"] > 0 for c in got)


def test_calibrate_window_overhead_and_validate_equal_jax():
    """The window overhead solved from a live wall time, the twin re-run
    with it, and `validate`'s diff of it against live numbers."""
    (spec, costs, recs), (jspec, jcosts, jrecs) = _pair("two_least_loaded")
    for wall in (0.1, 2.5, 9.0):
        w = twin.calibrate_window_overhead(recs, spec, costs, wall)
        assert w == jtwin.calibrate_window_overhead(jrecs, jspec, jcosts,
                                                    wall)
    assert w > 0
    cal = dataclasses.replace(costs, window_overhead_s=w)
    jcal = dataclasses.replace(jcosts, window_overhead_s=w)
    st = twin.simulate(recs, spec, cal).stats
    assert st == jtwin.simulate(jrecs, jspec, jcal).stats
    live = {"tokens_per_s": 110.0, "wall_s": 9.0, "ttft_p99_s": 0.4,
            "missing": None, "only_live": 3.0}
    tw = {"tokens_per_s": st["tokens_per_s"], "wall_s": st["wall_s"],
          "ttft_p99_s": 0.5, "missing": 1.0}
    assert twin.validate(live, tw) == jtwin.validate(live, tw)
    assert twin.validate(live, tw, 0.01) == jtwin.validate(live, tw, 0.01)
    assert twin.validate({}, {}) == jtwin.validate({}, {})


def test_signal_timeline_equals_jax():
    """A steady load, then a burst: the same action transitions at the
    same virtual times; and over a fixed terminal stream."""
    objectives = "ttft_p99_ms=50,availability=0.95"
    terms = []
    for tw, tf in ((twin, tracefmt), (jtwin, jtracefmt)):
        recs = tf.burst_records(np.random.default_rng(4), 60, 20.0, 10.0,
                                0.5, 256, 4, 8)
        spec = _spec(tw, replicas=1, slo=objectives)
        res = tw.simulate(recs, spec, tw.TwinCosts.analytic(
            spec.kv_spec(), MACHINE, param_bytes=400_000_000),
            signal_every_s=0.25)
        terms.append(res.signals)
    assert terms[0] == terms[1] and terms[0]
    from flexflow_tpu.health import parse_slo as jparse_slo
    from flexflow_tpu_torch.health import parse_slo
    stream = [(0.1 * i, {"outcome": "done", "ttft_s": 0.02 * (i % 7),
                         "per_token_s": None, "queue_wait_s": 0.0})
              for i in range(50)]
    assert twin.signal_timeline(stream, parse_slo(objectives), 0.7) == \
        jtwin.signal_timeline(stream, jparse_slo(objectives), 0.7)


def test_resolve_from_a_live_report_equals_jax():
    """The pricing ladder with a live report (summary dicts, and a
    histogram object's mean), the learned rung empty in both."""
    live = {"hists": {"decode_step": {"mean": 0.031, "count": 9},
                      "prefill": {"mean": 0.120, "count": 3}}}
    for report in (live, {"hists": {"decode_step": {"mean": 0.02}}}, {}):
        got = twin.TwinCosts.resolve(_spec(twin).kv_spec(), machine=MACHINE,
                                     live_report=report, step_floor_s=0.025)
        want = jtwin.TwinCosts.resolve(_spec(jtwin).kv_spec(),
                                       machine=MACHINE, live_report=report,
                                       step_floor_s=0.025)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.source == "measured" and twin._learned_costs(
        _spec(twin).kv_spec(), None, MACHINE, 4) == {}
    assert dataclasses.asdict(twin.TwinCosts.from_live_report(
        live, got)) == dataclasses.asdict(jtwin.TwinCosts.from_live_report(
            live, want))


def test_analytic_costs_without_a_machine_are_the_h100_presets():
    """No machine: the roofline reads the H100 preset (HBM 3.35 TB/s,
    host link 64 GB/s, 989 TFLOP/s), not the JAX twin's TPU fallbacks."""
    h100 = CHIP_PRESETS["h100"]
    ks = _spec(twin).kv_spec()
    pb = 100_000_000
    got = twin.TwinCosts.analytic(ks, param_bytes=pb)
    assert got.decode_step_s == (pb + ks.step_read_bytes()) / h100.hbm_bw \
        + 5e-5
    assert got.prefill_per_token_s == 2.0 * (pb // 4) / h100.flops
    assert got.kv_transfer_page_s == ks.layers * ks.page_bytes() / \
        h100.host_bw
    h = types.SimpleNamespace(hbm_bw=h100.hbm_bw, host_bw=h100.host_bw,
                              flops=h100.flops, flops_per_chip=h100.flops)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jtwin.TwinCosts.analytic(_spec(jtwin).kv_spec(), h, param_bytes=pb))
    tpu = jtwin.TwinCosts.analytic(_spec(jtwin).kv_spec(), param_bytes=pb)
    assert tpu.decode_step_s != got.decode_step_s
    assert tpu.kv_transfer_page_s != got.kv_transfer_page_s
    assert ks.step_read_bytes(2) == ks.total_bytes() // 2


def test_twin_spec_from_engine_equals_jax():
    """`TwinSpec.from_engine` on each package's engine of one config."""
    kw = dict(max_batch_slots=4, kv_page_size=4, max_decode_len=6,
              kv_host_pages=8, kv_cache_dtype="int8", serve_queue_cap=5,
              serve_slo="ttft_p99_ms=40", serve_router="round_robin",
              serve_fleet_topology="disagg", serve_replicas=2)
    gkw = dict(vocab=256, seq=16, d_model=64, heads=2, layers=2,
               dropout=0.0)
    jm = JFFModel(JFFConfig(mesh_shape={"data": 1}, log_level="warning",
                            **kw))
    jbuild_gpt2(jm, JGPT2Config(**gkw), batch=8)
    pm = FFModel(FFConfig(**kw))
    build_gpt2(pm, GPT2Config(**gkw), batch=8)
    got = twin.TwinSpec.from_engine(compile_serving(pm, device="cpu"),
                                    replicas=2, dispatch_ahead=3)
    want = jtwin.TwinSpec.from_engine(jcompile_serving(jm), replicas=2,
                                      dispatch_ahead=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.topology == "disagg" and got.scale_itemsize == 4


def test_emit_residual_rows_equal_jax(tmp_path):
    """The residual rows a refit would read: the same kinds, predictions,
    measurements and feature keys."""
    live = {"hists": {"decode_step": {"mean": 0.031},
                      "prefill": {"mean": 0.12}}}
    rows = []
    for tw, t, d in ((twin, tel, "port"), (jtwin, jtel, "jax")):
        t.configure(str(tmp_path / d))
        try:
            spec = _spec(tw).kv_spec()
            n = tw.emit_residual_rows(live, tw.TwinCosts.analytic(
                spec, MACHINE), spec, slots=4)
            t.flush()
            ev = [e["args"] for e in t.read_events(str(tmp_path / d))
                  if e["name"] == "op/attr"]
        finally:
            t.shutdown()
        rows.append((n, [{k: e[k] for k in ("op", "predicted_s",
                                             "measured_s", "key",
                                             "features")} for e in ev]))
    assert _clean(rows[0]) == _clean(rows[1])
    assert rows[0][0] == 2


def test_twin_cli_check_exits_0():
    out = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.tools.twin", "--check"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "twin --check OK" in out.stdout


def test_twin_cli_replays_a_trace(tmp_path):
    """`--twin-trace` replays a recorded trace into `--twin-out`; the
    spec the flags give is JAX's `spec_from_config`'s."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import twin as jtwin_cli
    finally:
        sys.path.pop(0)
    recs = _recs(tracefmt)
    path = str(tmp_path / "trace.jsonl")
    tracefmt.save_trace(path, recs, meta={"seq": 16, "slots": 4})
    argv = ["--twin-trace", path, "--twin-replicas", "2", "--twin-out",
            str(tmp_path / "r.json"), "--serve-slo", "ttft_p99_ms=300",
            "--kv-page-size", "4", "--kv-cache-dtype", "int8",
            "--serve-fleet-topology", "disagg"]
    assert twin_cli.main(argv) == 0
    with open(tmp_path / "r.json") as f:
        rep = json.load(f)
    assert rep["stats"]["completed"] == 40 and rep["stats"]["handoffs"] == 40
    assert rep["costs"]["source"] == "analytic"
    assert len(rep["capacity_curve"]) == 3
    cfg, jcfg = FFConfig.parse_args(argv), JFFConfig.parse_args(argv)
    got = twin_cli.spec_from_config(cfg, recs, {"seq": 16, "slots": 4})
    want = jtwin_cli.spec_from_config(jcfg, recs, {"seq": 16, "slots": 4})
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


FLEET_FIELDS = ("serve_replicas", "serve_fleet_topology",
                "serve_prefill_replicas", "serve_router",
                "serve_rollout_burn_max", "twin_trace", "twin_replicas",
                "twin_out")


@pytest.mark.parametrize("argv", [
    [], ["--serve-replicas", "3", "--serve-fleet-topology", "disagg",
         "--serve-prefill-replicas", "2", "--serve-router", "round_robin",
         "--serve-rollout-burn-max", "1.5", "--twin-trace", "t.jsonl",
         "--twin-replicas", "4", "--twin-out", "r.json"]])
def test_fleet_and_twin_flags_parse_into_jax_fields(argv):
    """The eight flags parse (none raises) into the JAX package's fields,
    with its defaults."""
    jcfg, pcfg = JFFConfig.parse_args(argv), FFConfig.parse_args(argv)
    for f in FLEET_FIELDS:
        assert getattr(pcfg, f) == getattr(jcfg, f), f
        assert getattr(FFConfig(), f) == getattr(JFFConfig(), f), f
    for parse in (JFFConfig.parse_args, FFConfig.parse_args):
        with pytest.raises(SystemExit):
            parse(["--serve-router", "random"])
