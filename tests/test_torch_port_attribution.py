"""Per-op attribution in the PyTorch port (flexflow_tpu_torch/attribution.py
and search/cost_model.op_roofline) against the JAX package's, on the CPU.

- The report's rows on GPT-2 at 2 layers, d 64: the port's measure path
  (MeasuredCost on the CPU) against JAX's rows for the same compile
  (the one-device cpu-sim machine): the same layers, ops, candidates,
  predicted costs, roofline columns and feature keys (1e-12 relative);
  after a fit the attributed times sum to the measured step within
  SUM_TOLERANCE; with telemetry on, tools/span_dataset.py reads the
  op/attr rows.
- `measured_from_trace` on hand-written traces in torch.profiler's Chrome
  format: a layer's name matches whole ("up" does not absorb "update"),
  backward kernels link through the autograd node's sequence number to
  the forward op's layer (a `torch.autograd.Function` too), a CUDA-graph
  replay is left uncredited, and the report states its coverage.
- A `profiling` fit on the CPU writes a torch.profiler trace holding each
  layer's range; with no device work in it, "auto" measures and "trace"
  raises.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest

from flexflow_tpu import AdamOptimizer as JAdamOptimizer
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import attribution as jattr
from flexflow_tpu.core.graph import topo_order as jtopo_order
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
from flexflow_tpu_torch import attribution as pattr
from flexflow_tpu_torch import telemetry as ptel
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.core.tensor import Tensor
from flexflow_tpu_torch.models import GPT2Config, build_gpt2

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import span_dataset  # noqa: E402

GPT = dict(vocab=256, seq=32, d_model=64, heads=2, layers=2, dropout=0.0)
BATCH = 4
REL = 1e-12


@pytest.fixture(autouse=True)
def _clean():
    ptel.shutdown()
    yield
    ptel.shutdown()
    from flexflow_tpu.core.layer import Layer as JLayer
    from flexflow_tpu.core.tensor import Tensor as JTensor

    for a, b in ((JLayer, Layer), (JTensor, Tensor)):
        a._next_guid[0] = b._next_guid[0] = max(a._next_guid[0],
                                                b._next_guid[0])


def _port(**cfg):
    pm = FFModel(FFConfig(batch_size=BATCH, seed=3, **cfg))
    build_gpt2(pm, GPT2Config(**GPT), batch=BATCH)
    pcm = pm.compile(AdamOptimizer(alpha=1e-3),
                     "sparse_categorical_crossentropy", [], device="cpu")
    pcm.init(seed=0)
    return pcm


def gpt2_data(n=16, seed=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, GPT["vocab"], size=(n, GPT["seq"])).astype(np.int32)
    pos = np.broadcast_to(np.arange(GPT["seq"], dtype=np.int32),
                          ids.shape).copy()
    y = rng.integers(0, GPT["vocab"], size=ids.shape).astype(np.int32)
    return [ids, pos], y


def _jax_rows(jcm, tmp_path, step_s):
    """JAX's report for its compile, measured from a trace naming every
    layer once (the trace path: no per-layer measurement)."""
    items = []
    for layer in jtopo_order(jcm.model.layers):
        cand = jcm._candidate_for(layer)
        if not cand.passthrough:
            items.append({"layer": layer, "cand": cand,
                          "machine": jcm.machine, "predicted_s": None,
                          "stage": None})
    d = tmp_path / "jax_trace"
    d.mkdir()
    evs = [{"name": f"{it['layer'].name}/dot", "ph": "X", "ts": 10.0 * i,
            "dur": 5.0} for i, it in enumerate(items)]
    (d / "x.trace.json").write_text(json.dumps({"traceEvents": evs}))
    return jattr.build_report(items, step_time_s=step_s, profile_dir=str(d),
                              source="trace", emit=False)


def test_rows_match_jax_on_the_measure_path(tmp_path):
    """The port's measure path against JAX's rows: every column that does
    not depend on the measured times is JAX's, and so is each row's
    feature key."""
    jm = JFFModel(JFFConfig(batch_size=BATCH, mesh_shape={"data": 1},
                            log_level="warning"))
    jbuild_gpt2(jm, JGPT2Config(**GPT), batch=BATCH)
    jcm = jm.compile(JAdamOptimizer(alpha=1e-3),
                     "sparse_categorical_crossentropy", [])
    pcm = _port()
    assert pcm.machine.to_json() == jcm.machine.to_json()
    step = 0.01
    rep = pcm.op_attribution(step_time_s=step, source="measure",
                             print_table=False)
    want = {r["layer"]: r for r in _jax_rows(jcm, tmp_path, step)["rows"]}
    got = {r["layer"]: r for r in rep["rows"]}
    assert rep["source"] == "measure" and sorted(got) == sorted(want)
    for name, r in got.items():
        w = want[name]
        for k in ("op", "candidate", "bound", "key", "features"):
            assert r[k] == w[k], (name, k)
        for k in ("predicted_s", "roofline_s", "mfu_ceiling", "flops",
                  "device_flops", "hbm_bytes", "machine_flops"):
            assert r[k] == pytest.approx(w[k], rel=REL), (name, k)
        assert r["measured_s"] > 0
    assert rep["attributed_total_s"] == pytest.approx(step, rel=1e-9)
    assert rep["coverage"] == pytest.approx(rep["measured_total_s"] / step)
    lines = pattr.format_report(rep, top=3)
    assert lines[-2].startswith("[ops] source=measure")
    assert lines[-1].startswith("[drift] top-3")


def test_fit_attribution_sums_to_the_step_and_feeds_span_dataset(tmp_path):
    """After a fit the attributed times sum to the drift monitor's
    measured step within SUM_TOLERANCE; profile_ops at fit end emits the
    op/attr and op/drift_topk events, which tools/span_dataset.py reads
    into one corpus row per distinct feature key."""
    tdir = str(tmp_path / "tele")
    pcm = _port(telemetry_dir=tdir, profile_ops=True)
    x, y = gpt2_data()
    pcm.fit(x, y, epochs=2, verbose=False)
    step = pcm.drift_stats()["measured_step_time_s"]
    ptel.flush()
    evs = ptel.read_events(tdir)
    attr = [e for e in evs if e["name"] == pattr.OP_EVENT]
    assert attr and any(e["name"] == pattr.DRIFT_EVENT for e in evs)
    assert {e["args"]["source"] for e in attr} == {"measure"}
    att = sum(e["args"]["attributed_s"] for e in attr)
    assert abs(att - step) / step <= pattr.SUM_TOLERANCE
    assert pattr.SUM_TOLERANCE == jattr.SUM_TOLERANCE
    rows = span_dataset.collect_rows(tdir)
    assert {r["key"] for r in rows} == {e["args"]["key"] for e in attr}
    assert all(r["key"] == pattr.feature_key(r["features"]) for r in rows
               if "features" in r)


# ------------------------------------------------- hand-written traces
def _x(name, cat, ts, dur, tid, **args):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _trace(tmp_path, events, name="fit.pt.trace.json"):
    d = tmp_path / "prof"
    d.mkdir(exist_ok=True)
    (d / name).write_text(json.dumps({"traceEvents": events}))
    return str(d)


def _launch(corr, ts, tid, kernel_ts, dur, name="k"):
    return [_x("cudaLaunchKernel", "cuda_runtime", ts, 2, tid,
               correlation=corr),
            _x(name, "kernel", kernel_ts, dur, 7, correlation=corr,
               device=0)]


def test_trace_names_match_whole_and_backward_links(tmp_path):
    """Forward: a kernel launched inside the "update" range is "update"'s,
    never "up"'s. Backward: a kernel launched inside an
    evaluate_function on autograd's thread goes to the layer whose range
    held the forward op of the same (sequence number, forward thread); of
    two forward ops recording one pair, the later one created the node.
    A torch.autograd.Function's backward links the same way. A node made
    by an op outside every range (the loss) credits nothing, though a
    layer's op recorded its pair first. A graph replay's kernels
    (cudaGraphLaunch outside every range) and the device mirror of a
    range are not credited."""
    main, bwd = 100, 200
    evs = [
        _x("up", "user_annotation", 0, 100, main),
        _x("aten::mm", "cpu_op", 10, 20, main, **{
            "Sequence number": 5, "Fwd thread id": 1}),
        *_launch(1, 12, main, 1000, 30, "gemm_up"),
        _x("update", "user_annotation", 100, 100, main),
        # records pair 6 without making a node; the next op makes it
        _x("aten::view", "cpu_op", 110, 5, main, **{
            "Sequence number": 6, "Fwd thread id": 1}),
        *_launch(2, 120, main, 1100, 40, "gemm_update"),
        _x("attn", "user_annotation", 200, 100, main),
        _x("aten::relu", "cpu_op", 205, 5, main, **{
            "Sequence number": 6, "Fwd thread id": 1}),
        _x("FlashAttentionFunction", "cpu_op", 210, 50, main, **{
            "Sequence number": 9, "Fwd thread id": 1}),
        *_launch(3, 220, main, 1200, 50, "flash_fwd"),
        _x("attn", "gpu_user_annotation", 1190, 80, 7),
        # backward on autograd's thread
        _x("autograd::engine::evaluate_function: FlashAttentionFunction"
           "Backward", "cpu_op", 400, 60, bwd, **{
               "Sequence number": 9, "Fwd thread id": 1}),
        _x("aten::empty", "cpu_op", 405, 3, bwd),
        # the node's own record carries its pair, later than the forward
        _x("FlashAttentionFunctionBackward", "cpu_op", 406, 50, bwd, **{
            "Sequence number": 9, "Fwd thread id": 1}),
        *_launch(4, 410, bwd, 1300, 60, "flash_dq"),
        *_launch(5, 420, bwd, 1360, 70, "flash_dkv"),
        _x("autograd::engine::evaluate_function: ReluBackward0", "cpu_op",
           470, 20, bwd, **{"Sequence number": 6, "Fwd thread id": 1}),
        *_launch(6, 475, bwd, 1430, 10, "relu_bwd"),
        _x("autograd::engine::evaluate_function: MmBackward0", "cpu_op",
           500, 30, bwd, **{"Sequence number": 5, "Fwd thread id": 1}),
        _x("MmBackward0", "cpu_op", 503, 25, bwd, **{
            "Sequence number": 5, "Fwd thread id": 1}),
        _x("aten::mm", "cpu_op", 505, 20, bwd, **{
            "Sequence number": 0, "Fwd thread id": 2}),
        *_launch(7, 510, bwd, 1450, 25, "gemm_up_bwd"),
        # the loss, after every range: its op records pair 10 after the
        # last layer's op recorded it without making the node
        _x("lm", "user_annotation", 300, 20, main),
        _x("aten::view", "cpu_op", 305, 5, main, **{
            "Sequence number": 10, "Fwd thread id": 1}),
        _x("aten::log_softmax", "cpu_op", 330, 5, main, **{
            "Sequence number": 10, "Fwd thread id": 1}),
        _x("autograd::engine::evaluate_function: LogSoftmaxBackward0",
           "cpu_op", 390, 8, bwd, **{"Sequence number": 10,
                                     "Fwd thread id": 1}),
        *_launch(10, 392, bwd, 1290, 8, "loss_bwd"),
        # the optimizer and a graph replay: no layer
        *_launch(8, 600, main, 1500, 20, "adam"),
        _x("cudaGraphLaunch", "cuda_runtime", 700, 5, main, correlation=9),
        _x("replayed", "kernel", 1600, 100, 7, correlation=9),
    ]
    d = _trace(tmp_path, evs)
    names = ["up", "update", "attn", "lm"]
    att = pattr.trace_attribution(d, names)
    assert att["layers"] == {"up": 55.0, "update": 40.0, "attn": 190.0}
    assert att["kernels"]["attn"] == {"flash_fwd": 50.0, "flash_dq": 60.0,
                                      "flash_dkv": 70.0, "relu_bwd": 10.0}
    assert att["device_us"] == 413.0 and att["credited_us"] == 285.0
    assert pattr.measured_from_trace(d, names) == att["layers"]
    assert pattr.measured_from_trace(str(tmp_path / "none"), names) is None
    # JAX's rule on its own trace shape: the same whole-name credit
    jd = tmp_path / "jax"
    jd.mkdir()
    (jd / "t.trace.json").write_text(json.dumps({"traceEvents": [
        {"name": "update/dot", "ph": "X", "ts": 0, "dur": 40},
        {"name": "fusion", "ph": "X", "ts": 0, "dur": 55,
         "args": {"long_name": "up/dot"}}]}))
    assert jattr.measured_from_trace(str(jd), names) == {"up": 55.0,
                                                         "update": 40.0}


def test_trace_report_states_source_and_coverage(tmp_path):
    """source="trace" on a compile whose layers the trace names: the
    measured times are each layer's share of the credited device time,
    scaled to the step; coverage is the credited share of the trace's
    device time."""
    pcm = _port()
    layers = [l.name for l in pcm.model.layers
              if not pcm._candidate_for(l).passthrough]
    evs = []
    for i, name in enumerate(layers):
        evs.append(_x(name, "user_annotation", 100 * i, 50, 1))
        evs += _launch(i, 100 * i + 10, 1, 10000 + 100 * i, 10 + i)
    evs += _launch(999, 5000, 1, 20000, 200, "adam")
    pcm.cfg.profiling, pcm.cfg.profile_dir = True, _trace(tmp_path, evs)
    rep = pcm.op_attribution(step_time_s=0.02, source="trace",
                             print_table=False)
    credited = sum(10 + i for i in range(len(layers)))
    assert rep["source"] == "trace"
    assert rep["coverage"] == pytest.approx(credited / (credited + 200))
    by = {r["layer"]: r for r in rep["rows"]}
    for i, name in enumerate(layers):
        assert by[name]["measured_s"] == pytest.approx(
            0.02 * (10 + i) / credited)
    assert rep["attributed_total_s"] == pytest.approx(0.02)
    assert rep["trace"]["device_us"] == credited + 200
    with pytest.raises(ValueError, match="measured step time"):
        pcm.op_attribution(step_time_s=None, source="trace",
                           print_table=False)


def test_profiling_fit_writes_a_trace_with_layer_ranges(tmp_path):
    """profiling on the CPU: the fit runs under torch.profiler and writes
    its Chrome trace under profile_dir, each layer's lowering in a range
    of its name; it holds no device work, so "trace" raises and "auto"
    measures."""
    pdir = str(tmp_path / "prof")
    pcm = _port(profiling=True, profile_dir=pdir)
    assert pcm.forward_fn.layer_ranges
    x, y = gpt2_data(8)
    pcm.fit(x, y, epochs=1, verbose=False, steps_per_dispatch=2)
    assert pcm.step_stats["fused_steps"] == 0   # profiled: one a dispatch
    files = [f for f in os.listdir(pdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(pdir, files[0])) as f:
        evs = json.load(f)["traceEvents"]
    ranges = {e["name"] for e in evs if e.get("cat") == "user_annotation"}
    assert {l.name for l in pcm.model.layers} <= ranges
    with pytest.raises(ValueError, match="no parseable profiler trace"):
        pcm.op_attribution(source="trace", print_table=False)
    assert pcm.op_attribution(print_table=False)["source"] == "measure"
    assert not _port().forward_fn.layer_ranges
