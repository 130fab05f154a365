"""The port's strategy search against the JAX package's, on the CPU.

The same graphs, built in both packages, are priced and searched on the
same machine description: GPT-2 `tiny(seq=128)` at batch 8 and the wide
MLP of tests/test_search.py (hidden 8192, batch 32), on a
{"data": 4, "model": 2} mesh of the "cpu-sim" chip (whose numbers both
packages keep), with search budgets of 8. Costs must agree to a relative
1e-12 (they are the same float sums in the same order) and searched
strategies must be identical. Seq 128, not 64: the JAX package's flash
gate refuses seq 64 (its blocks are 128 rows or more) while the port's
CUDA gate admits it, and the attention costs of the two packages differ
wherever one gate admits and the other refuses (`test_flash_gates_diverge`).
JAX runs with `strategy_cache=False` except where the cache is tested.
"""

import json

import pytest

from flexflow_tpu import AdamOptimizer as JAdamOptimizer
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.ops.registry import get_op_def as jget_op_def
from flexflow_tpu.ops.registry import io_bytes as jio_bytes
from flexflow_tpu.parallel.machine import MachineSpec as JMachineSpec
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu.search.candidates import layer_candidates as jlayer_candidates
from flexflow_tpu.search.dp import search_graph as jsearch_graph
from flexflow_tpu.search.optimize import graph_optimize as jgraph_optimize
from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
from flexflow_tpu_torch.compiler.compile import _search_machine
from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.ops.registry import get_op_def, io_bytes
from flexflow_tpu_torch.parallel.default_strategy import data_parallel_strategy
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.parallel.sharding import Strategy
from flexflow_tpu_torch.parallel.templates import megatron_strategy
from flexflow_tpu_torch.search import cost_model as cm
from flexflow_tpu_torch.search import strategy_cache as sc
from flexflow_tpu_torch.search.candidates import layer_candidates
from flexflow_tpu_torch.search.dp import (SEARCH_STATS, reset_search_stats,
                                          search_graph)
from flexflow_tpu_torch.search.measure import MeasuredCost
from flexflow_tpu_torch.search.optimize import (graph_optimize,
                                                mcmc_optimize, strategy_cost)
from flexflow_tpu_torch.serving import compile_serving

MESH = {"data": 4, "model": 2}
BATCH, BUDGET = 8, 8
REL = 1e-12

# machine descriptions both packages read: the CPU stand-in, an H100
# node pair with its data axis across the network, and a torus whose
# model axis is a line (ring collectives at half rate)
MACHINES = [
    {"mesh_axes": MESH, "chip": "cpu-sim"},
    {"mesh_axes": {"data": 2, "model": 8}, "chip": "h100",
     "dcn_axes": ["data"]},
    {"mesh_axes": MESH, "chip": "cpu-sim", "axis_type": {"model": "line"},
     "hbm_bytes": 2e9},
]


def _machines(d):
    """The same machine in both packages: the port's spec (preset filled
    in) and JAX's read from its JSON."""
    p = MachineSpec.from_json(dict(d))
    return p, JMachineSpec.from_json(p.to_json())


def _gpt2_pair(seq=128, **cfg):
    kw = dict(batch_size=BATCH, strategy_cache=False, **cfg)
    jm, pm = JFFModel(JFFConfig(**kw)), FFModel(FFConfig(**kw))
    jbuild_gpt2(jm, JGPT2Config.tiny(seq=seq), batch=BATCH)
    build_gpt2(pm, GPT2Config.tiny(seq=seq), batch=BATCH)
    return jm, pm


def _mlp_pair(hidden=8192, batch=32, **cfg):
    """tests/test_search.py's build_big_mlp in both packages."""
    out = []
    for ffm, ffc in ((JFFModel, JFFConfig), (FFModel, FFConfig)):
        m = ffm(ffc(batch_size=batch, strategy_cache=False, **cfg))
        x = m.create_tensor([batch, hidden], name="x")
        h = m.dense(x, hidden, activation="gelu", name="up")
        h = m.dense(h, hidden, name="down")
        m.dense(h, 64, name="head")
        out.append(m)
    return out


def _close(a, b, rel=REL):
    assert a == pytest.approx(b, rel=rel, abs=0.0), (a, b)


# ------------------------------------------------------------- machine
@pytest.mark.parametrize("d", MACHINES)
def test_machine_json_reads_across_packages(d):
    p, j = _machines(d)
    assert j.to_json() == p.to_json()
    assert MachineSpec.from_json(j.to_json()).to_json() == p.to_json()
    for ax in p.mesh_axes:
        assert j.axis_bw_eff(ax) == p.axis_bw_eff(ax)
    # a JAX-written file with a TPU chip reads in the port when it names
    # every number (the port keeps no TPU preset)
    v5p = JMachineSpec(mesh_axes=MESH, chip="v5p")
    assert MachineSpec.from_json(v5p.to_json()).to_json() == v5p.to_json()


def test_h100_preset_and_detect_on_cpu():
    m = MachineSpec(mesh_axes={"data": 1, "model": 8})
    assert m.chip == "h100" and m.flops == 989e12 and m.hbm_bw == 3.35e12
    assert m.ici_bw == {"data": 450e9, "model": 450e9}
    assert m.axis_type == {"data": "switch", "model": "switch"}
    two = MachineSpec(mesh_axes={"data": 2, "model": 8}, dcn_axes=("data",))
    assert two.axis_bw("data") == 50e9 and two.axis_topology("data") == "switch"
    cpu = MachineSpec.detect(device="cpu")
    assert (cpu.chip, cpu.mesh_axes) == ("cpu-sim", {"data": 1})
    with pytest.raises(ValueError, match="no preset for chip 'v5e'"):
        MachineSpec(mesh_axes=MESH, chip="v5e")


def test_multi_gpu_host_compiles_on_one_device(monkeypatch):
    """On a host that shows eight H100s, a compile without a machine file
    describes the one device it executes on and takes the data-parallel
    strategy there; nothing is timed at detection."""
    import types

    import torch

    from flexflow_tpu_torch.compiler.compile import (_pick_strategy,
                                                     resolve_machine)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: types.SimpleNamespace(total_memory=2**36))
    _, pm = _gpt2_pair()
    for dev in ("cuda", "cuda:0"):
        m = resolve_machine(pm.config, dev)
        assert (m.chip, m.mesh_axes, m.num_devices) == ("h100", {"data": 1}, 1)
        assert m.hbm_bytes == 2**36 and m.host_bw == 64e9
        st = _pick_strategy(pm, m, AdamOptimizer(), torch.device(dev))
        assert st.to_json() == data_parallel_strategy(pm, m).to_json()
        assert st.name == "data_parallel" and st.mesh_axes == {"data": 1}


def test_search_flags_parse_as_in_jax():
    argv = ["--budget", "8", "--alpha", "1.2", "--only-data-parallel",
            "--no-enable-parameter-parallel", "--no-enable-attribute-parallel",
            "--search-num-nodes", "2", "--search-num-workers", "8",
            "--memory-search", "--substitution-json", "r.json",
            "--no-strategy-cache", "--strategy-cache-dir", "c",
            "--simulator-mode", "taskgraph", "--machine-model-file", "m.json",
            "--profiling", "--pipeline-stages", "2", "--remat-search"]
    got, want = FFConfig.parse_args(argv), JFFConfig.parse_args(argv)
    fields = ("search_budget", "search_alpha", "only_data_parallel",
              "enable_parameter_parallel", "enable_attribute_parallel",
              "search_num_nodes", "search_num_workers", "memory_search",
              "substitution_json", "strategy_cache", "strategy_cache_dir",
              "simulator_mode", "machine_model_file", "profiling",
              "pipeline_stages", "remat_search")
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f
        assert getattr(FFConfig(), f) == getattr(JFFConfig(), f), f


# ------------------------------------------------------------- costs
@pytest.mark.parametrize("d", MACHINES)
def test_collective_reshard_roofline_grad_sync_costs(d):
    p, j = _machines(d)
    spec = TensorSpec((1024, 512))
    jspec = jcm.TensorSpec((1024, 512))
    ax = tuple(p.mesh_axes)
    for b in (4096.0, 3.7e6):
        for axes in (ax[:1], ax[1:], ax):
            _close(cm.all_gather_time(b, axes, p), jcm.all_gather_time(b, axes, j))
            _close(cm.all_reduce_time(b, axes, p), jcm.all_reduce_time(b, axes, j))
            _close(cm.reduce_scatter_time(b, axes, p),
                   jcm.reduce_scatter_time(b, axes, j))
            _close(cm.all_to_all_time(b, axes, p),
                   jcm.all_to_all_time(b, axes, j))
    a0, a1 = ax
    layouts = [[None, None], [a0, None], [None, a1], [a1, None], [a0, a1],
               [(a0, a1), None]]
    for src in layouts:
        for dst in layouts:
            _close(cm.reshard_time(spec, src, dst, p),
                   jcm.reshard_time(jspec, src, dst, j))
    for fl, by, deg in ((1e12, 1e8, 1), (3e9, 5e9, 8), (7.5e10, 2e7, 2)):
        assert cm.roofline_split(fl, by, p, deg) == \
            jcm.roofline_split(fl, by, j, deg)
        assert cm.compute_time(fl, by, p, deg, True) == \
            jcm.compute_time(fl, by, j, deg, True)
    jm, pm = _gpt2_pair()
    for jl, pl in zip(jm.layers, pm.layers):
        for dims in ({}, {w: [None, a1] for w, s in pl.weight_specs.items()
                          if s.ndim == 2}):
            for zero in (False, True):
                _close(cm.grad_sync_time(pl.weight_specs, dims, p, [a0], zero),
                       jcm.grad_sync_time(jl.weight_specs, dims, j, [a0], zero))


def test_flops_and_io_bytes_per_layer():
    jm, pm = _gpt2_pair()
    assert [l.name for l in jm.layers] == [l.name for l in pm.layers]
    for jl, pl in zip(jm.layers, pm.layers):
        assert jl.params == pl.params, pl.name
        assert get_op_def(pl.op_type).flop_count(pl) == \
            jget_op_def(jl.op_type).flop_count(jl), pl.name
        assert io_bytes(pl) == jio_bytes(jl), pl.name


@pytest.mark.parametrize("which", ["gpt2", "mlp"])
def test_layer_candidates_equal(which):
    jm, pm = _gpt2_pair() if which == "gpt2" else _mlp_pair()
    p, j = _machines(MACHINES[0])
    bs = {t.shape[0] for t in pm.input_tensors}
    jopt = jcm.opt_mem_spec(JAdamOptimizer(), jm.config, j)
    popt = cm.opt_mem_spec(AdamOptimizer(), pm.config, p)
    assert popt == jcm_to_port(jopt)
    for jl, pl in zip(jm.layers, pm.layers):
        jc, pc = jlayer_candidates(jl, j, bs), layer_candidates(pl, p, bs)
        assert [c.name for c in pc] == [c.name for c in jc], pl.name
        for a, b in zip(pc, jc):
            assert (a.in_dims, a.out_dims, a.weight_dims) == \
                (b.in_dims, b.out_dims, b.weight_dims)
            _close(a.op_time(pl, p), b.op_time(jl, j))
            _close(a.extra_comm, b.extra_comm)
            for om, jom in ((None, None), (popt, jopt)):
                assert a.weight_mem_bytes(pl, p, om) == \
                    b.weight_mem_bytes(jl, j, jom)


def jcm_to_port(o):
    return cm.OptMemSpec(o.moments, o.state_itemsize, o.zero_axes)


@pytest.mark.parametrize("which", ["gpt2", "mlp"])
def test_search_graph_same_choices_and_cost(which):
    jm, pm = _gpt2_pair() if which == "gpt2" else _mlp_pair()
    p, j = _machines(MACHINES[0])
    for beam in (16, 64):
        jr = jsearch_graph(jm, j, beam_width=beam)
        pr = search_graph(pm, p, beam_width=beam)
        assert {k: c.name for k, c in pr.choices.items()} == \
            {k: c.name for k, c in jr.choices.items()}
        _close(pr.cost, jr.cost)
        assert pr.mem_bytes == jr.mem_bytes
    if which == "mlp":  # tests/test_search.py's expectation holds here too
        assert pr.choices["up"].name.startswith("tp_col")


def _rule(tmp_path):
    """A reference-format rule (partition then combine over the same
    degree-2 dim is a replicate), instantiated on the model axis."""
    rule = {"rule": [{
        "name": "partition_combine_is_replicate", "srcOp": [
            {"type": "OP_PARTITION", "input": [{"opId": -1, "tsId": 0}],
             "para": [{"key": "PM_PARALLEL_DIM", "value": 0},
                      {"key": "PM_PARALLEL_DEGREE", "value": 2}]},
            {"type": "OP_COMBINE", "input": [{"opId": 0, "tsId": 0}],
             "para": [{"key": "PM_PARALLEL_DIM", "value": 0},
                      {"key": "PM_PARALLEL_DEGREE", "value": 2}]}],
        "dstOp": [
            {"type": "OP_REPLICATE", "input": [{"opId": -1, "tsId": 0}],
             "para": [{"key": "PM_PARALLEL_DEGREE", "value": 2}]}],
        "mappedOutput": [{"srcOpId": 1, "srcTsId": 0, "dstOpId": 0,
                          "dstTsId": 0}]}]}
    path = tmp_path / "rules.json"
    path.write_text(json.dumps(rule))
    return str(path)


SETTINGS = ["plain", "no_parameter_parallel", "memory_remat", "json_rule"]


@pytest.mark.parametrize("setting", SETTINGS)
def test_graph_optimize_same_strategy(setting, tmp_path):
    cfg = {"search_budget": BUDGET}
    d = dict(MACHINES[0])
    if setting == "no_parameter_parallel":
        cfg["enable_parameter_parallel"] = False
    elif setting == "json_rule":
        cfg["substitution_json"] = _rule(tmp_path)
    elif setting == "memory_remat":
        cfg.update(memory_search=True, remat_search=True)
        # an HBM cap at 0.25 of the unconstrained high-water: remat pays
        _, pm = _gpt2_pair()
        d["hbm_bytes"] = 0.25 * search_graph(pm, MachineSpec.from_json(
            dict(MACHINES[0])), beam_width=BUDGET).mem_bytes
    jm, pm = _gpt2_pair(**cfg)
    p, j = _machines(d)
    jst = jgraph_optimize(jm, j, optimizer=JAdamOptimizer())
    pst = graph_optimize(pm, p, optimizer=AdamOptimizer())
    assert pst.to_json() == jst.to_json()
    _close(pst._predicted_cost, jst._predicted_cost, rel=1e-9)
    assert pst._predicted_op_costs.keys() == jst._predicted_op_costs.keys()
    if setting == "memory_remat":
        assert pst.remat and set(pst.remat.values()) <= {"dots", "full"}
    if setting == "json_rule":
        assert pst._search_stats.json_rules["loaded"] == 1


# ------------------------------------------------------------- compile
def test_compile_exports_the_same_file(tmp_path):
    """FFModel.compile with search_num_workers=8 writes JAX's strategy
    file: the search machine {"data": 1, "model": 8} of the real chip."""
    paths = [str(tmp_path / "jax.json"), str(tmp_path / "port.json")]
    jm, pm = _gpt2_pair(search_budget=BUDGET, search_num_workers=8)
    jm.config.mesh_shape = {"data": 1}
    jm.config.export_strategy_file, pm.config.export_strategy_file = paths
    jcm_ = jm.compile(JAdamOptimizer(), "sparse_categorical_crossentropy", [])
    pcm = pm.compile(AdamOptimizer(), "sparse_categorical_crossentropy", [],
                     device="cpu")
    assert json.load(open(paths[1])) == json.load(open(paths[0]))
    assert pcm.strategy.name.startswith("unity(")
    assert pcm.machine.to_json() == jcm_.machine.to_json()
    _close(pcm.predicted_step_time(), jcm_.predicted_step_time(), rel=1e-9)


@pytest.mark.parametrize("imported", [False, True])
def test_predicted_step_time_and_memory_stats(imported, tmp_path):
    """On the one-device cpu-sim machine, both packages' compiles predict
    the same step time and weight/optimizer memory (the data-parallel
    strategy, or a searched one imported from a file)."""
    cfg = {}
    if imported:
        path = str(tmp_path / "s.json")
        jm, _ = _gpt2_pair()
        jm.config.search_budget, jm.config.search_num_workers = BUDGET, 8
        jm.config.mesh_shape = {"data": 1}
        jm.config.export_strategy_file = path
        jm.compile(JAdamOptimizer(), "sparse_categorical_crossentropy", [])
        cfg["import_strategy_file"] = path
    jm, pm = _gpt2_pair(**cfg)
    jm.config.mesh_shape = {"data": 1}
    jcm_ = jm.compile(JAdamOptimizer(), "sparse_categorical_crossentropy", [])
    pcm = pm.compile(AdamOptimizer(), "sparse_categorical_crossentropy", [],
                     device="cpu")
    assert pcm.machine.to_json() == jcm_.machine.to_json()
    _close(pcm.predicted_step_time(), jcm_.predicted_step_time())
    pm_, jm_ = pcm.memory_stats(), jcm_.memory_stats()
    for k in ("predicted_weight_state_bytes", "predicted_opt_state_bytes"):
        assert pm_[k] == jm_[k], k
    assert pm_["max_memory_allocated_bytes"] is None  # not measured here
    pcm.init(seed=0)
    got = pcm.memory_stats()
    assert got["actual_opt_state_bytes_per_device"] == \
        got["predicted_opt_state_bytes"]
    assert got["predicted_peak_bytes"] > got["predicted_weight_state_bytes"]


def test_remat_search_reaches_the_lowering(tmp_path):
    """remat_search on a search machine: the DP's per-layer policies land
    on strategy.remat (as JAX's) and reach the lowering; the strategy
    cache hits on the second compile with no DP expansion. GPT-2 tiny at
    batch 12288 needs more than the cpu-sim chip's 8 GB unrematerialized
    (and its batch x heads stays inside the port's flash grid, where the
    two packages' gates agree)."""
    kw = dict(search_budget=BUDGET, search_num_workers=8, memory_search=True,
              remat_search=True)

    def port():
        pm = FFModel(FFConfig(batch_size=12288, strategy_cache_dir=str(
            tmp_path), **kw))
        build_gpt2(pm, GPT2Config.tiny(seq=128), batch=12288)
        return _compile(pm)

    jm = JFFModel(JFFConfig(batch_size=12288, strategy_cache=False,
                            mesh_shape={"data": 1}, **kw))
    jbuild_gpt2(jm, JGPT2Config.tiny(seq=128), batch=12288)
    jst = jm.compile(JAdamOptimizer(), "sparse_categorical_crossentropy",
                     []).strategy
    pcm = port()
    assert pcm.strategy.to_json() == jst.to_json()
    assert pcm.strategy.remat, "the cap should force a remat assignment"
    assert pcm.forward_fn.remat == pcm.strategy.remat
    assert pcm.search_cache_info["event"] == "store"
    reset_search_stats()
    again = port()
    assert again.search_cache_info["event"] == "hit"
    assert SEARCH_STATS["expansions"] == 0
    assert again.forward_fn.remat == pcm.strategy.remat
    assert again.predicted_step_time() == pcm.predicted_step_time()
    assert again.search_cache_stats()["strategy_cache"]["hits"] >= 1


def test_templates_and_baselines_on_the_search_machine():
    """The Megatron template and the data-parallel strategy priced on the
    search's cost model: the search is never worse than data parallel."""
    _, pm = _gpt2_pair(search_budget=BUDGET, search_num_workers=8)
    sm = _search_machine(pm.config, MachineSpec.detect(device="cpu"))
    best = graph_optimize(pm, sm)._predicted_cost
    dp = strategy_cost(pm, sm, data_parallel_strategy(pm, sm))
    meg = megatron_strategy(pm, sm)
    assert meg.op_shardings["h0_mlp_up"].weights["kernel"] == [None, "model"]
    assert meg.op_shardings["h0_attn"].weights["wo"] == ["model", None]
    assert best <= dp.cost
    assert strategy_cost(pm, sm, meg).cost < dp.cost


@pytest.mark.parametrize("batch,seq,jax_admits,port_admits", [
    (BATCH, 64, False, True), (BATCH, 128, True, True),
    (BATCH, 16384, False, True), (16384, 128, True, False)])
def test_flash_gates_diverge(batch, seq, jax_admits, port_admits):
    """The port prices attention with its CUDA kernels' gate, which has
    no cap on seq: JAX's VMEM gate refuses seq 64 (no block divides it)
    and seq 16384 (k/v past its VMEM budget) and charges the logits' trip
    through HBM there, while the port's refuses batch x heads past its
    grid's 65535 (16384 x 4 heads). Where both admit, the costs agree."""
    built = []
    for ffm, ffc in ((JFFModel, JFFConfig), (FFModel, FFConfig)):
        m = ffm(ffc(batch_size=batch))
        x = m.create_tensor([batch, seq, 256], name="x")
        m.multihead_attention(x, x, x, 256, 4, causal=True, name="attn")
        built.append(m.layers[0])
    jl, pl = built
    p, j = _machines(MACHINES[0])
    jd, pd = jlayer_candidates(jl, j, {batch})[0], \
        layer_candidates(pl, p, {batch})[0]
    assert (jd.extra_comm == 0.0) == jax_admits
    assert (pd.extra_comm == 0.0) == port_admits
    if jax_admits and port_admits:
        _close(pd.op_time(pl, p), jd.op_time(jl, j))


# ------------------------------------------------------------- measured
def test_measured_cost_on_cpu_and_its_store(tmp_path, monkeypatch):
    m = FFModel(FFConfig(batch_size=8))
    x = m.create_tensor([8, 64], name="x")
    m.dense(x, 32, activation="gelu", name="lin")
    layer = m.layers[0]
    mach = MachineSpec(mesh_axes={"data": 1}, chip="cpu-sim")
    (cand,) = layer_candidates(layer, mach, {8})
    mc = MeasuredCost(mach, cache_dir=str(tmp_path), device="cpu",
                      compute_dtype="float32")
    fwd, bwd = mc.op_times(layer, cand)
    assert fwd > 0 and bwd > 0
    assert mc.op_time(layer, cand) == fwd + bwd  # no comm on one device

    def boom(*a):
        raise AssertionError("measured again")

    monkeypatch.setattr(MeasuredCost, "_measure", boom)
    again = MeasuredCost(mach, cache_dir=str(tmp_path), device="cpu",
                         compute_dtype="float32")
    assert again.op_times(layer, cand) == (fwd, bwd)
    fp = sc.calibration_fingerprint(again.cache_path)
    assert fp.startswith("measured:") and fp != "measured:empty"


def test_measurement_that_raises_fails_the_search(monkeypatch, tmp_path):
    """A measured search whose measurement raises raises out of compile:
    no op is priced by the analytic model in its place."""
    def boom(*a):
        raise RuntimeError("measurement failed")

    monkeypatch.setattr(MeasuredCost, "_measure", boom)
    _, pm = _gpt2_pair(search_budget=BUDGET, search_num_workers=8,
                       profiling=True, strategy_cache_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="measurement failed"):
        pm.compile(AdamOptimizer(), "sparse_categorical_crossentropy", [],
                   device="cpu")


# ------------------------------------------------------------- refusals
def _compile(m, **kw):
    return m.compile(AdamOptimizer(), "sparse_categorical_crossentropy", [],
                     device="cpu", **kw)


@pytest.mark.parametrize("case", ["taskgraph", "learned", "mcmc", "pipeline",
                                  "simulator_topk", "pipeline_schedule",
                                  "multi_device", "serving_search"])
def test_unported_modes_raise(case, tmp_path):
    if case in ("taskgraph", "learned"):
        _, pm = _gpt2_pair(search_budget=BUDGET, search_num_workers=8,
                           simulator_mode=case)
        with pytest.raises(NotImplementedError, match="simulator_mode"):
            _compile(pm)
    elif case == "mcmc":
        _, pm = _gpt2_pair()
        with pytest.raises(NotImplementedError, match="MCMC"):
            mcmc_optimize(pm, MachineSpec.from_json(dict(MACHINES[0])))
    elif case == "pipeline":
        _, pm = _gpt2_pair(pipeline_stages=2)
        with pytest.raises(NotImplementedError, match="pipelined"):
            _compile(pm)
    elif case in ("simulator_topk", "pipeline_schedule"):
        # the taskgraph re-rank's top-k and the pipeline's schedule
        flag = {"simulator_topk": ["--simulator-topk", "4"],
                "pipeline_schedule": ["--pipeline-schedule", "1f1b"]}[case]
        with pytest.raises(NotImplementedError, match=flag[0]):
            FFConfig.parse_args(flag)
    elif case == "multi_device":
        path = tmp_path / "machine.json"
        path.write_text(json.dumps(MachineSpec.from_json(
            dict(MACHINES[0])).to_json()))
        _, pm = _gpt2_pair(machine_model_file=str(path))
        with pytest.raises(NotImplementedError, match="executes on one"):
            _compile(pm)
    else:
        _, pm = _gpt2_pair(search_budget=BUDGET)
        with pytest.raises(NotImplementedError, match="serving"):
            compile_serving(pm, device="cpu")


def test_no_search_falls_back_silently(monkeypatch):
    """A search that fails raises out of compile: there is no catch that
    turns it into data parallel."""
    import flexflow_tpu_torch.search.optimize as opt

    def broken(*a, **k):
        raise RuntimeError("search failed")

    monkeypatch.setattr(opt, "graph_optimize", broken)
    _, pm = _gpt2_pair(search_budget=BUDGET, search_num_workers=8)
    with pytest.raises(RuntimeError, match="search failed"):
        _compile(pm)
    # and with no search asked for, the one-device compile is data
    # parallel, as JAX's
    _, pm = _gpt2_pair()
    assert _compile(pm).strategy.to_json() == data_parallel_strategy(
        pm, MachineSpec.detect(device="cpu")).to_json()
    assert Strategy.from_json(_compile(pm).strategy.to_json()).name == \
        "data_parallel"
