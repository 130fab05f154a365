"""The port's event-driven task-graph simulator against the JAX package's
(tests/test_simulator.py), on the CPU.

Both packages build the same graphs (a dense chain, GPT-2 `tiny(seq=128)`)
and read the same machine description (the port's spec written as JSON and
read by JAX, as tests/test_torch_port_search.py does). The simulator is
pure Python over the same cost model, so the task lists (names, kinds,
streams, durations, bytes, start and end times) and the makespans must be
equal to a relative 1e-12, and the re-rank must pick the same finalist.
"""

import json

import pytest

from flexflow_tpu import AdamOptimizer as JAdamOptimizer
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.core.graph import topo_order as jtopo_order
from flexflow_tpu.models import GPT2Config as JGPT2Config
from flexflow_tpu.models import build_gpt2 as jbuild_gpt2
from flexflow_tpu.parallel.machine import MachineSpec as JMachineSpec
from flexflow_tpu.search import mcmc as jmcmc
from flexflow_tpu.search import simulator as jsim
from flexflow_tpu.search.candidates import layer_candidates as jlayer_candidates
from flexflow_tpu.search.dp import SEARCH_STATS as JSEARCH_STATS
from flexflow_tpu.search.dp import SearchResult as JSearchResult
from flexflow_tpu.search.optimize import graph_optimize as jgraph_optimize
from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.search import cost_model as cm
from flexflow_tpu_torch.search import mcmc
from flexflow_tpu_torch.search import simulator as sim
from flexflow_tpu_torch.search.candidates import layer_candidates
from flexflow_tpu_torch.search.dp import SEARCH_STATS, SearchResult
from flexflow_tpu_torch.search.optimize import graph_optimize

REL = 1e-12
# a 2 x 2 mesh with no closed-form overlap (so the additive sum exposes
# every transfer), a two-node H100 machine, and a three-axis machine with
# its node axis across the network
MESH22 = {"mesh_axes": {"data": 2, "model": 2}, "chip": "h100",
          "overlap_frac": 0.0}
H100_2x8 = {"mesh_axes": {"data": 2, "model": 8}, "chip": "h100",
            "dcn_axes": ["data"]}
DCN3 = {"mesh_axes": {"node": 2, "data": 2, "model": 2}, "chip": "h100",
        "dcn_axes": ["node"], "overlap_frac": 0.0}

PORT = dict(FFModel=FFModel, FFConfig=FFConfig, topo=topo_order,
            cands=layer_candidates, mcmc=mcmc, sim=sim)
JAX = dict(FFModel=JFFModel, FFConfig=JFFConfig, topo=jtopo_order,
           cands=jlayer_candidates, mcmc=jmcmc, sim=jsim)


def _machines(d):
    p = MachineSpec.from_json(dict(d))
    return p, JMachineSpec.from_json(p.to_json())


def chain(pkg, d=4096, n=8, b=8, s=512):
    m = pkg["FFModel"](pkg["FFConfig"](batch_size=b))
    h = m.create_tensor([b, s, d], name="x")
    for i in range(n):
        h = m.dense(h, d, activation="relu", name=f"fc{i}")
    return m


def plan(pkg, model, machine, shard=()):
    """The all-data-parallel assignment with the named layers on
    tp_row:model, and its additive cost (mcmc.assignment_cost)."""
    layers = pkg["topo"](model.layers)
    bs = {t.shape[0] for t in model.input_tensors if t.ndim > 0}
    cls = {l.name: pkg["cands"](l, machine, bs) for l in layers}
    a = {l.name: 0 for l in layers}
    for nm in shard:
        a[nm] = [c.name for c in cls[nm]].index("tp_row:model")
    choices = {nm: cls[nm][i] for nm, i in a.items()}
    additive = pkg["mcmc"].assignment_cost(layers, model.input_tensors, a,
                                           cls, machine)
    return choices, additive


def _rows(tasks):
    return [(t.name, t.kind, t.resource, t.duration, t.bytes, t.start, t.end,
             [n.name for n in t.next_tasks]) for t in tasks]


def assert_same_report(p, j):
    assert len(p.tasks) == len(j.tasks)
    for a, b in zip(_rows(p.tasks), _rows(j.tasks)):
        assert a[:3] == b[:3] and a[4] == b[4] and a[7] == b[7], (a, b)
        for x, y in zip(a[3:4] + a[5:7], b[3:4] + b[5:7]):
            assert x == pytest.approx(y, rel=REL, abs=0.0), (a, b)
    assert p.makespan == pytest.approx(j.makespan, rel=REL, abs=0.0)
    assert p.resource_busy.keys() == j.resource_busy.keys()
    assert p.hidden_frac == pytest.approx(j.hidden_frac, rel=REL, abs=1e-15)


@pytest.mark.parametrize("case", [
    ("MESH22", (), {}), ("MESH22", ("fc0",), {}), ("MESH22", ("fc7",), {}),
    ("MESH22", ("fc1", "fc2"), {"d": 1024, "n": 4}),
    ("H100_2x8", ("fc3",), {"d": 2048, "n": 4}),
    ("DCN3", ("fc1",), {"d": 2048, "n": 4, "b": 16, "s": 256})])
def test_task_graph_and_makespan_equal_jax(case):
    mname, shard, kw = case
    p_m, j_m = _machines({"MESH22": MESH22, "H100_2x8": H100_2x8,
                          "DCN3": DCN3}[mname])
    pm, jm = chain(PORT, **kw), chain(JAX, **kw)
    pch, padd = plan(PORT, pm, p_m, shard)
    jch, jadd = plan(JAX, jm, j_m, shard)
    assert padd == pytest.approx(jadd, rel=REL, abs=0.0)
    assert_same_report(sim.simulate_strategy(pm, pch, p_m),
                       jsim.simulate_strategy(jm, jch, j_m))


def test_single_device_chain_is_serial():
    """One device: no comm tasks; the makespan is the sum of compute."""
    p_m, j_m = _machines({"mesh_axes": {"data": 1}, "chip": "h100"})
    pm, jm = (chain(pkg, d=512, n=3, b=4, s=64) for pkg in (PORT, JAX))
    rep = sim.simulate_strategy(pm, plan(PORT, pm, p_m)[0], p_m)
    assert not any(t.kind == "comm" for t in rep.tasks)
    assert rep.makespan == pytest.approx(
        sum(t.duration for t in rep.tasks), rel=REL, abs=0.0)
    assert rep.exposed_comm == 0.0 and rep.hidden_frac == 1.0
    assert_same_report(rep, jsim.simulate_strategy(
        jm, plan(JAX, jm, j_m)[0], j_m))


def test_position_dependent_exposure_and_rerank_as_jax():
    """Sharding an early layer halves an exposed gradient sync, a late one
    a hidden one: the additive sums tie and the replay prefers the early
    one, in both packages; the re-rank picks it from the tie."""
    p_m, j_m = _machines(MESH22)
    pm, jm = chain(PORT), chain(JAX)
    picks = []
    for pkg, m, mach, SR in ((PORT, pm, p_m, SearchResult),
                             (JAX, jm, j_m, JSearchResult)):
        ch0, add0 = plan(pkg, m, mach, ("fc0",))
        ch7, add7 = plan(pkg, m, mach, ("fc7",))
        assert add0 == pytest.approx(add7, rel=REL, abs=0.0)
        fin = [SR(choices=ch7, cost=add7, mem_bytes=0),
               SR(choices=ch0, cost=add0, mem_bytes=0)]
        best, reports = pkg["sim"].rerank(m, mach, fin)
        assert best.choices is ch0
        assert reports[1].makespan < reports[0].makespan * 0.995
        full = pkg["sim"].simulate_strategy(m, plan(pkg, m, mach)[0], mach)
        assert full.hidden_frac > 0.8 and full.makespan < plan(
            pkg, m, mach)[1]
        picks.append([r.makespan for r in reports])
    assert picks[0] == pytest.approx(picks[1], rel=REL, abs=0.0)


def test_segmented_transfers_equal_jax():
    """A 67 MB gradient sync splits into 16 MB chunks chained on its link,
    and a smaller segment size splits it further, as in JAX."""
    p_m, j_m = _machines(MESH22)
    pm, jm = chain(PORT, n=2), chain(JAX, n=2)
    pch, jch = plan(PORT, pm, p_m)[0], plan(JAX, jm, j_m)[0]
    for seg in (sim.DEFAULT_SEGMENT_BYTES, 4 * 1024 * 1024):
        pt = sim.build_step_tasks(pm, pch, p_m, segment_bytes=seg)
        jt = jsim.build_step_tasks(jm, jch, j_m, segment_bytes=seg)
        assert [t.name for t in pt] == [t.name for t in jt]
        assert any("[0/" in t.name for t in pt)
        assert_same_report(sim.replay(pt), jsim.replay(jt))
    assert sim.DEFAULT_SEGMENT_BYTES == jsim.DEFAULT_SEGMENT_BYTES


def test_replay_interleaves_and_guards_deadlock():
    """A short transfer squeezes between the segments of a long one; a
    cycle raises."""
    def manual(n_seg, long_dur):
        ts, prev = [], None
        for i in range(n_seg):
            t = sim.SimTask(f"long[{i}]", "comm", "link:x", long_dur / n_seg)
            if prev is not None:
                prev.add_next(t)
            ts.append(t)
            prev = t
        short = sim.SimTask("short", "comm", "link:x", 1.0)
        comp = sim.SimTask("comp", "comp", "mxu", 1.0)
        short.add_next(comp)
        sim.replay(ts + [short, comp])
        return comp.end
    assert manual(10, 10.0) < manual(1, 10.0)
    a = sim.SimTask("a", "comp", "mxu", 1.0)
    b = sim.SimTask("b", "comp", "mxu", 1.0)
    a.add_next(b)
    b.add_next(a)
    with pytest.raises(RuntimeError, match="deadlock"):
        sim.replay([a, b])


class _Measured:
    """A MeasuredCost stand-in: op_times gives a (fwd, bwd) split that is
    not 1:2, op_time their sum."""

    def op_times(self, layer, cand):
        n = int(layer.name[2:]) + 1
        return 1e-4 * n, 5e-4 * n

    def op_time(self, layer, cand):
        return sum(self.op_times(layer, cand))


def test_measured_split_through_the_bound_method():
    """The search passes MeasuredCost.op_time, a bound method: the
    simulator finds op_times through __self__ and uses the measured split,
    as JAX's does."""
    p_m, j_m = _machines(MESH22)
    pm, jm = chain(PORT, d=1024, n=3), chain(JAX, d=1024, n=3)
    pch, jch = plan(PORT, pm, p_m, ("fc1",))[0], plan(JAX, jm, j_m, ("fc1",))[0]
    mc = _Measured()
    rep = sim.simulate_strategy(pm, pch, p_m, cost_fn=mc.op_time)
    by = {t.name: t.duration for t in rep.tasks}
    for i in range(3):
        assert (by[f"fc{i}:fwd"], by[f"fc{i}:bwd"]) == mc.op_times(
            pm.get_layer_by_name(f"fc{i}"), None)
    assert_same_report(rep, jsim.simulate_strategy(jm, jch, j_m,
                                                   cost_fn=mc.op_time))
    # a plain function splits pure compute 1:2
    plain = sim.simulate_strategy(pm, pch, p_m,
                                  cost_fn=lambda l, c: mc.op_time(l, c))
    by = {t.name: t.duration for t in plain.tasks}
    assert by["fc0:bwd"] == pytest.approx(2 * by["fc0:fwd"], rel=1e-12)


def test_dcn_axis_priced_on_its_own_link():
    """Gradient syncs over node+data bind to the slowest link (the network
    node axis), a tp layer's all-reduce rides the model link."""
    p_m, _ = _machines(DCN3)
    m = chain(PORT, d=2048, n=4, b=16, s=256)
    rep = sim.simulate_strategy(m, plan(PORT, m, p_m, ("fc1",))[0], p_m)
    links = {t.resource for t in rep.tasks if t.kind == "comm"}
    assert {"link:node", "link:model"} <= links, links
    gs = [t for t in rep.tasks if t.resource == "link:node"
          and t.name.startswith("fc0:kernel:gradsync")]
    w = m.get_layer_by_name("fc0").weight_specs["kernel"]
    assert sum(t.duration for t in gs) == pytest.approx(
        cm.all_reduce_time(w.size_bytes, ("node", "data"), p_m), rel=REL, abs=0.0)


def test_to_json_and_trace_are_jax_s(tmp_path):
    """to_json and the Chrome trace carry the same content in both
    packages; each stream's intervals never overlap."""
    p_m, j_m = _machines(MESH22)
    pm, jm = chain(PORT, d=1024, n=4), chain(JAX, d=1024, n=4)
    p = sim.simulate_strategy(pm, plan(PORT, pm, p_m, ("fc1",))[0], p_m)
    j = jsim.simulate_strategy(jm, plan(JAX, jm, j_m, ("fc1",))[0], j_m)
    pj, jj = p.to_json(), j.to_json()
    assert [e["name"] for e in pj["timeline"]] == \
        [e["name"] for e in jj["timeline"]]
    assert pj["makespan_s"] == pytest.approx(jj["makespan_s"], rel=REL)
    p.export_trace(str(tmp_path / "p.json"))
    j.export_trace(str(tmp_path / "j.json"))
    pe = json.loads((tmp_path / "p.json").read_text())["traceEvents"]
    je = json.loads((tmp_path / "j.json").read_text())["traceEvents"]
    assert [(e["name"], e["ph"], e["tid"]) for e in pe] == \
        [(e["name"], e["ph"], e["tid"]) for e in je]
    spans = {}
    for t in p.tasks:
        spans.setdefault(t.resource, []).append((t.start, t.end))
    for res, ss in spans.items():
        ss.sort()
        for (_s1, e1), (s2, _e2) in zip(ss, ss[1:]):
            assert e1 <= s2 + 1e-12, res


def _gpt2_pair(**cfg):
    kw = dict(batch_size=8, strategy_cache=False, **cfg)
    jm, pm = JFFModel(JFFConfig(**kw)), FFModel(FFConfig(**kw))
    jbuild_gpt2(jm, JGPT2Config.tiny(seq=128), batch=8)
    build_gpt2(pm, GPT2Config.tiny(seq=128), batch=8)
    return jm, pm


@pytest.mark.parametrize("topk", [1, 3])
def test_taskgraph_search_picks_jax_s_strategy(topk):
    """A tiny GPT-2 searched under simulator_mode="taskgraph" on a 2 x 2
    mesh: the per-segment top-k DP, the re-rank and the segment memo pick
    the strategy JAX picks, at the same predicted cost."""
    jm, pm = _gpt2_pair(search_budget=8, simulator_mode="taskgraph",
                        simulator_topk=topk)
    p_m, j_m = _machines(MESH22)
    p0, j0 = dict(SEARCH_STATS), dict(JSEARCH_STATS)
    pst = graph_optimize(pm, p_m, optimizer=AdamOptimizer())
    jst = jgraph_optimize(jm, j_m, optimizer=JAdamOptimizer())
    assert pst.to_json() == jst.to_json()
    assert pst._predicted_cost == pytest.approx(jst._predicted_cost,
                                                rel=REL, abs=0.0)
    # the same DP runs (the re-rank's top-k DPs among them) and expansions
    for k in ("calls", "expansions"):
        assert SEARCH_STATS[k] - p0[k] == JSEARCH_STATS[k] - j0[k], k


def test_simulator_trace_at_compile(tmp_path):
    """simulator_trace: compile writes the compiled strategy's replay as
    a Chrome trace with a fwd and a bwd task for every layer that is not
    a passthrough, the same events JAX writes for its compile."""
    paths = [tmp_path / "jax.json", tmp_path / "port.json"]
    out = []
    for (ffm, ffc, opt), path in zip(
            ((JFFModel, JFFConfig, JSGDOptimizer),
             (FFModel, FFConfig, SGDOptimizer)), paths):
        m = ffm(ffc(batch_size=16, simulator_trace=str(path)))
        x = m.create_tensor([16, 64], name="x")
        m.dense(m.dense(x, 256, activation="relu", name="up"), 8,
                name="down")
        kw = {"device": "cpu"} if ffm is FFModel else {}
        if ffm is JFFModel:
            m.config.mesh_shape = {"data": 1}
        m.compile(opt(lr=0.01), "mean_squared_error", [], **kw)
        out.append(json.loads(path.read_text())["traceEvents"])
    names = {e["name"] for e in out[1]}
    for layer in ("up", "down"):
        assert {f"{layer}:fwd", f"{layer}:bwd"} <= names, names
    assert [e["name"] for e in out[1]] == [e["name"] for e in out[0]]
    assert FFConfig.parse_args(["--simulator-trace", "t.json"]) \
        .simulator_trace == "t.json"
