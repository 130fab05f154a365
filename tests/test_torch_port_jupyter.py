"""The port's Jupyter integration against the JAX package's
(tests/test_jupyter.py), on the CPU.

The kernelspec bodies equal JAX's for the same config except the dropped
XLA entry (`virtual_devices`, an XLA host device count, has no meaning for
torch, and neither has the CPU pin the JAX package adds with it).
`FFConfig.parse_args()` reads the spec's `FF_LAUNCH_ARGS` and
`FLEXFLOW_PLATFORM`. The port's quickstart notebook runs cell by cell
under `FLEXFLOW_PLATFORM=cpu`: its one-device part with no mesh, its loss
falling; its mesh part over `run_over_mesh`'s 8 gloo ranks (JAX's
{'data': 4, 'model': 2}, budget 8), whose searched layouts of up, down and
head and up's sharded weight_view dims are exactly those of JAX's notebook
on its 8-device CPU mesh, its loss falling.
"""

import json
import linecache
import os
import subprocess
import sys
import warnings

import pytest

from flexflow_tpu.jupyter import kernelspec as jkernelspec
from flexflow_tpu.jupyter import load_config as jload_config
from flexflow_tpu.jupyter.install import install as jinstall
from flexflow_tpu_torch import device
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.jupyter import (kernelspec, load_config,
                                        notebook_cells, notebook_path)
from flexflow_tpu_torch.jupyter.install import install

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _default_device():
    """parse_args() with FLEXFLOW_PLATFORM sets the process's default
    device: put it back for the tests that follow in this process."""
    saved = list(device._DEFAULT)
    yield
    device._DEFAULT[:] = saved


CONFIGS = [
    {"name": "FlexFlow (virtual mesh)", "mesh": "data=4,model=2",
     "budget": 8, "virtual_devices": 8},
    {"name": "FlexFlow", "gpus": {"cmd": "-ll:gpu", "value": 4},
     "ranks_per_node": {"cmd": "--npernode", "value": 2},
     "nodes": {"cmd": "-n", "value": 2},
     "fbmem": {"cmd": "-ll:fsize", "value": 4096},
     "sysmem": {"cmd": "-ll:csize", "value": None}},
    {"name": "one card", "batch_size": 32, "epochs": 2, "budget": 4,
     "platform": "gpu", "env": {"FOO": "1"}},
]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_kernelspec_equals_jax_but_the_xla_entry(cfg, tmp_path):
    path = tmp_path / "kernel.json.in"
    path.write_text(json.dumps(cfg))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        kdir = install(config=str(path), prefix=str(tmp_path / "p"),
                       mute=True)
        jdir = jinstall(config=str(path), prefix=str(tmp_path / "j"),
                        mute=True)
    spec = json.load(open(os.path.join(kdir, "kernel.json")))
    jspec = json.load(open(os.path.join(jdir, "kernel.json")))
    assert kdir.endswith(os.path.join("kernels", "flexflow_tpu_torch"))
    if "virtual_devices" in cfg:
        assert jspec["env"].pop("XLA_FLAGS").endswith("device_count=8")
        assert jspec["env"].pop("FLEXFLOW_PLATFORM") == "cpu"
        assert "XLA_FLAGS" not in spec["env"]
    assert spec == jspec
    assert "ipykernel_launcher" in " ".join(spec["argv"])


def test_reference_vocabulary_and_dropped_fields(tmp_path):
    """The reference's {"cmd", "value"} fields map onto the launcher flags
    as in JAX; Legion knobs and virtual_devices are dropped with a
    warning."""
    path = tmp_path / "flexflow_jupyter.json"
    path.write_text(json.dumps({**CONFIGS[1], "virtual_devices": 8}))
    with pytest.warns(UserWarning, match="no meaning for the port"):
        name, argv, env = load_config(str(path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jname, jargv, _ = jload_config(str(path))
    assert (name, argv) == (jname, jargv)
    assert argv[argv.index("--workers-per-node") + 1] == "8"
    assert "-ll:fsize" not in argv and env == {}
    assert kernelspec("X", ["--budget", "4"], {"FOO": "1"}) == \
        jkernelspec("X", ["--budget", "4"], {"FOO": "1"})


def test_parse_args_reads_the_kernel_environment(monkeypatch):
    """Without argv, parse_args takes FF_LAUNCH_ARGS (the command line
    wins) and FLEXFLOW_PLATFORM as the default device; an explicit argv
    takes neither, as in JAX."""
    monkeypatch.setenv("FF_LAUNCH_ARGS", "-b 32 --budget 4 -e 2")
    monkeypatch.setenv("FLEXFLOW_PLATFORM", "cpu")
    monkeypatch.setattr(sys, "argv", ["kernel"])
    device._DEFAULT[0] = "cuda"
    c = FFConfig.parse_args()
    assert (c.batch_size, c.search_budget, c.epochs) == (32, 4, 2)
    assert device.resolve_device(None).type == "cpu"
    monkeypatch.setattr(sys, "argv", ["kernel", "-b", "64"])
    assert FFConfig.parse_args().batch_size == 64
    device._DEFAULT[0] = "cuda"
    assert FFConfig.parse_args([]).batch_size == 64
    assert device._DEFAULT[0] == "cuda"
    # the launcher's FF_LAUNCH_ARGS carries --serve-objective into the
    # kernel's config
    monkeypatch.setenv("FF_LAUNCH_ARGS", "--serve-objective throughput")
    assert FFConfig.parse_args().serve_objective == "throughput"


def test_spec_environment_compiles_and_fits_in_a_subprocess(tmp_path):
    """A process started with an installed spec's environment (the kernel's
    launch, without ipykernel) reads the flags and trains an MLP on the
    device the spec names."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"name": "cpu", "batch_size": 16,
                                "epochs": 2, "platform": "cpu"}))
    spec = json.load(open(os.path.join(
        install(config=str(path), prefix=str(tmp_path), mute=True),
        "kernel.json")))
    script = (
        "import numpy as np\n"
        "from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer\n"
        "cfg = FFConfig.parse_args()\n"
        "m = FFModel(cfg)\n"
        "x = m.create_tensor([cfg.batch_size, 8], name='x')\n"
        "m.dense(m.dense(x, 16, activation='relu'), 3)\n"
        "cm = m.compile(SGDOptimizer(lr=0.1), "
        "'sparse_categorical_crossentropy', [])\n"
        "cm.init(seed=0)\n"
        "rng = np.random.default_rng(0)\n"
        "h = cm.fit(rng.normal(size=(64, 8)).astype(np.float32), "
        "rng.integers(0, 3, 64).astype(np.int32), verbose=False)\n"
        "print(cfg.batch_size, len(h), cm.device.type)\n")
    env = {**os.environ, **spec["env"], "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-3:] == ["16", "2", "cpu"]


def _run_cells(srcs, ns, tag):
    """Each cell as IPython runs one: its source kept in `linecache`, so
    `inspect.getsource` reads back a function the cell defines."""
    for i, src in enumerate(srcs):
        name = f"<quickstart-{tag}-cell-{i}>"
        linecache.cache[name] = (len(src), None, src.splitlines(True), name)
        exec(compile(src, name, "exec"), ns)


def test_quickstart_notebook_executes(monkeypatch):
    """Every code cell of the port's quickstart's one-device part, in one
    namespace, under FLEXFLOW_PLATFORM=cpu and no mesh: compile, init, a
    fit whose loss falls, the strategy JSON."""
    monkeypatch.setenv("FLEXFLOW_PLATFORM", "cpu")
    monkeypatch.delenv("FF_LAUNCH_ARGS", raising=False)
    monkeypatch.setattr(sys, "argv", ["kernel"])
    assert os.path.dirname(notebook_path()).endswith(
        os.path.join("flexflow_tpu_torch", "jupyter"))
    ns = {}
    for src in notebook_cells(tag="one-device"):
        exec(compile(src, "<quickstart-cell>", "exec"), ns)
    assert ns["cm"].device.type == "cpu"
    assert ns["history"][-1]["loss"] < ns["history"][0]["loss"]
    assert ns["history"][-1]["accuracy"] > 0.3
    assert "up" in ns["st"]["ops"]


def _dims(view_dims):
    return [(d.size, d.degree, tuple(d.axes)) for d in view_dims]


def test_quickstart_mesh_cells_match_jax_notebook(monkeypatch):
    """The quickstart's mesh cells under FLEXFLOW_PLATFORM=cpu and no
    kernel flags: `run_over_mesh` runs them over 8 gloo ranks of the
    default {'data': 4, 'model': 2} with budget 8. The searched strategy's
    layouts of up, down and head and up's weight_view dims equal JAX's
    notebook's on its 8-device CPU mesh (its compile and sharded init
    cells), and the loss falls over the mesh."""
    import jax

    assert len(jax.devices()) == 8
    monkeypatch.setenv("FLEXFLOW_PLATFORM", "cpu")
    monkeypatch.delenv("FF_LAUNCH_ARGS", raising=False)
    monkeypatch.setattr(sys, "argv", ["kernel"])
    ns = {}
    _run_cells(notebook_cells(tag="mesh"), ns, "mesh")
    mesh = ns["mesh"]
    assert ns["mcfg"].mesh_shape == {"data": 4, "model": 2}
    assert ns["mcfg"].search_budget == 8
    jns = {}
    jcells = notebook_cells(os.path.join(REPO, "examples", "notebooks",
                                         "quickstart.ipynb"))
    for src in jcells[:3]:  # the mesh, the compile, the sharded init
        exec(compile(src, "<jax-quickstart-cell>", "exec"), jns)
    jcm = jns["cm"]
    jops = jcm.strategy.to_json()["ops"]
    for name in ("up", "down", "head"):
        assert mesh["strategy_json"]["ops"][name] == jops[name], name
    assert {w: _dims(d) for w, d in mesh["views"].items()} == \
        {w: _dims(jcm.weight_view("up", w).dims) for w in jcm.params["up"]}
    assert any(d[1] > 1 for d in _dims(mesh["views"]["kernel"]))
    assert mesh["strategy"].startswith("unity")
    assert jcm.strategy.name.startswith("unity")
    losses = [h["loss"] for h in mesh["history"]]
    assert losses[-1] < losses[0] and mesh["history"][-1]["accuracy"] > 0.3
    assert mesh["device"] == "cpu"
