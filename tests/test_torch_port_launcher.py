"""The port's launcher (`python -m flexflow_tpu_torch [flags] script.py
[args]`, flexflow_tpu_torch/__main__.py) against the JAX package's:

- `split_argv` splits as JAX's does, with the value flags read off the
  parser (`FFConfig.launcher_value_flags`, every JAX value flag among
  them);
- `FF_LAUNCH_ARGS` comes first and the command line overrides it, in the
  launcher and in `parse_args()` of a real command line;
- `FLEXFLOW_PLATFORM=cpu` makes `device=None` mean the CPU for the script
  (a subprocess trains there); without it the script's compile asks for
  the GPU and raises on a machine without one; an unknown platform
  raises;
- the port's examples (flexflow_tpu_torch/examples/): mnist_mlp through
  the port's launcher prints JAX's FINAL fields, near JAX's values, and
  asks for the GPU without the platform variable.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import flexflow_tpu_torch
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu.__main__ import split_argv as jsplit_argv
from flexflow_tpu_torch import FFConfig, device
from flexflow_tpu_torch.__main__ import main, split_argv

REPO = pathlib.Path(flexflow_tpu_torch.__file__).parent.parent

SCRIPT = r'''
import json, sys
import numpy as np
import flexflow_tpu_torch as ff

cfg = ff.get_launch_config()
m = ff.FFModel(cfg)
x = m.create_tensor([cfg.batch_size, 8], name="x")
m.dense(m.dense(x, 16, activation="relu", name="h"), 3, name="out")
cm = m.compile(None, "sparse_categorical_crossentropy", ["accuracy"])
rng = np.random.default_rng(0)
xs = rng.normal(size=(4 * cfg.batch_size, 8)).astype(np.float32)
ys = rng.integers(0, 3, size=(4 * cfg.batch_size,)).astype(np.int32)
hist = cm.fit(xs, ys, verbose=False)
print("LAUNCHED " + json.dumps({
    "argv": sys.argv[1:], "batch_size": cfg.batch_size,
    "lr": cm.optimizer.lr, "epochs": len(hist),
    "device": str(cm.device), "loss": hist[-1]["loss"]}))
'''


@pytest.mark.parametrize("argv", [
    ["-b", "64", "--lr", "0.1", "train.py", "--x", "1"],
    ["--machine-model-file", "m.json", "train.py"],
    ["--lr=0.1", "--profiling", "train.py", "-b", "2"],
    ["--serve", "-e", "3", "s.py"], ["-b", "4"], []])
def test_split_argv_as_in_jax(argv):
    assert split_argv(argv) == jsplit_argv(argv)


def test_value_flags_read_off_the_parser():
    flags = FFConfig.launcher_value_flags()
    want = {o for a in FFConfig.build_parser()._actions if a.nargs != 0
            for o in a.option_strings}
    assert flags == want
    assert JFFConfig.launcher_value_flags() <= flags
    assert {"-b", "--lr", "-e"} <= flags and "--serve" not in flags


def _run_main(tmp_path, monkeypatch, argv, env_args=""):
    script = tmp_path / "probe.py"
    out = tmp_path / "cfg.json"
    script.write_text(
        "import json, sys, flexflow_tpu_torch as ff\n"
        "c = ff.get_launch_config()\n"
        f"json.dump([c.batch_size, c.learning_rate, c.epochs, sys.argv], "
        f"open({str(out)!r}, 'w'))\n")
    monkeypatch.setenv("FF_LAUNCH_ARGS", env_args)
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    monkeypatch.setattr(flexflow_tpu_torch, "_launch_config", None)
    assert main([a if a != "SCRIPT" else str(script) for a in argv]) == 0
    return json.loads(out.read_text()), str(script)


def test_ff_launch_args_then_the_command_line(tmp_path, monkeypatch):
    got, script = _run_main(tmp_path, monkeypatch,
                            ["-b", "16", "SCRIPT", "--own", "7"],
                            env_args="-b 32 --lr 0.25 -e 3")
    assert got == [16, 0.25, 3, [script, "--own", "7"]]
    monkeypatch.setattr(sys, "argv", ["prog", "-e", "5"])
    assert (FFConfig.parse_args().epochs, FFConfig.parse_args().batch_size,
            FFConfig.parse_args([]).batch_size) == (5, 32, 64)
    assert FFConfig.parse_args().learning_rate \
        == JFFConfig.parse_args().learning_rate == 0.25


def test_no_script_prints_usage(capsys):
    assert main(["-b", "4"]) == 2
    assert "usage" in capsys.readouterr().err


def _launch(tmp_path, platform):
    script = tmp_path / "train.py"
    script.write_text(SCRIPT)
    env = {k: v for k, v in os.environ.items()
           if k not in ("FLEXFLOW_PLATFORM", "FF_LAUNCH_ARGS")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    if platform:
        env["FLEXFLOW_PLATFORM"] = platform
    return subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch", "-b", "8", "--lr",
         "0.5", "-e", "2", str(script), "--its-own-arg"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def test_platform_cpu_runs_the_script_on_the_cpu(tmp_path):
    out = _launch(tmp_path, "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("LAUNCHED")]
    got = json.loads(line[-1].split(" ", 1)[1])
    assert got["argv"] == ["--its-own-arg"]
    assert (got["batch_size"], got["lr"], got["epochs"], got["device"]) \
        == (8, 0.5, 2, "cpu")
    assert got["loss"] == got["loss"]  # finite, not NaN


def test_without_platform_the_script_asks_for_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a machine with a GPU runs the script there")
    out = _launch(tmp_path, None)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_unknown_platform_raises(monkeypatch):
    with pytest.raises(ValueError, match="FLEXFLOW_PLATFORM='tpu'"):
        device.set_default_device("tpu")
    monkeypatch.setattr(device, "_DEFAULT", ["cuda"])
    device.set_default_device("cpu")
    assert device.resolve_device(None) == torch.device("cpu")


# ----------------------------------------------------------- the examples
EXAMPLE = REPO / "flexflow_tpu_torch" / "examples" / "native" / "mnist_mlp.py"
EXAMPLE_ARGS = ["-b", "128", "--lr", "0.5", "-e", "1"]


def _final(stdout):
    line = [l for l in stdout.splitlines() if l.startswith("FINAL ")][-1]
    return {k: float(v) for k, v in
            (kv.split("=") for kv in line.split()[1:])}


def _env(platform):
    env = {k: v for k, v in os.environ.items()
           if k not in ("FLEXFLOW_PLATFORM", "FF_LAUNCH_ARGS")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    if platform:
        env["FLEXFLOW_PLATFORM"] = platform
    return env


def test_mnist_mlp_example_final_line_against_jax(tmp_path):
    """The port's mnist_mlp through the port's launcher and JAX's through
    JAX's, one epoch each on the same data: the same FINAL fields; the
    weights start from other random numbers (a torch generator against
    threefry), so the loss agrees within 25% and the test accuracy
    within 0.05. The port's runs where `import jax` and `import
    flexflow_tpu` raise, as on the card's machine."""
    block = tmp_path / "block"
    for name in ("jax", "flexflow_tpu"):
        (block / name).mkdir(parents=True)
        (block / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not installed here')\n")
    env = _env("cpu")
    env["PYTHONPATH"] = str(block) + os.pathsep + env["PYTHONPATH"]
    port = subprocess.Popen(
        [sys.executable, "-m", "flexflow_tpu_torch", *EXAMPLE_ARGS,
         str(EXAMPLE)], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jax_run = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu", *EXAMPLE_ARGS,
         str(REPO / "examples" / "native" / "mnist_mlp.py")],
        cwd=tmp_path, env=dict(_env("cpu"), JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    out, err = port.communicate(timeout=300)
    assert port.returncode == 0, err[-3000:]
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    got, want = _final(out), _final(jax_run.stdout)
    assert set(got) == set(want) == {"loss", "test_accuracy"}
    assert got["loss"] == pytest.approx(want["loss"], rel=0.25)
    assert got["test_accuracy"] == pytest.approx(want["test_accuracy"],
                                                 abs=0.05)
    assert got["test_accuracy"] > 0.5  # ten classes: chance is 0.1


def test_example_without_platform_asks_for_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a machine with a GPU runs the example there")
    out = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch", *EXAMPLE_ARGS,
         str(EXAMPLE)], cwd=tmp_path, env=_env(None), capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
