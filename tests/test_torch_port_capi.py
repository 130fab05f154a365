"""The port's C API against the JAX package's (tests/test_capi.py), on the
CPU: the repo's own examples/c/mlp_train.c, unchanged, compiles and links
against the port's library (built with `c++` into build/flexflow_tpu_torch/)
and trains under FLEXFLOW_PLATFORM=cpu; without it the library asks for
the GPU, which this machine lacks, and says so."""

import json
import re
import subprocess

import pytest

from flexflow_tpu_torch.capi import LAUNCH_COUNTS_ENV, build
from flexflow_tpu_torch.kernels._build import BUILD_DIR


def _prototypes(path):
    text = re.sub(r"/\*.*?\*/", "", open(path).read(), flags=re.S)
    return re.findall(r"^[a-z][^;#]*\([^;]*\);", text, flags=re.M)


def test_header_surface_equals_jax():
    """The same C functions with the same signatures, so a program
    written for one library builds against the other."""
    ours = _prototypes(build.SOURCES[1])
    jax = _prototypes(build.ROOT / "flexflow_tpu" / "capi" / "flexflow_c.h")
    assert ours == jax and len(ours) == 17


def test_c_example_trains_on_the_cpu(tmp_path):
    counts = tmp_path / "counts.json"
    out = build.run_example("cpu", batch=32,
                            extra_env={LAUNCH_COUNTS_ENV: str(counts)})
    assert "C_API_OK" in out, out
    assert "forward_ok dims=2 (32, 4)" in out, out
    loss0, loss1 = map(float, re.search(
        r"epoch0_loss=([\d.]+) final_loss=([\d.]+)", out).groups())
    assert loss1 < loss0
    # on the CPU the optimizer runs its plain version: nothing launched
    got = json.loads(counts.read_text())
    assert got["fused_sgd_plain"] == 0 and set(got.values()) == {0}


def test_built_into_the_build_dir_not_examples():
    lib = build.build_lib()
    exe = build.build_example()
    for p in (lib, exe):
        assert BUILD_DIR in p.parents, p
    assert lib.name == "libflexflow_tpu_torch_c.so"
    nm = subprocess.run(["nm", "-D", "--defined-only", str(lib)],
                        capture_output=True, text=True).stdout
    for fn in ("flexflow_init", "flexflow_model_fit_f32",
               "flexflow_model_forward_f32", "flexflow_conv2d"):
        assert fn in nm


def test_without_a_platform_it_asks_for_the_gpu():
    """No FLEXFLOW_PLATFORM: compile runs on the GPU, and on a machine
    without one the example fails at compile, with the port's message."""
    env = build.example_env(None)
    env.pop("FLEXFLOW_PLATFORM", None)
    out = subprocess.run([str(build.build_example()), "-b", "32"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "compile" in out.stderr and "no CUDA device" in out.stderr, \
        out.stderr[-2000:]
