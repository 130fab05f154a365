"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points (serving and training) refuse to fall back to the CPU
quietly, its attention takes the kernel wrappers whenever fusion is on (no
shape decides it behind the wrapper's back), and its kernel wrappers count
no launch when they run their plain versions."""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import flexflow_tpu_torch
from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.compiler.compile import CompiledModel, compile_model
from flexflow_tpu_torch.kernels import (dequant_attention, flash_attention,
                                        fused_ce, fused_optim)
from flexflow_tpu_torch.models import GPT2Config, build_gpt2
from flexflow_tpu_torch.ops import attention_ops
from flexflow_tpu_torch.serving import (KVCacheSpec, PagedKVCache,
                                        compile_serving, gpt2_prompt_inputs,
                                        gpt2_step_inputs)

PKG = pathlib.Path(flexflow_tpu_torch.__file__).parent
REPO = PKG.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import flexflow_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "flexflow_tpu" or m.startswith("flexflow_tpu."))
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 25
    assert bad == "[]"


# the modules of fit's dispatch pipeline and of fault injection, each
# imported alone in a fresh interpreter
DISPATCH_MODULES = [
    "flexflow_tpu_torch.runtime.faults", "flexflow_tpu_torch.runtime.resilience",
    "flexflow_tpu_torch.runtime.dataloader",
    "flexflow_tpu_torch.runtime.checkpoint", "flexflow_tpu_torch.random",
    "flexflow_tpu_torch.compiler.graph_steps",
    "flexflow_tpu_torch.compiler.compile", "flexflow_tpu_torch.optimizers",
    "flexflow_tpu_torch.kernels.fused_optim",
    "flexflow_tpu_torch.serving.scheduler", "flexflow_tpu_torch.config",
    "flexflow_tpu_torch.losses", "flexflow_tpu_torch.runtime.distributed",
    "flexflow_tpu_torch.parallel.pipeline",
    "flexflow_tpu_torch.parallel.machine"]

_IMPORT_ONE = r"""
import importlib, sys
importlib.import_module(sys.argv[1])
print(sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "flexflow_tpu" or m.startswith("flexflow_tpu.")))
"""


def _imported_roots(path):
    """The top-level package of every import statement in `path`."""
    import ast

    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("rel", ["parallel/pipeline.py",
                                 "runtime/distributed.py"])
def test_pipeline_and_hop_import_torch_numpy_and_stdlib_only(rel):
    """parallel/pipeline.py and the hop (runtime/distributed.py) import
    torch, numpy, the standard library and the port, nothing else."""
    roots = _imported_roots(PKG / rel)
    extra = {r for r in roots - {"torch", "numpy", "flexflow_tpu_torch"}
             if r not in sys.stdlib_module_names}
    assert not extra, extra
    assert "flexflow_tpu" not in roots and "jax" not in roots


@pytest.mark.parametrize("module", DISPATCH_MODULES)
def test_dispatch_and_fault_modules_import_no_jax(module):
    out = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import jax|from jax)|\bflexflow_tpu\.|"
                     r"from flexflow_tpu import", re.M)
    hits = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
            for p in sorted(PKG.rglob("*.py"))
            for m in pat.finditer(p.read_text())]
    assert hits == []


def _tiny_model(**cfg):
    model = FFModel(FFConfig(max_batch_slots=2, max_decode_len=4, **cfg))
    build_gpt2(model, GPT2Config(vocab=64, seq=16, d_model=32, heads=2,
                                 layers=1), batch=2)
    return model


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_serving(_tiny_model())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_serving(_tiny_model(), device="cuda")
    eng = compile_serving(_tiny_model(), device="cpu")
    assert eng.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in eng.kv.state.values()
               if isinstance(t, torch.Tensor))


def test_training_entry_points_raise_without_cuda(monkeypatch):
    """FFModel.compile, compile_model and CompiledModel run on the GPU
    unless the caller passes device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _tiny_model().compile(AdamOptimizer(), device=dev)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compile_model(_tiny_model(), AdamOptimizer(),
                          "sparse_categorical_crossentropy", device=dev)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            m = _tiny_model()
            CompiledModel(m, AdamOptimizer(), "sparse_categorical_crossentropy",
                          [], m.layers[-1].outputs, device=dev)
    cm = _tiny_model().compile(AdamOptimizer(), device="cpu")
    params = cm.init(seed=0)
    assert cm.device.type == "cpu"
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for ws in params.values() for t in ws.values())


def test_cpu_wrappers_count_no_launch():
    q = torch.randn(1, 32, 2, 64)
    kq = torch.zeros((1, 32, 2, 64), dtype=torch.int8)
    ks = torch.ones((1, 32, 2))
    pos = torch.tensor([5], dtype=torch.int32)
    f0, d0 = flash_attention.launches, dequant_attention.launches
    flash_attention.flash_attention_qkv(q, q, q, causal=True)
    dequant_attention.dequant_decode_attention(q[:, :1], kq, ks, kq, ks, pos)
    assert (flash_attention.launches, dequant_attention.launches) == (f0, d0)
    assert (f0, d0) == (0, 0)


def test_cpu_training_wrappers_count_no_launch():
    """The fused cross-entropy (forward and backward) and the fused Adam
    and SGD updates on CPU tensors run their plain versions and count no
    launch."""
    x = torch.randn(8, 128, requires_grad=True)
    fused_ce.fused_cross_entropy(x, torch.zeros(8, dtype=torch.int32)).backward()
    assert x.grad is not None
    p = {"a": {"w": torch.randn(40)}}
    for opt in (SGDOptimizer(lr=0.1), SGDOptimizer(lr=0.1, momentum=0.9),
                AdamOptimizer()):
        fused_optim.fused_update(fused_optim.plan_for(opt), p,
                                 opt.init_state(p), p)
    assert (fused_ce.launches_fwd, fused_ce.launches_bwd, fused_optim.launches,
            fused_optim.launches_sgd, fused_optim.launches_sgd_plain) == \
        (0, 0, 0, 0, 0)


def test_kv_cache_needs_a_device():
    spec = KVCacheSpec(layers=1, heads=2, head_dim=16, slots=2,
                       pages_per_slot=2, page_size=16)
    with pytest.raises(TypeError):
        PagedKVCache(spec, ["attn"])
    assert PagedKVCache(spec, ["attn"], device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("fusion", [True, False])
def test_fusion_alone_picks_the_attention_route(monkeypatch, kv_dtype, fusion):
    """head_dim 16 is outside both kernels' gates, yet with fusion on the
    prefill goes to the flash wrapper and the int8 decode to the paged
    dequant wrapper (on a CUDA tensor they would raise, not turn to
    einsum); with fusion off neither wrapper is called."""
    calls = {"flash": 0, "dequant": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(attention_ops, "flash_attention_qkv",
                        counted("flash", attention_ops.flash_attention_qkv))
    monkeypatch.setattr(attention_ops, "paged_dequant_decode_attention",
                        counted("dequant",
                                attention_ops.paged_dequant_decode_attention))
    eng = compile_serving(_tiny_model(enable_fusion=fusion,
                                      kv_cache_dtype=kv_dtype), device="cpu")
    params = eng.init(seed=0)
    ids = np.ones((2, 16), np.int32)
    lengths = np.array([5, 3], np.int32)
    eng.kv.admit(0, 5, 9)
    eng.kv.admit(1, 3, 7)
    eng.kv.push()
    _, kv_state = eng.prefill(params, gpt2_prompt_inputs(ids, lengths))
    eng.kv.commit_prefill(kv_state, np.arange(2, dtype=np.int32), lengths)
    state = eng.kv.state
    logits, _ = eng.decode_step(params, state, gpt2_step_inputs(
        torch.ones((2, 1), dtype=torch.int32), state))
    assert bool(torch.isfinite(logits).all())
    assert calls == {"flash": int(fusion),
                     "dequant": int(fusion and kv_dtype == "int8")}


def test_decode_write_indices_computed_once_a_step(monkeypatch):
    """The cache write indices (positions, page ids, offsets) are the same
    in every layer of a decode step: the first attention layer computes
    them, the second reads them from the step's memo."""
    seen = []
    real = attention_ops._decode_index

    def watched(ctx, pt, pos, page, s):
        seen.append(("serve/decode_index", page, s) in ctx.memo)
        return real(ctx, pt, pos, page, s)

    monkeypatch.setattr(attention_ops, "_decode_index", watched)
    model = FFModel(FFConfig(max_batch_slots=2, max_decode_len=4,
                             kv_cache_dtype="int8"))
    build_gpt2(model, GPT2Config(vocab=64, seq=16, d_model=32, heads=2,
                                 layers=2), batch=2)
    eng = compile_serving(model, device="cpu")
    params = eng.init(seed=0)
    eng.kv.admit(0, 5, 9)
    eng.kv.push()
    state = eng.kv.state
    for _ in range(2):
        logits, state = eng.decode_step(params, state, gpt2_step_inputs(
            torch.ones((2, 1), dtype=torch.int32), state))
    assert bool(torch.isfinite(logits).all())
    assert seen == [False, True, False, True]



_IMPORT_EACH = r"""
import importlib, sys
bad = {}
for n in sys.argv[1:]:
    importlib.import_module(n)
    bad[n] = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "jaxlib"))
                    or m == "flexflow_tpu" or m.startswith("flexflow_tpu."))
print(bad)
"""

SPEC_MODULES = ("flexflow_tpu_torch.health",
                "flexflow_tpu_torch.serving.reqtrace",
                "flexflow_tpu_torch.serving.fleet",
                "flexflow_tpu_torch.serving.scheduler",
                "flexflow_tpu_torch.serving.engine")


def test_speculation_and_admission_modules_load_no_jax():
    """The SLO, terminal-record, admission, scheduler and engine modules,
    each imported in turn into a fresh interpreter, load neither JAX nor
    the JAX package."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_EACH, *SPEC_MODULES],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str({n: [] for n in SPEC_MODULES})


def test_speculative_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compile_serving(_tiny_model(), draft=_tiny_model(), spec_tokens=2,
                            device=dev)
    eng = compile_serving(_tiny_model(), draft=_tiny_model(), spec_tokens=2,
                          device="cpu")
    assert eng.device.type == eng.draft.device.type == "cpu"
    assert eng.draft.kv.device.type == "cpu"


def test_verify_pass_takes_the_dequant_wrapper_at_k_plus_1_rows(monkeypatch):
    """With an int8 cache and fusion on, a speculative round reaches the
    paged dequant wrapper with 1 query row per draft layer step and K+1
    rows per target layer (on a CUDA tensor: the kernel, or a raise); on
    CPU tensors it counts no launch."""
    rows = []
    real = attention_ops.paged_dequant_decode_attention

    def counted(qh, *a, **kw):
        rows.append(int(qh.shape[1]))
        return real(qh, *a, **kw)

    monkeypatch.setattr(attention_ops, "paged_dequant_decode_attention",
                        counted)
    k = 3
    eng = compile_serving(_tiny_model(kv_cache_dtype="int8"),
                          draft=_tiny_model(kv_cache_dtype="int8"),
                          spec_tokens=k, device="cpu")
    params = eng.init(seed=0)
    eng.draft.init(seed=1)
    for kv in (eng.kv, eng.draft.kv):
        kv.admit(0, 5, 5 + 4 + 4 + k)
        kv.push()
    last = torch.ones((2, 1), dtype=torch.int32)
    t_pred, ver_in, state, dstate = eng.spec_round_step(
        params, eng.draft.params, eng.kv.state, eng.draft.kv.state, last,
        gpt2_step_inputs)
    assert tuple(t_pred.shape) == tuple(ver_in.shape) == (2, k + 1)
    assert rows == [1] * k + [k + 1]        # one layer in each model
    assert dequant_attention.launches_by_rows == {}
    assert state["serve/pos"].tolist() == [5 + k + 1, 0]
    assert dstate["serve/pos"].tolist() == [5 + k, 0]


ZOO_MODULES = ("flexflow_tpu_torch.ops.conv_ops",
               "flexflow_tpu_torch.ops.reduce_ops",
               "flexflow_tpu_torch.ops.shape_ops",
               "flexflow_tpu_torch.ops.elementwise",
               "flexflow_tpu_torch.models.resnet",
               "flexflow_tpu_torch.models.resnext",
               "flexflow_tpu_torch.models.bert",
               "flexflow_tpu_torch.models.dlrm",
               "flexflow_tpu_torch.ops.moe_ops",
               "flexflow_tpu_torch.ops.fork_join",
               "flexflow_tpu_torch.compiler.passes",
               "flexflow_tpu_torch.models.alexnet",
               "flexflow_tpu_torch.models.inception",
               "flexflow_tpu_torch.models.mlp",
               "flexflow_tpu_torch.models.candle_uno",
               "flexflow_tpu_torch.models.xdl",
               "flexflow_tpu_torch.models.moe",
               "flexflow_tpu_torch.models.branchy")


def test_model_zoo_modules_load_no_jax():
    """The conv, reduce, shape, elementwise, MoE and fork-join ops, the
    fork-join pass and every model builder, each imported in turn into a
    fresh interpreter, load neither JAX nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_EACH, *ZOO_MODULES],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str({n: [] for n in ZOO_MODULES})


def test_model_zoo_compile_raises_without_cuda(monkeypatch):
    """A ResNet block compiles for the GPU unless the caller passes
    device="cpu"; on the CPU its step runs and its BN state is CPU f32."""
    from flexflow_tpu_torch.models import build_resnet_block

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = FFModel(FFConfig(batch_size=2))
    x = m.create_tensor([2, 8, 8, 8])
    build_resnet_block(m, x, 2, 1, "b", project=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.compile(SGDOptimizer(), "mean_squared_error", [])
    cm = m.compile(SGDOptimizer(), "mean_squared_error", [], device="cpu")
    cm.init(seed=0)
    y = np.zeros((2, 8, 8, 8), np.float32)
    *_, loss, _ = cm.train_step(cm.params, cm.opt_state, cm.state,
                                [np.ones((2, 8, 8, 8), np.float32)], y)
    state = cm.train_step(cm.params, cm.opt_state, cm.state,
                          [np.ones((2, 8, 8, 8), np.float32)], y)[2]
    assert bool(torch.isfinite(loss))
    assert len(state) == 8 and all(t.device.type == "cpu"
                                   and t.dtype == torch.float32
                                   for t in state.values())


HEALTH_MODULES = ("flexflow_tpu_torch.telemetry",
                  "flexflow_tpu_torch.health",
                  "flexflow_tpu_torch.attribution",
                  "flexflow_tpu_torch.search.cost_model",
                  "flexflow_tpu_torch.compiler.lowering",
                  "flexflow_tpu_torch.serving.engine")


def test_telemetry_health_and_attribution_modules_load_no_jax():
    """The span stream, run health, per-op attribution and the modules
    they instrument, each imported in turn into a fresh interpreter, load
    neither JAX nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_EACH,
                          *HEALTH_MODULES],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str({n: [] for n in HEALTH_MODULES})


# the rest of one-card serving: the tiered cache, hot-swap, request
# tracing and replayable traces
SERVING_MODULES = tuple(f"flexflow_tpu_torch.serving.{m}" for m in (
    "kv_cache", "engine", "scheduler", "reqtrace", "tracefmt", "program",
    "fleet", "twin")) + ("flexflow_tpu_torch.tools.twin",)


def test_tier_swap_and_trace_modules_load_no_jax():
    """The grown serving modules, each imported in turn into a fresh
    interpreter, load neither JAX nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_EACH,
                          *SERVING_MODULES],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str({n: [] for n in SERVING_MODULES})


# the fleet over a mesh and the notebook over ranks: the modules they
# changed or added to
MESH_FLEET_MODULES = (
    "flexflow_tpu_torch.runtime.distributed",
    "flexflow_tpu_torch.parallel.machine",
    "flexflow_tpu_torch.serving.fleet", "flexflow_tpu_torch.serving.kv_cache",
    "flexflow_tpu_torch.serving.scheduler",
    "flexflow_tpu_torch.serving.engine", "flexflow_tpu_torch.jupyter")


def test_mesh_fleet_and_notebook_modules_load_no_jax():
    """The fleet's turnstile and lockstep feed, the replicas' own groups,
    the heads-sharded handoff and the notebook's `run_over_mesh`, each
    module imported in turn into a fresh interpreter, load neither JAX nor
    the JAX package."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_EACH,
                          *MESH_FLEET_MODULES],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str({n: [] for n in MESH_FLEET_MODULES})


def test_tiered_and_watching_engines_raise_without_cuda(monkeypatch,
                                                         tmp_path):
    """A tiered compile_serving, and one that watches a snapshot root from
    the config, run on the GPU unless the caller passes device="cpu";
    on the CPU the host tier is plain (unpinned) memory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(tmp_path / "snaps")
    for cfg in ({"kv_host_pages": 2}, {"serve_watch_dir": root},
                {"kv_host_pages": 2, "serve_watch_dir": root}):
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                compile_serving(_tiny_model(**cfg), device=dev)
        eng = compile_serving(_tiny_model(**cfg), device="cpu")
        assert eng.device.type == "cpu"
        assert eng.watching == ("serve_watch_dir" in cfg)
        if "kv_host_pages" in cfg:
            assert eng.kv.host_pages == 2
            assert not any(t.is_pinned() for d in eng.kv._host.values()
                           for t in d.values())
    assert not eng.poll_swap(force=True)    # an empty root: nothing to take


# the frontends: every module of the torch.fx, ONNX and Keras subpackages
# and the launcher, found by walking the package, each loaded alone
def _frontend_modules():
    import pkgutil

    names = ["flexflow_tpu_torch.__main__"]
    for sub in ("torch", "onnx", "keras"):
        pkg = __import__(f"flexflow_tpu_torch.{sub}", fromlist=["_"])
        names.append(pkg.__name__)
        names += [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
    return names


def test_frontend_modules_load_no_jax():
    """The torch.fx, ONNX and Keras frontends and the launcher import
    neither JAX nor the JAX package, alone or together."""
    names = _frontend_modules()
    assert len(names) >= 17
    out = subprocess.run([sys.executable, "-c", _IMPORT_EACH, *names],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str({n: [] for n in names})


def test_frontend_sources_name_no_jax_package():
    """No source of the frontends names the JAX package in an import."""
    for sub in ("torch", "onnx", "keras"):
        for path in sorted((PKG / sub).rglob("*.py")):
            text = path.read_text()
            assert not re.search(r"^\s*(from|import) (jax|flexflow_tpu)\b",
                                 text, re.M), path


_TOOL_RUNS = r"""
import contextlib, io, json, runpy, sys
for name in ("jax", "flexflow_tpu"):
    try:
        __import__(name)
    except ImportError as e:
        assert "is not installed here" in str(e), e
    else:
        raise SystemExit(name + " imported")
tel, prom, examples = sys.argv[1], sys.argv[2], sys.argv[3:]
# each tool as `python -m` starts it: trace_report and the monitor over a
# stream, the three that run a model their usage
for tool, args in (("trace_report", [tel]),
                   ("monitor", [tel, "--once", "--prom-file", prom]),
                   ("profile_attribution", ["--help"]),
                   ("calibrate", ["--help"]), ("perf_probe", ["--help"])):
    sys.argv, out = [tool] + args, io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_module("flexflow_tpu_torch.tools." + tool,
                             run_name="__main__", alter_sys=True)
            code = 0
        except SystemExit as e:
            code = e.code or 0
    print("RUN " + json.dumps([tool, code, out.getvalue()]))
for path in examples:
    runpy.run_path(path, run_name="example")  # imports, no main()
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.tools import calibrate, profile_attribution
model = dict(calibrate._workloads())["mlp"]()[0]
calibrate.predicted(model, MachineSpec(mesh_axes={"data": 1}, chip="cpu-sim"))
profile_attribution._build_twin("twin-telemetry", 1, device="cpu")
from flexflow_tpu_torch.models import GPT2Config
GPT2Config.medium = staticmethod(lambda: GPT2Config(
    vocab=64, seq=16, d_model=32, heads=2, layers=1))
from flexflow_tpu_torch.tools import perf_probe
perf_probe.probe(iters=1, windows=1, device="cpu")
print(sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "flexflow_tpu" or m.startswith("flexflow_tpu.")))
"""

EXAMPLES = sorted((PKG / "examples").rglob("*.py"))


def jax_blocker(root: pathlib.Path) -> pathlib.Path:
    """A directory whose `jax` and `flexflow_tpu` packages raise on import,
    as on the card's machine, which has neither: put it first on
    PYTHONPATH."""
    for name in ("jax", "flexflow_tpu"):
        (root / name).mkdir(parents=True)
        (root / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not installed here')\n")
    return root


def test_tools_and_examples_run_where_jax_cannot_be_imported(tmp_path):
    """In one process where `import jax` and `import flexflow_tpu` raise,
    as on the card's machine: each of the five tools starts as `python -m`
    starts it (trace_report and the monitor over a stream; the three that
    run a model, their usage), the examples import, and what the three
    reach runs (calibrate's pricing, the attribution twin's compile,
    perf_probe's probe on a tiny GPT-2); none of them loads either.
    (mnist_mlp trains through the launcher in such a process in
    test_torch_port_launcher.py.)"""
    block = jax_blocker(tmp_path / "block")
    tdir = tmp_path / "tel"
    tdir.mkdir()
    (tdir / "telemetry-1.jsonl").write_text("\n".join(json.dumps(e) for e in [
        {"name": "fit/dispatch", "ph": "X", "ts": 1.0, "dur": 1500.0},
        {"name": "health/goodput", "ph": "i", "ts": 2.0,
         "args": {"epoch": 0, "wall_s": 2.0, "goodput": 0.8}}]) + "\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("FLEXFLOW_PLATFORM", "FF_LAUNCH_ARGS")}
    env.update(PYTHONPATH=os.pathsep.join([str(block), str(REPO)]),
               FLEXFLOW_PLATFORM="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _TOOL_RUNS, str(tdir), str(tmp_path / "n.prom"),
         *map(str, EXAMPLES)], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = {r[0]: r[1:] for r in (json.loads(l[4:]) for l in
                                  out.stdout.splitlines()
                                  if l.startswith("RUN "))}
    assert sorted(runs) == sorted(["trace_report", "monitor", "calibrate",
                                   "profile_attribution", "perf_probe"])
    assert all(code == 0 for code, _ in runs.values()), runs
    assert "fit/dispatch" in runs["trace_report"][1]
    assert "flexflow_tpu_torch run monitor" in runs["monitor"][1]
    assert "flexflow_goodput_ratio 0.8" in (tmp_path / "n.prom").read_text()
    for tool in ("profile_attribution", "calibrate", "perf_probe"):
        assert "usage:" in runs[tool][1], tool
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert len(EXAMPLES) == 5
