"""The two port faults that ROADMAP Queue 3 listed, each against the JAX
package on the CPU:

1. `FFConfig.parse_args` knows every option string of the JAX parser,
   with the same choices; `--lr` reaches `learning_rate` and the
   compile's default optimizer, as in JAX; a flag whose feature is not
   ported raises `NotImplementedError` naming its ROADMAP item; a flag
   neither package knows is ignored.
2. The unfused sparse cross-entropy takes an out-of-range label as JAX
   does (lse minus the label's logit by `take_along_axis`'s rules: a
   negative label counts from the end, one outside [-v, v) reads NaN),
   with and without `from_logits`.
"""

import ast
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.losses import compute_loss as jcompute_loss
import flexflow_tpu_torch
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.losses import compute_loss

PKG = pathlib.Path(flexflow_tpu_torch.__file__).parent


def _options(parser):
    return {o: tuple(a.choices) if a.choices else None
            for a in parser._actions for o in a.option_strings}


def test_parser_knows_every_jax_option_with_its_choices():
    jopts, popts = _options(JFFConfig.build_parser()), _options(
        FFConfig.build_parser())
    assert set(jopts) <= set(popts)
    assert {o: popts[o] for o in jopts} == jopts


def test_lr_reaches_the_default_optimizer_as_in_jax():
    argv = ["--lr", "0.5", "--wd", "0.001", "--iterations", "7"]
    jcfg, pcfg = JFFConfig.parse_args(argv), FFConfig.parse_args(argv)
    for f in ("learning_rate", "weight_decay", "iterations"):
        assert getattr(pcfg, f) == getattr(jcfg, f)
    assert pcfg.learning_rate == 0.5

    def compiled(model_cls, cfg, **kw):
        m = model_cls(cfg)
        m.dense(m.create_tensor([4, 3], name="x"), 2, name="d")
        return m.compile(None, "mean_squared_error", [], **kw)
    jcfg.mesh_shape, jcfg.log_level = {"data": 1}, "warning"
    jopt = compiled(JFFModel, jcfg).optimizer
    popt = compiled(FFModel, pcfg, device="cpu").optimizer
    assert type(popt).__name__ == type(jopt).__name__ == "SGDOptimizer"
    assert popt.lr == jopt.lr == 0.5


@pytest.mark.parametrize("argv,item", [
    (["--zero-sharding", "zero1"], 9), (["--mesh", "data=2"], 9),
    (["--auto-refit"], 8), (["--simulator-trace", "t.json"], 8),
    (["--serve-objective", "latency"], 9),
    (["--cost-model-path", "m.json"], 8),
    (["--simulator-topk", "4"], 8), (["--serve"], 7)])
def test_unported_flags_raise_naming_their_item(argv, item):
    JFFConfig.parse_args(argv)          # the JAX package takes them
    flag = argv[0].replace("--no-", "--")
    with pytest.raises(NotImplementedError,
                       match=f"{flag} \\(ROADMAP Queue 1 item {item}\\)"):
        FFConfig.parse_args(argv)


@pytest.mark.parametrize("argv", [
    [], ["--telemetry-dir", "t", "--telemetry-max-mb", "3",
         "--no-health-sentinels", "--halt-on-nonfinite", "--profiling",
         "--profile-dir", "p", "--profile-ops"]])
def test_item4_flags_parse_into_jax_fields(argv):
    """The telemetry, sentinel and attribution flags parse into the JAX
    package's fields, with its defaults."""
    jcfg, pcfg = JFFConfig.parse_args(argv), FFConfig.parse_args(argv)
    for f in ("telemetry_dir", "telemetry_max_mb", "health_sentinels",
              "halt_on_nonfinite", "profiling", "profile_dir",
              "profile_ops"):
        assert getattr(pcfg, f) == getattr(jcfg, f), f


@pytest.mark.parametrize("argv", [
    [], ["--serve-watch-dir", "snaps", "--no-serve-reqtrace",
         "--kv-host-pages", "24", "--kv-prefetch-ahead", "3",
         "--serve-trace-out", "t.jsonl"], ["--serve-reqtrace"]])
def test_item5_serving_flags_parse_into_jax_fields(argv):
    """The tiered cache's, hot-swap's and tracing's flags parse into the
    JAX package's fields, with its defaults (tracing on)."""
    jcfg, pcfg = JFFConfig.parse_args(argv), FFConfig.parse_args(argv)
    for f in ("serve_watch_dir", "serve_reqtrace", "kv_host_pages",
              "kv_prefetch_ahead", "serve_trace_out"):
        assert getattr(pcfg, f) == getattr(jcfg, f), f
        assert getattr(FFConfig(), f) == getattr(JFFConfig(), f), f


def test_choices_exit_as_in_jax_and_unknown_flags_are_ignored():
    for parse in (JFFConfig.parse_args, FFConfig.parse_args):
        with pytest.raises(SystemExit) as e:
            parse(["--zero-sharding", "1"])
        assert e.value.code == 2
    assert FFConfig.parse_args(["--no-such-flag", "3", "-b", "4"]).batch_size \
        == JFFConfig.parse_args(["--no-such-flag", "3", "-b", "4"]).batch_size \
        == 4


@pytest.mark.parametrize("from_logits", [True, False])
@pytest.mark.parametrize("bad", [-100, -1, 12, 5])
def test_sparse_ce_out_of_range_labels_match_jax(bad, from_logits):
    """ROADMAP's probe: (4, 10) logits, labels [1, 2, 3, x]: JAX's loss,
    NaN included (f32, 1e-6 relative where finite)."""
    x = np.random.default_rng(0).standard_normal((4, 10)).astype(np.float32)
    if not from_logits:
        x = np.abs(x) / np.abs(x).sum(-1, keepdims=True)
    y = np.array([1, 2, 3, bad], np.int32)
    want = float(jcompute_loss("sparse_categorical_crossentropy",
                               jnp.asarray(x), jnp.asarray(y),
                               from_logits=from_logits))
    got = float(compute_loss("sparse_categorical_crossentropy",
                             torch.from_numpy(x), torch.from_numpy(y),
                             from_logits=from_logits))
    if np.isnan(want):
        assert np.isnan(got)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isnan(want) == (bad in (-100, 12))


# the features an unported-path error names, each looked up in the text of
# the ROADMAP Queue 1 item the error names
FEATURES = ("multi-GPU", "pipeline", "MCMC", "taskgraph", "learned",
            "serving_optimize", "MoE", "fork-join", "compiler/passes")


def _queue1_items():
    """{n: text of ROADMAP Queue 1 item n}, each without its sentences
    that point at another item ("... (item 9)")."""
    text = (PKG.parent / "ROADMAP.md").read_text()
    q1 = text[text.index("### Queue 1"):text.index("### Queue 2")]
    items = {}
    for m in re.finditer(r"^(\d+)\. (.*?)(?=^\d+\. |\Z)", q1, re.S | re.M):
        own = [sent for sent in re.split(r"(?<=[.;])\s+", m.group(2))
               if not re.search(r"item \d", sent)]
        items[int(m.group(1))] = " ".join(own).lower()
    return items


def _unported_raises():
    """(file:line, message) of every NotImplementedError in the port whose
    message names a ROADMAP item."""
    out = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Raise)
                    and isinstance(node.exc, ast.Call)
                    and getattr(node.exc.func, "id", "")
                    == "NotImplementedError"):
                continue
            msg = "".join(c.value for c in ast.walk(node.exc)
                          if isinstance(c, ast.Constant)
                          and isinstance(c.value, str))
            if re.search(r"item \d", msg):
                out.append((f"{path.relative_to(PKG)}:{node.lineno}", msg))
    return out


def test_unported_errors_name_the_roadmap_item_of_their_feature():
    """Every NotImplementedError that names a ROADMAP Queue 1 item names
    the item whose text lists its feature."""
    items = _queue1_items()
    raises = _unported_raises()
    assert len(raises) >= 5
    for where, msg in raises:
        n = int(re.search(r"item (\d+)", msg).group(1))
        feats = [f for f in FEATURES if f.lower() in msg.lower()]
        assert feats, f"{where}: no known feature in {msg!r}"
        for f in feats:
            assert f.lower() in items[n], \
                f"{where} names item {n} for {f!r}, which that item lacks"
