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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.losses import compute_loss as jcompute_loss
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.losses import compute_loss


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
    (["--kv-host-pages", "8"], 5), (["--cost-model-path", "m.json"], 8),
    (["--compgraph", "g.dot"], 6), (["--serve"], 7)])
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
