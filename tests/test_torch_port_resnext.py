"""The port's ResNeXt against the JAX package's, on the CPU.

bench.py's CPU ResNeXt (b4, 32x32, width 8, groups 4, 10 classes, no
residual) built by both packages, the port on the JAX initial weights,
3 Adam(1e-4) train steps on one batch: the losses and final params agree
at tests/test_torch_port_models.py's tolerances, whose helpers this file
uses. And the same model with residuals searched as tests/test_models.py
searches it, with the JAX package's choices. (Its JAX train-step compile
takes ~20 s, so it has a file of its own.)
"""

import numpy as np
import pytest

from flexflow_tpu import AdamOptimizer as JAdamOptimizer
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.parallel.machine import MachineSpec as JMachineSpec
from flexflow_tpu.search.dp import search_graph as jsearch_graph
from flexflow_tpu.search.optimize import graph_optimize as jgraph_optimize
from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.search.dp import search_graph
from flexflow_tpu_torch.search.optimize import graph_optimize
from test_torch_port_models import (  # noqa: F401  (the autouse fixture)
    LOSS_RTOL, _guids_in_step, _params_match, _state_match, _trained,
    tiny_resnext)


def test_losses_match_jax_at_every_step():
    _, _, jl, pl = _trained("resnext")
    assert all(np.isfinite(pl)) and pl[-1] < pl[0], pl
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)


def test_final_params_match_jax():
    jcm, pcm, _, _ = _trained("resnext")
    _params_match(jcm, pcm)
    _state_match(jcm, pcm)
    assert pcm.state == {}


def test_resnext_search_matches_jax():
    """tests/test_models.py's scaled-down ResNeXt (has_residual=True) on a
    {data 2, model 4} machine of the "cpu-sim" chip, budget 8: the same
    choices and cost as JAX's, the grouped conv s0b0_c2 placed; and
    `graph_optimize` gives the same strategy."""
    kw = dict(batch_size=4, strategy_cache=False, search_budget=8)
    jm, pm = JFFModel(JFFConfig(**kw)), FFModel(FFConfig(**kw))
    for m in (jm, pm):
        tiny_resnext(m, has_residual=True)
    p = MachineSpec.from_json({"mesh_axes": {"data": 2, "model": 4},
                               "chip": "cpu-sim"})
    j = JMachineSpec.from_json(p.to_json())
    jr, pr = jsearch_graph(jm, j), search_graph(pm, p)
    choices = {k: c.name for k, c in pr.choices.items()}
    assert choices == {k: c.name for k, c in jr.choices.items()}
    assert "s0b0_c2" in choices
    assert pr.cost == pytest.approx(jr.cost, rel=1e-12, abs=0.0)
    assert pr.mem_bytes == jr.mem_bytes
    jst = jgraph_optimize(jm, j, optimizer=JAdamOptimizer())
    pst = graph_optimize(pm, p, optimizer=AdamOptimizer())
    assert pst.to_json() == jst.to_json()
