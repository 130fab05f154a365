"""The strategy search (counterpart: flexflow_tpu/search/): the Unity
search over graph substitutions (unity.py, substitution.py, pcg.py), its
frontier DP (dp.py), the per-op candidates (candidates.py), the analytic
cost model (cost_model.py) with costs measured on the device as an option
(measure.py), the event-driven task-graph simulator (simulator.py), the
learned cost model (learned_cost.py), MCMC (mcmc.py), and the fast path
(memo.py, strategy_cache.py). `graph_optimize` (optimize.py) is the entry
point."""

from flexflow_tpu_torch.search.optimize import graph_optimize  # noqa: F401
