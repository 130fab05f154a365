"""The data-parallel strategy, built without search
(counterpart: flexflow_tpu/parallel/default_strategy.py).

Every batch-sized tensor is sharded on dim 0 over the batch axes and every
weight is replicated: the `--only-data-parallel` baseline, and the
strategy a compile takes when it does not search.
"""

from __future__ import annotations

from typing import List

from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.parallel.sharding import OpSharding, Strategy


def data_parallel_strategy(model, machine: MachineSpec,
                           axis: str = "data") -> Strategy:
    """Shard dim 0 of every batch-sized tensor over the batch axes ("node"
    and "data" where present), replicate weights. A batch-sized tensor is
    one whose leading dim equals a graph input's dim 0."""
    from flexflow_tpu_torch.search.candidates import _batch_axes

    axes = _batch_axes(machine) or [axis]
    if not all(a in machine.mesh_axes for a in axes):
        axes = [next(iter(machine.mesh_axes))]
    spec = tuple(axes) if len(axes) > 1 else axes[0]
    degree = 1
    for a in axes:
        degree *= machine.mesh_axes[a]
    batch_sizes = {t.shape[0] for t in model.input_tensors if t.ndim > 0}

    def dims_for(shape) -> List:
        dims: List = [None] * len(shape)
        if shape and shape[0] in batch_sizes and shape[0] % degree == 0:
            dims[0] = spec
        return dims

    st = Strategy(mesh_axes=dict(machine.mesh_axes), name="data_parallel")
    for t in model.input_tensors:
        st.input_shardings[t.name] = dims_for(t.shape)
    for layer in topo_order(model.layers):
        st.op_shardings[layer.name] = OpSharding(
            outputs=[dims_for(o.spec.shape) for o in layer.outputs],
            weights={w: [None] * len(s.shape)
                     for w, s in layer.weight_specs.items()},
        )
    return st
