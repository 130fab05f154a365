"""compile_model and CompiledModel: the training entry points
(counterpart: flexflow_tpu/compiler/compile.py).

`compile_model(model, optimizer, loss_type, metrics)` builds the graph's
forward (compiler/lowering.py) and returns a `CompiledModel` with
`init`, `train_step`, `eval_step`, `infer`, `fit`, `evaluate`, `forward`,
`save_checkpoint`, `load_checkpoint`, `get_weight`, `set_weight` and
`make_multi_step`, as the JAX package's, and its reports: `drift_stats`,
`goodput_report`, `health_report`, `op_attribution`, `profile_report`
and `recompile_on_condition`. With `pipeline_stages` S > 1 it returns a
`PipelinedModel` (parallel/pipeline.py) on each rank of a world of S x
(devices a stage) instead (`_compile_pipelined`). The config's
`telemetry_dir` turns on the span stream (telemetry.py) at compile, as
in JAX.

The strategy is chosen as in JAX (`_pick_strategy`): a strategy file
(`import_strategy_file`), else the Unity search (search/) of the search
machine when `search_budget > 0` and that machine has more than one device
(`search_num_nodes` / `search_num_workers` describe one larger than the
real machine), else the data-parallel strategy; it is saved to
`export_strategy_file` when that is set. The machine is JAX's
(`resolve_machine`): the machine file, `--nodes`, `mesh_shape`, else one
"data" axis over the world, one GPU a rank; it must cover the world.

Over a mesh (`over_mesh`: the config names one, or the process group
has more than one rank; runtime/distributed.py starts the group) the
program runs SPMD on every rank, the mesh a named `DeviceMesh`
(parallel/machine.py `build_mesh`) and the strategy DTensor placements
(parallel/sharding.py): each weight is a DTensor of its strategy dims
where `constrainable` admits them (`_weight_dims`, JAX `compile.py:
421-447`), drawn full from the seeded generator on every rank, which
keeps its block (every world holds world 1's weights); inputs and labels
are each rank's rows (`_put`, the loader's `rows`); the lowering
constrains each layer's outputs (compiler/lowering.py); the loss is the
mean over the global batch. The gradients come back from autograd with a
pending sum over the batch axes; `_sync_grads` all-reduces them into the
param's layout or, under ZeRO, reduce-scatters them into the moments'
(`zero_sharding`: zero1 shards the moments, zero2 also reduce-scatters
each microbatch's gradient before accumulating it; both are off on a
mesh without a batch axis > 1, JAX `compile.py:451-507`), and the
optimizer runs on each rank's blocks: under ZeRO the rank's block of
each param, then all-gathered back into the param. The strategy's
sequence-parallel attention (`seq_parallel`: the ring,
kernels/ring_attention.py), expert parallelism (`ep:`, ops/moe_ops.py)
and placed fork-joins (`inter:`, parallel/interop.py) run over the mesh
where their guards hold (`_check_mesh_strategy` raises naming the one
that fails); their weights are sharded at birth like any other (the
experts' kernels over the expert axis, stacked branch weights over the
placement axis). A label of class ids takes the logits' layout without
the class dim (`label_placements`), and where the two are sharded alike
each rank takes the mean over its own rows, weighted by their share
(`_local_loss`). Without a mesh the
program is the one-device program, and the shardings are carried and
none is applied, as a one-device mesh applies none in JAX. The
strategy's `remat` map ({layer: "full" |
"dots"}, searched per layer with `remat_search`) reaches the lowering,
and `cfg.remat` (the deprecated uniform alias) makes it "full" for every
layer when the strategy has none. `predicted_step_time()` and
`memory_stats()` put the cost model's predictions beside what the device
measures.

The rng is threaded as in JAX (`compile.py:593-701`): `train_step(...,
rng)` hands the key to the forward's dropout draws (rng=None is allowed
where nothing draws), the accumulating step gives microbatch j
`fold_in(rng, j)`, and `fit` steps with `fold_in(key(seed + 17),
iteration)`, where `_iteration` counts optimizer updates across fits.

`fit` is the JAX fit's dispatch loop (`_fit_epochs`, non-pipeline, with
its telemetry spans, goodput buckets, numerics sentinels and memory
watermarks: health.py): `steps_per_dispatch` K > 1 runs K updates
as ONE dispatch of `make_multi_step(K)` over groups of K batches stacked
by `runtime/dataloader.prefetch_multi` (the epoch's tail goes singly);
on the card that dispatch is one replay of a CUDA graph of the K steps
(compiler/graph_steps.py), on the CPU the same K steps run eagerly.
Step i of a dispatch at iteration i0 draws from fold_in(base, i0 + i),
as K single dispatches do. A per-batch callback (`on_batch_end`) forces
K = 1 and a host sync after every update. When no sync falls on a
dispatch, every `dispatch_ahead`-th dispatch waits for the device (a
barrier, no host read). Before each dispatch, the `fit/dispatch` fault
site is checked once per global step the dispatch covers, under the
retry policy, and `health/nonfinite` may NaN-poison the first param
(runtime/faults.py). `fit` takes durable periodic checkpoints, a SIGTERM
drain and `resume` through runtime/resilience.py; `evaluate` feeds
through `prefetch_to_device` with the same barrier.

Gradient accumulation is `compile.py:655-701`'s: with `accum_steps` N > 1
(the config's, or `fit(accum_steps=N)`) the train step takes inputs and
labels with a leading (N, ...) microbatch dim, runs `value_and_grads` on
each microbatch, sums the f32 gradients, multiplies the sum by 1 / N and
applies ONE optimizer update; loss and metrics are the microbatch sums
times 1 / N. `fit` groups N consecutive loader batches per update
(`runtime/dataloader.group_microbatches`).

The non-trainable state (`cm.state`: the batch-norm running stats,
`{layer}/mean` and `{layer}/var`) is threaded as in JAX: `train_step`
returns the forward's new state, the accumulating step feeds microbatch
j's state to microbatch j+1, `fit` keeps the last step's, and
`eval_step`, `infer` and `evaluate` read it (inference mode). `init` and
`load_params` start it empty; `convert.state_from_jax` carries the JAX
package's across. Labels are what the loss takes: int ids for the
cross-entropies, float targets for MSE (e.g. DLRM's `(b, 1)` f32 clicks).

Params are f32 master weights; the lowering casts them to the compute
dtype per layer, so their gradients come back in f32, as in JAX. The
optimizer updates params and moments IN PLACE: that is the port's analog
of the JAX step's buffer donation, and `train_step` returns the same
(updated) trees it was given.

The fused-kernel gates are `compile.py:558-579`'s: with fusion on (or
`fused_optimizer="on"`) a recognised optimizer takes the fused update
(kernels/fused_optim.py), and a sparse-CE loss over logits the fused gate
admits takes the fused cross-entropy (kernels/fused_ce.py); otherwise the
optimizer's own update and `losses.compute_loss` over f32 logits run.

The entry points run on the GPU: `device=None` means "cuda", and without
a CUDA device they raise unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from flexflow_tpu_torch import health
from flexflow_tpu_torch import random as ff_random
from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.compiler.lowering import build_forward
from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.device import resolve_device, to_device
from flexflow_tpu_torch.initializers import init_params
from flexflow_tpu_torch.kernels import fused_ce, fused_optim
from flexflow_tpu_torch.losses import LossType, compute_loss
from flexflow_tpu_torch.metrics import MetricsType, PerfMetrics, compute_metrics
from flexflow_tpu_torch.optimizers import SGDOptimizer
from flexflow_tpu_torch.parallel.default_strategy import data_parallel_strategy
from flexflow_tpu_torch.parallel.machine import MachineSpec, build_mesh
from flexflow_tpu_torch.parallel.sharding import (Strategy, constrainable,
                                                  mesh_placements,
                                                  pins_nothing, placements)
from flexflow_tpu_torch.runtime.dataloader import (SingleDataLoader,
                                                   group_microbatches,
                                                   prefetch_multi,
                                                   prefetch_to_device)


def resolve_machine(cfg, device=None) -> MachineSpec:
    """The machine a compile runs on (JAX `compile.py:146-159`): the
    machine file, else `--nodes` as a "node" axis across the network over
    a "data" axis of each node's workers, else `mesh_shape`, else one
    "data" axis over the world (`MachineSpec.detect`). It must cover the
    world, one device a rank: a machine of more devices raises JAX's
    message."""
    from flexflow_tpu_torch.runtime.distributed import world_size

    if cfg.machine_model_file:
        machine = MachineSpec.from_file(cfg.machine_model_file)
    elif not cfg.mesh_shape and cfg.num_nodes > 1:
        workers = cfg.workers_per_node or max(
            1, world_size() // cfg.num_nodes)
        machine = MachineSpec.detect({"node": cfg.num_nodes,
                                      "data": workers},
                                     dcn_axes=("node",), device=device)
    else:
        machine = MachineSpec.detect(cfg.mesh_shape, device=device)
    have = world_size()
    if machine.num_devices > have:
        raise ValueError(f"mesh {dict(machine.mesh_axes)} needs "
                         f"{machine.num_devices} devices, have {have}")
    if machine.num_devices < have:
        raise ValueError(f"mesh {dict(machine.mesh_axes)} covers "
                         f"{machine.num_devices} devices of the world's "
                         f"{have}: one device a rank, the mesh spans them "
                         "all")
    return machine


def over_mesh(cfg) -> bool:
    """Whether a compile runs over the process group: the config names a
    mesh (`mesh_shape`, `--nodes`), or the started group has more than
    one rank. Otherwise it is the one-device program, no group needed."""
    from flexflow_tpu_torch.runtime.distributed import world_size

    return bool(cfg.mesh_shape) or cfg.num_nodes > 1 or world_size() > 1


def _zero_axes_of(mesh_axes: Dict[str, int]) -> List[str]:
    """The mesh axes ZeRO shards the moments over (JAX `compile.py:
    272-281`): the batch axes ("node", "data", else the first axis) of
    degree > 1; every other axis already partitions the params."""
    axes = [a for a in ("node", "data") if a in mesh_axes]
    if not axes and mesh_axes:
        axes = [next(iter(mesh_axes))]
    return [a for a in axes if mesh_axes[a] > 1]


def _zero_moment_dims(dims, shape, mesh_axes: Dict[str, int],
                      zero_axes: Sequence[str]) -> list:
    """One param's moment layout under ZeRO (JAX `_zero_moment_pspec`,
    `compile.py:284-300`): its own dims plus the full batch-axis degree
    on the first unsharded dim that degree divides; a param with no such
    dim, or already sharded over a batch axis, keeps its own. Mirrored by
    search/cost_model.py `zero_divisor`."""
    spec = list(dims) + [None] * (len(shape) - len(dims))
    used = {a for d in spec if d is not None
            for a in ((d,) if isinstance(d, str) else tuple(d))}
    if used & set(zero_axes):
        return spec
    deg = 1
    for a in zero_axes:
        deg *= mesh_axes[a]
    if deg <= 1:
        return spec
    for i, d in enumerate(spec):
        if d is None and shape[i] % deg == 0:
            spec[i] = zero_axes[0] if len(zero_axes) == 1 \
                else tuple(zero_axes)
            break
    return spec


def _overlay_parallel_ops(model, strategy: Strategy) -> None:
    """Each explicit parallel op's output takes the layout it requests
    (ops/parallel_ops.py `requested_dims`), over what the strategy gave
    it, as in JAX (`compile.py:92-112`)."""
    from flexflow_tpu_torch.ops.op_type import PARALLEL_OPS
    from flexflow_tpu_torch.ops.parallel_ops import requested_dims
    from flexflow_tpu_torch.parallel.sharding import OpSharding

    for layer in model.layers:
        if layer.op_type not in PARALLEL_OPS:
            continue
        src = layer.inputs[0]
        incoming = None
        if src.owner is not None:
            sh = strategy.op_shardings.get(src.owner.name)
            if sh and src.owner_idx < len(sh.outputs):
                incoming = sh.outputs[src.owner_idx]
        elif src.name in strategy.input_shardings:
            incoming = strategy.input_shardings[src.name]
        strategy.op_shardings[layer.name] = OpSharding(
            outputs=[requested_dims(layer, incoming)])


def _check_mesh_strategy(model, strategy: Strategy,
                         mesh_axes: Dict[str, int]) -> None:
    """Hold the strategy's ring, placement and expert layouts to their
    guards on this mesh (JAX's lowering guards): sequence-parallel
    attention (`seq_parallel`: the axis on the mesh, sq == sk dividing by
    its size, no dropout, no bias_k, no add_zero_attn, impl != "xla"), the
    placed fork-join (`inter:`: the axis on the mesh, one index a branch
    or groups summing to it, no stateful sub-op) and expert parallelism
    (`ep:`: the experts' axis on the mesh and dividing them). Raises
    ValueError naming the guard that failed."""
    from flexflow_tpu_torch.ops.fork_join import (grouped_placeable,
                                                  inter_placeable)
    from flexflow_tpu_torch.ops.op_type import OperatorType

    def need(ok, layer, what):
        if not ok:
            raise ValueError(f"layer {layer.name}: {what} (mesh "
                             f"{dict(mesh_axes)})")

    for layer in model.layers:
        sh = strategy.sharding_for(layer.name)
        p = layer.params
        sp = sh.attrs.get("seq_parallel")
        if sp is not None:
            what = f"sequence-parallel attention over {sp!r}"
            need(sp in mesh_axes, layer, f"{what}: the mesh has no such axis")
            q, k = layer.inputs[0].spec.shape, layer.inputs[1].spec.shape
            need(q[1] == k[1] and q[1] % mesh_axes[sp] == 0, layer,
                 f"{what}: sq {q[1]} == sk {k[1]} dividing by "
                 f"{mesh_axes[sp]} fails")
            need(not p.get("dropout"), layer, f"{what}: dropout > 0")
            need(not p.get("add_bias_kv") and not p.get("add_zero_attn"),
                 layer, f"{what}: add_bias_kv / add_zero_attn")
            need(p.get("impl", "auto") != "xla", layer,
                 f"{what}: impl='xla'")
        pa = sh.attrs.get("placement")
        if pa is not None:
            what = f"the placed fork-join (inter:{pa})"
            need(pa in mesh_axes, layer, f"{what}: the mesh has no such axis")
            groups = sh.attrs.get("placement_groups")
            k = len(layer.branches)
            if groups:
                gs = [int(g) for g in groups.split("-")]
                need(len(gs) == k and sum(gs) == mesh_axes[pa], layer,
                     f"{what}: groups {groups} for {k} branches over "
                     f"{mesh_axes[pa]} indices")
                need(grouped_placeable(layer), layer,
                     f"{what}: a stateful sub-op")
            else:
                need(mesh_axes[pa] == k, layer,
                     f"{what}: axis size {mesh_axes[pa]} != {k} branches")
                need(inter_placeable(layer), layer,
                     f"{what}: unequal branch outputs or a stateful sub-op")
        if layer.op_type in (OperatorType.EXPERTS, OperatorType.GROUP_BY):
            dims = (sh.weight_dims("kernel") if layer.op_type is
                    OperatorType.EXPERTS else sh.output_dims(0))
            ax = dims[0] if dims else None
            if ax is not None:
                what = f"expert parallelism (ep:{ax})"
                need(isinstance(ax, str) and ax in mesh_axes, layer,
                     f"{what}: the mesh has no such axis")
                e = (layer.weight_specs["kernel"].shape[0]
                     if layer.op_type is OperatorType.EXPERTS
                     else p["n_experts"])
                need(e % mesh_axes[ax] == 0, layer,
                     f"{what}: {e} experts over {mesh_axes[ax]} ranks")


def _search_machine(cfg, machine: MachineSpec) -> MachineSpec:
    """--search-num-nodes / --search-num-workers (reference config.h:
    154-155): search strategies for a machine LARGER than the real one
    (with --export, so big-machine strategies are found on a small host).
    Nodes map to a data axis across the network, workers to the
    intra-node model axis."""
    if not cfg.search_num_nodes and not cfg.search_num_workers:
        return machine
    nodes = max(1, cfg.search_num_nodes)
    workers = max(1, cfg.search_num_workers)
    axes = {"data": nodes, "model": workers}
    return MachineSpec(mesh_axes=axes, chip=machine.chip,
                       dcn_axes=("data",) if nodes > 1 else ())


def _pick_strategy(model, machine: MachineSpec, optimizer=None,
                   device=None) -> Strategy:
    """A strategy file, else a search of the search machine (the real
    mesh unless search_num_nodes / search_num_workers describe a larger
    one), else data parallel (JAX's order). No fallback: a search that
    fails raises."""
    cfg = model.config
    if cfg.import_strategy_file:
        strategy = Strategy.load(cfg.import_strategy_file)
    else:
        sm = _search_machine(cfg, machine)
        if sm.num_devices > machine.num_devices \
                and not cfg.export_strategy_file:
            warnings.warn(
                f"searching for machine {sm.mesh_axes} but executing on "
                f"{machine.mesh_axes}: shardings that don't fit the real mesh "
                "degrade to replicated — --search-num-nodes/"
                "--search-num-workers are meant to be paired with --export")
        if cfg.search_budget > 0 and not cfg.only_data_parallel \
                and sm.num_devices > 1:
            from flexflow_tpu_torch.search.optimize import graph_optimize

            # the optimizer rides along so the search's memory model can
            # price its moments (count and state dtype)
            with tel.span("compile/graph_optimize", cat="compile",
                          mesh=str(dict(sm.mesh_axes))):
                strategy = graph_optimize(model, sm, optimizer=optimizer,
                                          measure_device=device)
        else:
            strategy = data_parallel_strategy(model, machine)
    return strategy


def apply_log_level(cfg) -> None:
    """The config's `log_level` on the package's logger (never over a
    level the application set), as JAX's compile applies it."""
    level = getattr(logging, cfg.log_level.upper(), None)
    if not isinstance(level, int):
        raise ValueError(f"unknown log_level {cfg.log_level!r}")
    lg = logging.getLogger("flexflow_tpu_torch")
    if lg.level == logging.NOTSET:
        lg.setLevel(level)


@contextlib.contextmanager
def matmul_precision(cfg):
    """The config's `allow_tensor_op_math_conversion` for one program, as
    JAX applies its matmul precision per program: with False, every
    float32 product inside at full float32 precision (TF32 off for cuBLAS
    and cuDNN), the process's settings restored after; with True, the
    process's settings as they are."""
    if cfg.allow_tensor_op_math_conversion:
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def compile_serving(model, **kwargs):
    """The serving compile (serving/engine.py `compile_serving`), under
    JAX's second name for it."""
    from flexflow_tpu_torch.serving.engine import \
        compile_serving as _compile_serving

    return _compile_serving(model, **kwargs)


def compile_model(model, optimizer, loss_type, metrics: Sequence = (),
                  device=None, outputs=None) -> "CompiledModel":
    """The training program of `model`'s graph, its outputs `outputs`
    (default: the last layer's first output; the loss reads the first),
    under SGD at the config's `learning_rate` when no optimizer is given,
    as in JAX. The config's `telemetry_dir` turns on
    the span stream ("" leaves it as it is: turning it off is an explicit
    `telemetry.shutdown()`), and its `fault_plan` arms the fault injector
    (runtime/faults.py), as the JAX compile does."""
    device = resolve_device(device)
    cfg = model.config
    apply_log_level(cfg)
    if cfg.telemetry_dir:
        tel.configure(cfg.telemetry_dir, max_mb=cfg.telemetry_max_mb)
    if cfg.fault_plan:
        from flexflow_tpu_torch.runtime import faults

        faults.configure(cfg.fault_plan)
    with tel.span("compile/compile_model", cat="compile",
                  pipeline_stages=int(cfg.pipeline_stages)):
        return _compile_model(model, optimizer, loss_type, metrics, device,
                              outputs)


def _compile_model(model, optimizer, loss_type, metrics, device, outputs):
    optimizer = optimizer or SGDOptimizer(lr=model.config.learning_rate)
    if model.config.pipeline_stages > 1:
        return _compile_pipelined(model, optimizer, loss_type, metrics,
                                  device, outputs)
    machine = resolve_machine(model.config, device)
    mesh = build_mesh(machine, device) if over_mesh(model.config) else None
    strategy = _pick_strategy(model, machine, optimizer, device)
    _overlay_parallel_ops(model, strategy)
    if model.config.export_strategy_file:
        strategy.save(model.config.export_strategy_file)
    if outputs is None:
        outputs = model.layers[-1].outputs[:1] if model.layers else []
    return CompiledModel(model, optimizer, LossType.from_any(loss_type),
                         [MetricsType.from_any(m) for m in metrics],
                         list(outputs), device=device,
                         strategy=strategy, machine=machine, mesh=mesh)


def _compile_pipelined(model, optimizer, loss_type, metrics, device,
                       outputs):
    """--pipeline-stages S (JAX `compile.py:188-260`): the world splits into
    S stages of contiguous ranks. The machine describes the whole world;
    the stage machine takes the pipe dimension out of it (an explicit
    "pipe" axis, else the batch axis divided by S: dp.stage_machine_for),
    and the layouts inside a stage are picked on it (`_pick_strategy`: a
    strategy file, the search, or data parallel). The cuts come from the
    cut search when `search_budget > 0` (span `compile/pipeline_cut_search`)
    or from `balanced_cuts`; M = accum_steps microbatches an update. The
    completed strategy (layouts and its `pipeline` block) is stored in the
    strategy cache under the full machine's key, which covers the stage
    count, the schedule and M: a warm compile finds the block and skips
    both searches (zero DP expansions). A world smaller than S raises
    JAX's "need N devices, have M"."""
    from flexflow_tpu_torch.parallel.machine import stage_device_groups
    from flexflow_tpu_torch.parallel.pipeline import (PipelinedModel,
                                                      balanced_cuts)
    from flexflow_tpu_torch.runtime.distributed import world_size
    from flexflow_tpu_torch.search import cost_model as cmod
    from flexflow_tpu_torch.search import strategy_cache as sc
    from flexflow_tpu_torch.search.dp import (search_pipelined,
                                              stage_machine_for)

    cfg = model.config
    S = int(cfg.pipeline_stages)
    if world_size() < S:
        stage_device_groups(S, 1)
    machine = resolve_machine(cfg, device)
    stage_machine = stage_machine_for(machine, S)
    micro = max(1, int(cfg.accum_steps))
    searching = cfg.search_budget > 0 and not cfg.only_data_parallel
    strategy, key, cache_dir = None, None, None
    if searching and cfg.strategy_cache and not cfg.import_strategy_file:
        cache_dir = sc.resolve_dir(cfg)
        opt_mem = cmod.opt_mem_spec(optimizer, cfg, stage_machine)
        key = sc.cache_key(model, machine, cfg, "pipeline",
                           repr(opt_mem.fingerprint()) if opt_mem else "")
        hit = sc.lookup(cache_dir, key, model, stage_machine)
        if hit is not None and hit.pipeline:
            strategy = hit
        if world_size() > 1:
            # every rank has looked the key up before any rank stores it
            import torch.distributed as dist

            dist.barrier()
    if strategy is None:
        strategy = _pick_strategy(model, stage_machine, optimizer, device)
    if strategy.pipeline and int(strategy.pipeline.get("stages", S)) != S:
        raise ValueError(f"imported strategy pipelines "
                         f"{strategy.pipeline.get('stages')} stages but "
                         f"--pipeline-stages is {S}")
    if not strategy.pipeline:
        cuts = None
        if searching:
            with tel.span("compile/pipeline_cut_search", cat="compile",
                          stages=S, micro=micro):
                r = search_pipelined(
                    model, machine, S, micro,
                    schedule=cfg.pipeline_schedule,
                    mem_budget=machine.hbm_bytes if cfg.memory_search
                    else None,
                    opt_mem=cmod.opt_mem_spec(optimizer, cfg, stage_machine))
            if r is not None:
                cuts = list(r.cuts)
                strategy._pipeline_search = r
        if cuts is None:
            cuts = balanced_cuts(model, stage_machine, S)
        strategy.pipeline = {"stages": S, "cuts": cuts,
                             "schedule": cfg.pipeline_schedule}
        if key is not None:
            from flexflow_tpu_torch.runtime.distributed import rank

            if rank() == 0:  # the same search on every rank: one writer
                sc.store(cache_dir, key, strategy,
                         meta={"pipeline": strategy.pipeline})
            strategy._cache_info = {"event": "miss", "key": key,
                                    "dir": cache_dir}
    _overlay_parallel_ops(model, strategy)
    if cfg.export_strategy_file:
        strategy.save(cfg.export_strategy_file)
    if outputs is None:
        outputs = model.layers[-1].outputs[:1] if model.layers else []
    pm = PipelinedModel(model, machine, stage_machine, strategy, optimizer,
                        LossType.from_any(loss_type),
                        [MetricsType.from_any(m) for m in metrics],
                        list(outputs), device=device)
    pm.search_cache_info = getattr(strategy, "_cache_info", None)
    return pm


def _host_or_tensor(value):
    """A weight value as `to_device` takes it: a tensor detached from any
    autograd graph (on any device, copied there without a host round
    trip), anything else as a numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    return np.asarray(value)


def _local(x):
    """A DTensor's block on this rank (the tensor itself otherwise)."""
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def _rows_apart(logits, label) -> bool:
    """Whether the loss can read its rows on each rank alone: both are
    DTensors, each mesh dim shards them on the same dim or on none, the
    logits' last dim is whole and nothing is pending."""
    from torch.distributed.tensor import DTensor, Shard

    if not (isinstance(logits, DTensor) and isinstance(label, DTensor)):
        return False
    last = logits.ndim - 1
    for a, b in zip(logits.placements, label.placements):
        if a.is_partial() or b.is_partial():
            return False
        if isinstance(a, Shard) != isinstance(b, Shard):
            return False
        if isinstance(a, Shard) and (a.dim % logits.ndim == last
                                     or a.dim % logits.ndim
                                     != b.dim % label.ndim):
            return False
    return True


def _full(x):
    """A DTensor's full value on every rank, a plain tensor (a collective:
    every rank calls it, by c10d: `runtime.distributed.full_local`); the
    tensor itself otherwise. Nothing is differentiated through it."""
    from flexflow_tpu_torch.runtime.distributed import full_local

    return full_local(x)


def _classes_whole(logits):
    """Logits whose class (last) dim a mesh dim shards, made whole on it
    by c10d with the gradient sliced back (`relayout_grad`); the loss
    then reads whole rows. DTensor's own redistribute here takes the
    functional all-gather, which gloo does not carry on CUDA tensors."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from flexflow_tpu_torch.runtime.distributed import relayout_grad

    if not isinstance(logits, DTensor):
        return logits
    last = logits.ndim - 1
    pl = [Replicate() if isinstance(p, Shard) and p.dim % logits.ndim == last
          else p for p in logits.placements]
    return (logits if pl == list(logits.placements)
            else relayout_grad(logits, pl))


class CompiledModel:
    def __init__(self, model, optimizer, loss_type: LossType,
                 metrics: List[MetricsType], outputs, device=None,
                 strategy: Optional[Strategy] = None,
                 machine: Optional[MachineSpec] = None, mesh=None):
        self.device = resolve_device(device)
        # the DeviceMesh the program runs over, or None (one device)
        self.mesh = mesh
        self.model = model
        self.cfg = model.config
        self.optimizer = optimizer
        self.loss_type = loss_type
        self.metrics = metrics
        # the machine the cost model prices this compile on (one device)
        self.machine = machine or resolve_machine(self.cfg, self.device)
        self.strategy = strategy or data_parallel_strategy(model, self.machine)
        if mesh is not None:
            _check_mesh_strategy(model, self.strategy, self._axes)
        # this compile's strategy-cache event (None when nothing searched)
        self.search_cache_info = getattr(self.strategy, "_cache_info", None)
        # the last fit's auto_refit info (learned_cost.auto_refit)
        self.refit_info = None
        # --remat (deprecated alias): uniform "full" per-layer policy
        if self.cfg.remat and not self.strategy.remat:
            self.strategy.remat = {l.name: "full" for l in model.layers}
        self.outputs = list(outputs)
        # the model's L1/L2 penalties as the compile found them, added to
        # the f32 loss of every train step (JAX reads them at compile too)
        self._regularizers = {k: list(v) for k, v in
                              model._weight_regularizers.items()}
        self.forward_fn = self._build_forward()
        # optimizer updates taken (the fit rng and checkpoints count them)
        self._iteration = 0
        # recompile_on_condition's (trigger, alter), or None
        self.recompile_state = None
        self.fused_loss_mode = str(self.cfg.fused_loss)
        fused_opt_mode = str(self.cfg.fused_optimizer)
        self.fopt_plan = None
        if fused_opt_mode != "off" and (self.cfg.enable_fusion
                                        or fused_opt_mode == "on"):
            self.fopt_plan = fused_optim.plan_for(optimizer)
            if fused_opt_mode == "on" and self.fopt_plan is None:
                raise ValueError(
                    f"--fused-optimizer=on but {type(optimizer).__name__} is "
                    "not a recognized Adam/SGD configuration")
        # microbatches per optimizer update (cfg default; a fit call may
        # override it, and the next fit without one goes back to cfg's)
        self._accum_steps = max(1, int(self.cfg.accum_steps))
        # the last fit's dispatches, host_syncs, barriers and fused_steps
        self.step_stats: Dict[str, int] = {}
        # make_multi_step(K) per K, cleared when fit changes accum_steps or
        # the sentinels (the (accum, sentinels) the cache was built for)
        self._multi_cache: Dict[int, Any] = {}
        self._steps_key = (self._accum_steps, bool(self.cfg.health_sentinels))
        # run health (health.py): the drift monitor's (steps, seconds) per
        # epoch of the last fit, its goodput meter, the memory watermarks
        # since init, and the last fit's sentinel monitor
        self._drift_windows: List[tuple] = []
        self._goodput: Optional[health.GoodputMeter] = None
        self._watermarks = health.WatermarkTracker()
        self._sentinels: Optional[health.SentinelMonitor] = None
        self.params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.state: Dict[str, Any] = {}
        self.opt_state: Optional[Dict[str, Any]] = None
        # over a mesh: each weight's placements and its update layout
        # (the moments', the gradient's after its sync; the param's own
        # unless ZeRO shards the moments further), and under ZeRO each
        # rank's f32 block of the param that the optimizer updates
        self._zero = self._zero_mode()
        self._w_pl: Dict[tuple, list] = {}
        self._u_pl: Dict[tuple, list] = {}
        self._zbuf: Dict[tuple, torch.Tensor] = {}
        if mesh is not None:
            self._layouts()

    def _build_steps(self) -> None:
        """Rebuild the forward and the step programs after the strategy
        changed (a template applied to `cm.strategy` after compile, as
        JAX's tests do before `init`), and over a mesh the weights'
        layouts."""
        if self.mesh is not None:
            _check_mesh_strategy(self.model, self.strategy, self._axes)
            self._layouts()
        self.forward_fn = self._build_forward()
        self._multi_cache.clear()

    def _build_forward(self):
        fwd = build_forward(self.model.layers, self.model.input_tensors,
                            self.outputs, compute_dtype=self.cfg.compute_dtype,
                            enable_fusion=self.cfg.enable_fusion,
                            remat=self.strategy.remat, mesh=self.mesh,
                            strategy=self.strategy)
        fwd.layer_ranges = bool(self.cfg.profiling)
        return fwd

    # ------------------------------------------------------------- sharding
    @property
    def _axes(self) -> Dict[str, int]:
        return dict(self.machine.mesh_axes)

    def _pl(self, dims, shape) -> list:
        """The placements of `dims` for a tensor of `shape`
        (`sharding.mesh_placements`)."""
        return mesh_placements(dims, shape, self.mesh)

    def _weight_dims(self, layer_name: str, wname: str, shape) -> list:
        dims = self.strategy.sharding_for(layer_name).weight_dims(wname)
        return dims if (constrainable(dims, shape, self._axes) and
                        placements(dims, self.mesh) is not None) else []

    def _zero_mode(self) -> str:
        """cfg.zero_sharding, off without a mesh or on a mesh with no
        batch axis of degree > 1 (JAX `compile.py:451-460`)."""
        mode = (self.cfg.zero_sharding or "off").lower()
        if mode not in ("off", "zero1", "zero2"):
            raise ValueError(f"zero_sharding={self.cfg.zero_sharding!r} "
                             "(choose from off/zero1/zero2)")
        if mode != "off" and (self.mesh is None
                              or not _zero_axes_of(self._axes)):
            return "off"
        return mode

    def _layouts(self) -> None:
        """Each weight's placements (its strategy dims where they apply)
        and its update layout: the moments' (JAX `_moment_shardings`),
        which under ZeRO adds the batch axes on the first free dim they
        divide."""
        za = _zero_axes_of(self._axes)
        for layer in self._weight_layers():
            for w, spec in layer.weight_specs.items():
                dims = self._weight_dims(layer.name, w, spec.shape)
                self._w_pl[layer.name, w] = self._pl(dims, spec.shape)
                udims = (_zero_moment_dims(dims, spec.shape, self._axes, za)
                         if self._zero != "off" else dims)
                self._u_pl[layer.name, w] = self._pl(udims, spec.shape)

    def input_placements(self, tensor, lead: int = 0) -> list:
        """A graph input's placements (JAX `input_sharding`), with `lead`
        unsharded leading dims (accumulation's microbatches, the K steps
        of one dispatch)."""
        dims = [None] * lead + self.strategy.input_dims(tensor.name)
        return self._pl(dims, (1,) * lead + tuple(tensor.shape))

    def label_placements(self, shape, lead: int = 0) -> list:
        """The label's placements: a label of class ids (one dim fewer
        than the logits) takes the logits' layout without the class dim
        where the strategy pins one (a sequence-sharded output's labels
        are sharded so too, and the loss reads both on local rows); else
        JAX's `label_sharding`, dim 0 over "data" (else the first axis)
        when its degree divides it."""
        out = self.outputs[0] if self.outputs else None
        if out is not None and out.owner is not None and \
                len(shape) - lead == out.spec.ndim - 1:
            od = self.strategy.sharding_for(out.owner.name).output_dims(
                out.owner_idx)[:-1]
            if od and not pins_nothing(od):
                return self._pl([None] * lead + od, tuple(shape))
        ax = "data" if "data" in self._axes else next(iter(self._axes))
        dims = [None] * lead + ([ax] if len(shape) > lead else [])
        return self._pl(dims, tuple(shape))

    def _put(self, x, pl):
        """Data as the DTensor of placements `pl` (JAX `_put`): a DTensor
        passes as it is; a full array or tensor, which every rank holds,
        gives each rank its own block, and nothing is sent."""
        from torch.distributed.tensor import DTensor

        from flexflow_tpu_torch.runtime.distributed import \
            global_batch_from_full

        if isinstance(x, DTensor):
            return x
        return global_batch_from_full(x, self.mesh, pl)

    def _feed(self, inputs, label, lead: int = 0):
        """The step's inputs and label on the device: over a mesh as the
        DTensors of their layouts (`lead` stacked leading dims)."""
        if self.mesh is None:
            return ([to_device(x, self.device) for x in inputs],
                    to_device(label, self.device))
        ins = [self._put(x, self.input_placements(t, lead))
               for x, t in zip(inputs, self.model.input_tensors)]
        return ins, self._put(label, self.label_placements(
            tuple(label.shape), lead))

    def _host_rows(self, lead: int):
        """The loader's cut for this rank (runtime/dataloader.py `rows` and
        `wrap`): rows(kind, i, array) -> this rank's block of batch array
        i (the inputs, then the label) with `lead` stacked dims, one more
        in a K-step group (kind "k"); wrap(kind, dx, dy, shapes) makes the
        device blocks DTensors of the full `shapes`."""
        from flexflow_tpu_torch.runtime.distributed import (host_local_batch,
                                                            local_rows)

        def pls(k, i, shape):
            n = lead + (k == "k")
            ts = self.model.input_tensors
            return (self.input_placements(ts[i], n) if i < len(ts)
                    else self.label_placements(shape, n))

        def rows(k, i, arr):
            return local_rows(arr, self.mesh, pls(k, i, arr.shape))

        def wrap(k, dx, dy, shapes):
            out = [host_local_batch(t, self.mesh, pls(k, i, shapes[i]))
                   for i, t in enumerate(list(dx) + [dy])]
            return out[:-1], out[-1]
        return rows, wrap

    # ---------------------------------------------------------------- init
    def _weight_layers(self):
        return [l for l in topo_order(self.model.layers) if l.weight_specs]

    def init(self, seed: Optional[int] = None):
        """Random f32 master weights from a `torch.Generator` seeded with
        `seed` (default cfg.seed), drawn on the device with the JAX
        package's default initializers (other numbers than JAX's), and a
        fresh optimizer state."""
        seed = self.cfg.seed if seed is None else seed
        return self.load_params(init_params(
            self._weight_layers(), self.model._initializer_overrides, seed,
            self.device))

    def load_params(self, params):
        """Adopt a params tree `{layer: {weight: tensor or array}}` as the
        f32 master weights on the device (a copy), with a fresh optimizer
        state."""
        layers = self._weight_layers()
        diffs = sorted(set(params) ^ {l.name for l in layers})
        if diffs:
            raise ValueError(f"params tree does not match the model: "
                             f"layers {diffs[:8]}")
        placed = {}
        for layer in layers:
            placed[layer.name] = {
                w: self._place(params[layer.name][w], spec, f"{layer.name}.{w}",
                               (layer.name, w))
                for w, spec in sorted(layer.weight_specs.items())}
        self.params = placed
        self.state = {}
        self.opt_state = self._init_opt_state(placed)
        # the first watermark: the persistent footprint right after init
        self._watermarks.sample("init", self._local_trees(), self.device)
        return self.params

    def _place(self, value, spec, what: str, key=None) -> torch.Tensor:
        """A weight as the f32 master copy on the device; over a mesh, the
        DTensor of its placements, each rank keeping its own block of the
        full value (sharded at birth: every world holds the weights of
        world 1)."""
        x = to_device(value, self.device)
        if tuple(x.shape) != tuple(spec.shape):
            raise ValueError(f"{what}: shape {tuple(x.shape)} vs expected "
                             f"{tuple(spec.shape)}")
        x = x.to(spec.dtype.torch_dtype)
        if self.mesh is not None:
            from torch.distributed.tensor import DTensor

            from flexflow_tpu_torch.runtime.distributed import local_rows

            pl = self._w_pl[key]
            local = local_rows(x, self.mesh, pl).clone(
                memory_format=torch.contiguous_format)
            return DTensor.from_local(local, self.mesh, pl,
                                      run_check=False).requires_grad_(
                                          x.is_floating_point())
        x = x.clone(memory_format=torch.contiguous_format)
        return x.requires_grad_(x.is_floating_point())

    def _zero_block(self, key, t: torch.Tensor) -> torch.Tensor:
        """The block of a param's local tensor `t` that this rank updates
        under ZeRO: the chunk of the update layout's extra shard dim at
        this rank's coordinate on each ZeRO axis (a view)."""
        from torch.distributed.tensor import Shard

        coord = self.mesh.get_coordinate()
        wpl, upl = self._w_pl[key], self._u_pl[key]
        for j, (a, b) in enumerate(zip(wpl, upl)):
            if isinstance(b, Shard) and not isinstance(a, Shard):
                n = self.mesh.size(j)
                t = t.chunk(n, dim=b.dim)[coord[j]]
        return t

    def _init_opt_state(self, params):
        """The optimizer's state; over a mesh its moment trees are
        DTensors of the update layouts (sharded at birth under ZeRO), and
        ZeRO's param blocks are allocated."""
        if self.mesh is None:
            return self.optimizer.init_state(params)
        from torch.distributed.tensor import DTensor

        blocks = {}
        for l, ws in params.items():
            blocks[l] = {}
            for w, p in ws.items():
                blk = self._zero_block((l, w), p.to_local())
                blocks[l][w] = torch.empty(blk.shape, dtype=blk.dtype,
                                           device=blk.device)
                if self._w_pl[l, w] != self._u_pl[l, w]:
                    self._zbuf[l, w] = blocks[l][w]
        st = self.optimizer.init_state(blocks)
        for k, v in st.items():
            if isinstance(v, dict):
                st[k] = {l: {w: DTensor.from_local(t, self.mesh,
                                                   self._u_pl[l, w],
                                                   run_check=False)
                             for w, t in ws.items()} for l, ws in v.items()}
        return st

    def _local_trees(self):
        """(params, opt_state) with each DTensor as this rank's block: what
        the rank holds."""
        def loc(x):
            if isinstance(x, dict):
                return {k: loc(v) for k, v in x.items()}
            return _local(x)
        return loc(self.params or {}), loc(self.opt_state or {})

    # ---------------------------------------------------------------- steps
    def _loss(self, logits, label):
        if fused_ce.use_fused_ce(self.loss_type, logits, self.fused_loss_mode,
                                 self.cfg.enable_fusion):
            return fused_ce.fused_cross_entropy(logits, label)
        if self.mesh is not None:
            logits = _classes_whole(logits)
            if _rows_apart(logits, label):
                return self._local_loss(logits, label)
        return compute_loss(self.loss_type, logits.float(), label)

    def _local_loss(self, logits, label):
        """The loss over a mesh where the logits and the label are sharded
        alike and the class dim whole: each rank's mean over its rows,
        weighted by its share of them, as a pending sum over the sharded
        mesh dims (DTensor's `Partial`), which the global mean resolves."""
        from torch.distributed.tensor import DTensor, Partial, Replicate

        xl = logits.to_local()
        share = xl.numel() / logits.numel()
        part = compute_loss(self.loss_type, xl.float(), label.to_local())
        pl = [Replicate() if p.is_replicate() else Partial()
              for p in logits.placements]
        return DTensor.from_local(part * share if share != 1 else part,
                                  self.mesh, pl, run_check=False)

    def _apply_update(self, params, opt_state, grads):
        if self.mesh is not None:
            return self._mesh_update(params, opt_state, grads)
        if self.fopt_plan is not None:
            return fused_optim.fused_update(self.fopt_plan, grads, opt_state,
                                            params)
        return self.optimizer.update(grads, opt_state, params)

    @torch.no_grad()
    def _mesh_update(self, params, opt_state, grads):
        """The update over a mesh, on each rank's blocks: the optimizer
        (the fused kernel, one launch over the rank's leaves) writes the
        local params and moments in place; under ZeRO it updates the
        rank's block of each param, whose all-gather then rewrites the
        full param (JAX `compile.py:619-645`). `grads` are synced."""
        lp, lg = {}, {}
        for l, ws in params.items():
            lp[l], lg[l] = {}, {}
            for w, p in ws.items():
                lg[l][w] = _local(grads[l][w]).contiguous()
                buf = self._zbuf.get((l, w))
                if buf is None:
                    lp[l][w] = _local(p)
                else:
                    buf.copy_(self._zero_block((l, w), _local(p)))
                    lp[l][w] = buf
        ls = {k: ({l: {w: _local(t) for w, t in ws.items()}
                   for l, ws in v.items()} if isinstance(v, dict) else v)
              for k, v in opt_state.items()}
        if self.fopt_plan is not None:
            ls = fused_optim.fused_update(self.fopt_plan, lg, ls, lp)
        else:
            ls = self.optimizer.update(lg, ls, lp)
        for k, v in ls.items():
            if not isinstance(v, dict):
                opt_state[k] = v  # Adam's count
        for key, buf in self._zbuf.items():
            self._zero_gather(key, buf, _local(params[key[0]][key[1]]))
        return opt_state

    def _zero_gather(self, key, buf: torch.Tensor, out: torch.Tensor) -> None:
        """ZeRO's all-gather: each rank's updated block `buf` of a param
        into its full local tensor `out`, along the update layout's shard
        dim over each ZeRO axis's group (the last axis first, as the
        blocks nest), by c10d's `all_gather_into_tensor` (on a dim 0
        block straight into `out`)."""
        import torch.distributed as dist
        from torch.distributed.tensor import Shard

        axes = [(j, b.dim) for j, (a, b) in enumerate(
            zip(self._w_pl[key], self._u_pl[key]))
            if isinstance(b, Shard) and not isinstance(a, Shard)]
        t = buf
        for i, (j, d) in enumerate(reversed(axes)):
            n, group = self.mesh.size(j), self.mesh.get_group(j)
            if d == 0 and i == len(axes) - 1:
                dist.all_gather_into_tensor(out, t.contiguous(), group=group)
                return
            flat = torch.empty((n * t.numel(),), dtype=t.dtype,
                               device=t.device)
            dist.all_gather_into_tensor(flat, t.contiguous().view(-1),
                                        group=group)
            t = torch.cat(flat.view(n, *t.shape).unbind(0), dim=d)
        out.copy_(t)

    def value_and_grads(self, params, state, inputs, label, rng=None):
        """Forward in training mode (its dropout drawn from `rng`), loss,
        and the gradient of every floating param: (loss, logits,
        new_state, grads tree). Over a mesh the loss is the global mean,
        a plain tensor on every rank, and the gradients are DTensors as
        autograd leaves them (a pending sum over the batch axes)."""
        inputs, label = self._feed(inputs, label)
        order = [(l, w) for l, ws in params.items() for w, t in ws.items()
                 if t.requires_grad]
        with matmul_precision(self.cfg):
            outs, new_state = self.forward_fn(params, state, inputs,
                                              training=True, rng=rng)
            logits = outs[0]
            loss = self._loss(logits, label)
            for (ln, wn), terms in self._regularizers.items():
                w = params[ln][wn].float()
                for mode, lam in terms:
                    loss = loss + lam * (w.abs().sum() if mode == "l1"
                                         else (w * w).sum())
            # a param the outputs do not reach (compiled with `outputs=`
            # short of the last layer) gets a zero gradient, as jax.grad
            # gives it
            flat = torch.autograd.grad(loss, [params[l][w] for l, w in order],
                                       allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (l, w), g in zip(order, flat):
            grads.setdefault(l, {})[w] = (torch.zeros_like(params[l][w])
                                          if g is None else g)
        return _full(loss.detach()), logits.detach(), new_state, grads

    def _metrics(self, logits, label):
        # no f32 copy of the logits when there is no metric to compute
        if not self.metrics:
            return {}
        with torch.no_grad():
            # over a mesh the metrics read the gathered logits
            return compute_metrics(self.metrics, _full(logits).float(),
                                   _full(label))

    def train_step(self, params, opt_state, state, inputs, label, rng=None):
        """One optimizer update: `value_and_grads`, then the update, or
        with accum_steps N > 1 the accumulating step over the (N, ...)
        microbatches of `inputs` and `label`. `rng` is the step's key
        (flexflow_tpu_torch/random.py; a model with dropout needs one).
        `params` and `opt_state` are updated in place and returned with the
        new state, the loss and the metrics (device scalars)."""
        if self._accum_steps > 1:
            return self._accum_step(params, opt_state, state, inputs, label,
                                    rng)
        inputs, label = self._feed(inputs, label)
        loss, logits, new_state, grads = self.value_and_grads(
            params, state, inputs, label, rng)
        grads = self._sync_grads(grads)
        sentinels = self._sentinel_metrics(loss, grads)
        opt_state = self._apply_update(params, opt_state, grads)
        mvals = self._metrics(logits, label)
        if sentinels:
            mvals = dict(mvals, **sentinels)
        return params, opt_state, new_state, loss, mvals

    def _sentinel_metrics(self, loss, grads) -> Dict[str, torch.Tensor]:
        """With `health_sentinels`: the grad global norm and the
        non-finite flag of this update, device scalars computed before the
        optimizer runs (health.sentinel_metrics); else {}."""
        if not self.cfg.health_sentinels:
            return {}
        with torch.no_grad():
            norm = (health.grad_global_norm(grads) if self.mesh is None
                    else self._mesh_grad_norm(grads))
            return health.sentinel_metrics(loss, norm)

    def _sync_grads(self, grads):
        """Over a mesh, each gradient in its update layout: the pending
        sum over the batch axes all-reduced to the param's layout, or
        under ZeRO reduce-scattered to the moments' (JAX constrains the
        gradients to the moment shardings, `compile.py:619-631`). The
        identity on one device."""
        if self.mesh is None:
            return grads
        return {l: {w: g.redistribute(self.mesh, self._u_pl[l, w])
                    for w, g in ws.items()} for l, ws in grads.items()}

    def _mesh_grad_norm(self, grads) -> torch.Tensor:
        """The global L2 norm of synced DTensor gradients: each rank's
        blocks' squares over their replicas, summed over the world in one
        all-reduce."""
        import torch.distributed as dist
        from torch.distributed.tensor import Replicate

        sq = None
        for ws in grads.values():
            for g in ws.values():
                reps = 1
                for j, p in enumerate(g.placements):
                    if isinstance(p, Replicate):
                        reps *= self.mesh.size(j)
                part = torch.linalg.vector_norm(_local(g).float()) ** 2 / reps
                sq = part if sq is None else sq + part
        if sq is None:
            return torch.zeros((), dtype=torch.float32)
        dist.all_reduce(sq)
        return torch.sqrt(sq)

    def _accum_step(self, params, opt_state, state, inputs, label, rng=None):
        n = self._accum_steps
        inputs, label = self._feed(inputs, label, lead=1)
        want = [(n, *t.shape) for t in self.model.input_tensors]
        got = [tuple(x.shape) for x in inputs]
        if got != want or label.dim() < 2 or label.shape[0] != n:
            raise ValueError(
                f"accum_steps={n}: inputs {want} and a label with a leading "
                f"({n}, ...) microbatch dim needed; got inputs {got}, label "
                f"{tuple(label.shape)}")
        gsum = lsum = msum = None
        for j in range(n):
            # microbatch j draws from fold_in(rng, j), as in JAX
            loss, logits, state, grads = self.value_and_grads(
                params, state, [x[j] for x in inputs], label[j],
                None if rng is None else ff_random.fold_in(rng, j))
            mvals = self._metrics(logits, label[j])
            if self._zero == "zero2":
                # each microbatch's gradient reduce-scattered before it
                # joins the sum, which is then held sharded
                grads = self._sync_grads(grads)
            if gsum is None:
                gsum, lsum, msum = grads, loss, mvals
                continue
            for l, ws in grads.items():
                for w, g in ws.items():
                    gsum[l][w].add_(g)
            lsum = lsum + loss
            msum = {k: msum[k] + v for k, v in mvals.items()}
        inv = 1.0 / n
        for ws in gsum.values():
            for g in ws.values():
                g.mul_(inv)
        loss = lsum * inv
        gsum = self._sync_grads(gsum)
        sentinels = self._sentinel_metrics(loss, gsum)
        opt_state = self._apply_update(params, opt_state, gsum)
        mvals = {k: v * inv for k, v in msum.items()}
        if sentinels:
            mvals = dict(mvals, **sentinels)
        return params, opt_state, state, loss, mvals

    def _run_steps(self, n: int, params, opt_state, state, inputs, labels,
                   rng, i0=0):
        """n train steps over the stacked (n, ...) `inputs` and `labels`,
        step i keyed fold_in(rng, i0 + i); the mean loss and metrics, the
        sums taken in step order, as the JAX multi-step's. `rng` and `i0`
        may be host ints or device int64 scalars."""
        lsum, msum = None, {}
        for i in range(n):
            params, opt_state, state, loss, mv = self.train_step(
                params, opt_state, state, [x[i] for x in inputs], labels[i],
                None if rng is None else ff_random.fold_in(rng, i0 + i))
            if lsum is None:
                lsum, msum = loss, mv
            else:
                lsum = lsum + loss
                msum = {k: msum[k] + v for k, v in mv.items()}
        return (params, opt_state, state, lsum / n,
                {k: v / n for k, v in msum.items()})

    def make_multi_step(self, n: int):
        """n train steps as one dispatch (JAX `make_multi_step`): returns
        fn(params, opt_state, state, stacked_inputs, stacked_labels, rng,
        i0=0) -> (params, opt_state, state, mean_loss, mean_metrics), the
        stacked tensors with a leading n dim, step i keyed fold_in(rng,
        i0 + i) (`rng` = fit's base key gives the rng stream of n single
        steps at iterations i0 .. i0 + n - 1). On the card it is one CUDA
        graph of the n steps, captured at the first call and replayed at
        every call (compiler/graph_steps.py); on the CPU the n steps run
        eagerly. Params and the optimizer state are updated in place, as
        by `train_step`: write the returned trees back."""
        n = int(n)
        if n < 1:
            raise ValueError(f"make_multi_step: n={n}, need n >= 1")
        if self.device.type == "cuda":
            from flexflow_tpu_torch.compiler.graph_steps import GraphedSteps
            from flexflow_tpu_torch.runtime.distributed import backend_name

            if self.mesh is not None and backend_name() == "gloo":
                raise ValueError(
                    f"make_multi_step({n}) over a gloo process group: gloo's "
                    "collectives cannot be captured in a CUDA graph (use "
                    "NCCL, or steps_per_dispatch=1)")
            return GraphedSteps(self, n)

        def multi(params, opt_state, state, inputs, labels, rng, i0=0):
            inputs, labels = self._feed_stacked(inputs, labels)
            return self._run_steps(n, params, opt_state, state, inputs,
                                   labels, rng, i0)
        return multi

    def _feed_stacked(self, inputs, labels):
        """A dispatch's stacked (n, ...) inputs and labels as `_feed`
        gives them (one more stacked dim under accumulation)."""
        return self._feed(list(inputs), labels,
                          1 + int(self._accum_steps > 1))

    def _get_multi(self, k: int):
        """make_multi_step(k), one per width per (accumulation, sentinels)
        setting (fit clears the cache when either changes, as JAX rebuilds
        its steps)."""
        fn = self._multi_cache.get(k)
        if fn is None:
            fn = self._multi_cache[k] = self.make_multi_step(k)
        return fn

    @torch.no_grad()
    def eval_step(self, params, state, inputs, label):
        inputs, label = self._feed(inputs, label)
        with matmul_precision(self.cfg):
            outs, _ = self.forward_fn(params, state, inputs)
        logits = outs[0].float()
        loss = _full(compute_loss(self.loss_type, logits, label))
        return loss, compute_metrics(self.metrics, _full(logits),
                                     _full(label))

    @torch.no_grad()
    def infer(self, params, state, inputs):
        """The outputs (DTensors over a mesh)."""
        if self.mesh is None:
            ins = [to_device(x, self.device) for x in inputs]
        else:
            ins = [self._put(x, self.input_placements(t))
                   for x, t in zip(inputs, self.model.input_tensors)]
        with matmul_precision(self.cfg):
            outs, _ = self.forward_fn(params, state, ins)
        return outs

    def _coerce_batch(self, batch_size: Optional[int]) -> int:
        gb = self.model.input_tensors[0].shape[0]
        if batch_size is not None and batch_size != gb:
            warnings.warn(f"batch_size={batch_size} coerced to graph batch "
                          f"{gb} (rebuild the model to change it)")
        return gb

    # ------------------------------------------------------------- training
    def fit(self, x, y, batch_size: Optional[int] = None,
            epochs: Optional[int] = None, callbacks=None, verbose: bool = True,
            sync_every: Optional[int] = None,
            steps_per_dispatch: Optional[int] = None,
            accum_steps: Optional[int] = None,
            resume: Optional[str] = None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every_steps: Optional[int] = None,
            checkpoint_every_secs: Optional[float] = None):
        """Train for `epochs` over (x, y), shuffled by the config's seed,
        the batches copied ahead by `prefetch_multi`. With accum_steps
        N > 1 every N consecutive batches make one update; with
        steps_per_dispatch K > 1 every K updates make one dispatch of
        `make_multi_step(K)` (None = the config's values). The loss stays
        on the device and is read every `sync_every` updates (0 = at epoch
        end only); a callback with `on_batch_end(iteration, logs)` reads it
        after every update and forces K = 1. `checkpoint_dir`,
        `checkpoint_every_steps`/`_secs` and `resume` (None = the
        config's) take durable snapshots, drain on SIGTERM or SIGINT (a
        final snapshot, then `Preempted`) and resume the same trajectory
        (runtime/resilience.py). Returns one summary dict per epoch;
        `step_stats` counts the fit's dispatches, mid-epoch host syncs,
        barriers and fused steps.

        Run health and telemetry (health.py, telemetry.py): the goodput
        meter laps the loop's wall clock into buckets; with
        `health_sentinels` the step's grad norm and non-finite flag are
        read at the syncs the loop already makes, and `halt_on_nonfinite`
        raises `NonFiniteError` naming the last durable checkpoint;
        memory is sampled at each epoch's end; with telemetry on, the loop
        emits its `fit/*` spans. Under `profiling` the fit runs inside
        `torch.profiler` (K = 1: a CUDA graph's replay cannot be credited
        to layers), whose Chrome trace goes under `profile_dir`; with
        `profile_ops` the fit ends with `op_attribution`."""
        from flexflow_tpu_torch.runtime.resilience import FitResilience

        xs = x if isinstance(x, (list, tuple)) else [x]
        epochs = epochs or self.cfg.epochs
        sync_every = self.cfg.sync_every if sync_every is None else sync_every
        if steps_per_dispatch is None:
            steps_per_dispatch = self.cfg.steps_per_dispatch
        accum = max(1, int(self.cfg.accum_steps if accum_steps is None
                           else accum_steps))
        steps_key = (accum, bool(self.cfg.health_sentinels))
        if steps_key != self._steps_key:
            # the multi-step programs were built for the old width, or
            # with the sentinels the other way
            self._multi_cache.clear()
            self._steps_key = steps_key
        self._accum_steps = accum
        if self.params is None:
            self.init()
        batch_size = self._coerce_batch(batch_size or self.cfg.batch_size)
        res = FitResilience.build(self, resume, checkpoint_dir,
                                  checkpoint_every_steps,
                                  checkpoint_every_secs)
        if res is not None:
            res.set_effective(batch_size, accum)
        # restoring a snapshot is the "resume" bucket: it happens before
        # any epoch's wall clock starts
        gm = self._goodput = health.GoodputMeter()
        t_res = time.perf_counter()
        progress = res.resume_now(verbose) if res is not None else None
        gm.add("resume", time.perf_counter() - t_res)
        loader = SingleDataLoader(xs, y, batch_size, shuffle=True,
                                  seed=self.cfg.seed)
        self._drift_windows = []
        prof, pdir = None, None
        if self.cfg.profiling:
            pdir = self.cfg.profile_dir or "./ff_profile"
            os.makedirs(pdir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        try:
            history = self._fit_epochs(epochs, loader, batch_size, callbacks,
                                       verbose, sync_every,
                                       steps_per_dispatch, res, progress, gm)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                path = os.path.join(pdir, f"fit-{os.getpid()}-"
                                    f"{time.time_ns()}.pt.trace.json")
                prof.export_chrome_trace(path)
                if verbose:
                    print(f"[profiling] trace written to {path}")
        self._fit_end_report(verbose)
        # per-op work only on the success path: --profile-ops attributes
        # the fit's measured step to its ops when someone reads the result
        # (the printed table or the telemetry corpus), and not when
        # profile_report below runs the same join anyway
        will_report = prof is not None and verbose
        if self.cfg.profile_ops and (verbose or tel.enabled()) \
                and not will_report:
            self.op_attribution(print_table=verbose)
        if will_report:
            self.profile_report()
        # auto_refit: fold this run's telemetry (op_attribution's op/attr
        # rows above included) into a refreshed learned cost model; the
        # model file's content hash re-keys the strategy cache. It runs
        # after the loop, outside any graph capture.
        if self.cfg.auto_refit:
            from flexflow_tpu_torch.search.learned_cost import auto_refit

            info = auto_refit(self.cfg)
            self.refit_info = info
            if info is not None and verbose:
                print(f"[refit] cost model <- {info['rows']} corpus rows "
                      f"({len(info['kinds'])} op kinds) -> {info['path']} "
                      f"[{info['fingerprint']}]")
        return history

    def _fit_end_report(self, verbose: bool) -> None:
        """Fit-end hooks: the fit/drift event (and the [drift] warning
        when the cost model has drifted), and any FAILED async checkpoint
        write."""
        from flexflow_tpu_torch.runtime.checkpoint import warn_failed_writes

        tel.emit_fit_end(self.drift_stats(), verbose)
        warn_failed_writes(verbose)

    def _fit_epochs(self, epochs, loader, batch_size, callbacks, verbose,
                    sync_every, steps_per_dispatch, res, progress, gm):
        """fit's loop (JAX's `_fit_epochs`). `rec` is telemetry's state
        read once: with it off the loop is the one without telemetry (the
        same dispatches, host syncs and barriers); the goodput laps are a
        few perf_counter reads a dispatch, and the sentinels add device
        scalars to the step's metrics, read only where the loop reads the
        loss."""
        from flexflow_tpu_torch.runtime import faults
        from flexflow_tpu_torch.runtime.resilience import (RetryPolicy,
                                                           progress_dict,
                                                           run_resilient,
                                                           start_state)

        accum = self._accum_steps
        policy = res.policy if res is not None \
            else RetryPolicy.from_config(self.cfg)
        sent = None
        if self.cfg.health_sentinels:
            sent = health.SentinelMonitor(
                halt=bool(self.cfg.halt_on_nonfinite),
                checkpoint_root=res.root if res is not None else None)
        self._sentinels = sent
        base_rng = ff_random.key(self.cfg.seed + 17)
        per_batch_cbs = [cb for cb in callbacks or []
                         if hasattr(cb, "on_batch_end")]
        ahead = max(1, int(self.cfg.dispatch_ahead))
        stats = self.step_stats = {"dispatches": 0, "host_syncs": 0,
                                   "barriers": 0, "fused_steps": 0}
        start_epoch, skip_steps, history = start_state(progress)
        if progress:
            # the epochs before start_epoch drew their shuffles
            loader.advance_epochs(start_epoch)
        rec = tel.enabled()
        faults_on = faults.active()
        if res is not None:
            res.install_guard()
        try:
            for epoch in range(start_epoch, epochs):
                # re-read each epoch: a recompile trigger registered
                # mid-fit drops the loop to one step a dispatch, and a
                # recompile rebuilds the multi-step programs
                k = max(1, int(steps_per_dispatch))
                sync = max(0, int(sync_every))
                if per_batch_cbs or self.recompile_state is not None:
                    k, sync = 1, 1  # per-step host control
                if self.cfg.profiling:
                    k = 1  # a replay's kernels carry no layer
                multi = self._get_multi(k) if k > 1 else None
                pm, pml = PerfMetrics(), PerfMetrics()
                nb = since_sync = ep_sync = ep_disp = 0
                seed_steps = seed_samples = 0
                t0 = time.perf_counter()
                gm.tick()  # the goodput lap cursor starts with the epoch
                # resume mid-epoch: skip the accumulation groups consumed
                # before the snapshot, and re-seed the epoch's sums so its
                # summary covers the whole epoch (the wall-clock figures
                # count only the steps run since the resume)
                resuming = epoch == start_epoch and bool(progress)
                batches = group_microbatches(loader.epoch(
                    skip_batches=skip_steps * accum if resuming else 0),
                    accum)
                if resuming:
                    nb = seed_steps = skip_steps
                    pml.sums["loss"] = float(progress.get("loss_sum", 0.0))
                    pml.train_all = nb
                    pm.sums = {mk: float(v) for mk, v in
                               (progress.get("metric_sums") or {}).items()}
                    pm.train_all = seed_samples = int(
                        progress.get("samples", 0))
                if sent is not None:
                    # the loss window's baseline (re-seeded on resume, so
                    # the loss before the snapshot is no spike)
                    sent._loss_sum_prev = pml.sums.get("loss", 0.0)
                    sent._steps_prev = nb

                def make_progress(_pml=pml, _pm=pm, _epoch=epoch):
                    _pml.materialize()
                    _pm.materialize()
                    return progress_dict(_epoch, nb,
                                         _pml.sums.get("loss", 0.0),
                                         _pm.sums, _pm.train_all, history)

                rows, wrap = (self._host_rows(int(accum > 1))
                              if self.mesh is not None else (None, None))
                gen = prefetch_multi(batches, k, self.device,
                                     retry_policy=policy, rows=rows,
                                     wrap=wrap)
                try:
                    while True:
                        # the wait for the loader: the data stall the
                        # prefetch thread is there to hide
                        if rec:
                            t_w = tel.now_us()
                            item = next(gen, None)
                            tel.record("fit/prefetch_wait", t_w, cat="fit")
                        else:
                            item = next(gen, None)
                        gm.lap("prefetch_wait")
                        if item is None:
                            break
                        kind, dx, dy = item
                        steps = k if kind == "k" else 1
                        if faults_on:
                            # one admission check per global step the
                            # dispatch covers, before anything runs
                            for s in range(self._iteration + 1,
                                           self._iteration + 1 + steps):
                                run_resilient("fit/dispatch", lambda: None,
                                              policy, index=s)
                                if faults.poison("health/nonfinite", index=s):
                                    self._poison_first_param()
                        if rec:
                            t_d = tel.now_us()
                        if kind == "k":
                            (self.params, self.opt_state, self.state, loss,
                             mvals) = multi(self.params, self.opt_state,
                                            self.state, dx, dy, base_rng,
                                            self._iteration)
                            stats["fused_steps"] += k
                        else:
                            rng = ff_random.fold_in(base_rng, self._iteration)
                            (self.params, self.opt_state, self.state, loss,
                             mvals) = self.train_step(
                                self.params, self.opt_state, self.state, dx,
                                dy, rng)
                        gm.lap("dispatch")
                        self._iteration += steps
                        nb += steps
                        since_sync += steps
                        ep_disp += 1
                        stats["dispatches"] += 1
                        if rec:
                            tel.record("fit/dispatch", t_d, cat="fit",
                                       kind=kind, steps=steps,
                                       iteration=self._iteration)
                        if sent is not None:
                            sent.push(steps, mvals)  # strips health/* keys
                        pml.update_deferred(steps, {"loss": loss})
                        pm.update_deferred(batch_size * accum * steps, mvals)
                        gm.lap("loop")
                        if sync and since_sync >= sync:
                            if rec:
                                t_s = tel.now_us()
                            pml.materialize()
                            pm.materialize()
                            if sent is not None:
                                # the sentinel window rides this sync
                                sent.check(self._iteration,
                                           loss_sum=pml.sums.get("loss", 0.0),
                                           steps_total=nb)
                            if rec:
                                tel.record("fit/host_sync", t_s, cat="fit",
                                           iteration=self._iteration)
                            stats["host_syncs"] += 1
                            ep_sync += 1
                            since_sync = 0
                            gm.lap("host_sync")
                        elif ep_disp % ahead == 0:
                            # bounded dispatch-ahead: wait for the device,
                            # read nothing
                            if rec:
                                t_b = tel.now_us()
                            if self.device.type == "cuda":
                                torch.cuda.current_stream(
                                    self.device).synchronize()
                            if rec:
                                tel.record("fit/barrier_sync", t_b,
                                           cat="fit",
                                           iteration=self._iteration)
                            stats["barriers"] += 1
                            gm.lap("barrier")
                        if res is not None:
                            res.maybe_checkpoint(make_progress)
                            gm.lap("checkpoint")
                        for cb in per_batch_cbs:
                            cb.on_batch_end(self._iteration,
                                            {"loss": float(loss)})
                        if kind == "1":
                            self._maybe_recompile()
                finally:
                    gen.close()
                # epoch end: the one read the loop cannot avoid (not
                # counted as a mid-epoch host sync)
                if rec:
                    t_s = tel.now_us()
                pml.materialize()
                if sent is not None:
                    sent.check(self._iteration,
                               loss_sum=pml.sums.get("loss", 0.0),
                               steps_total=nb)
                if rec:
                    tel.record("fit/host_sync", t_s, cat="fit",
                               scope="epoch_end")
                gm.lap("host_sync")
                dt = time.perf_counter() - t0
                self._drift_windows.append((nb - seed_steps, dt))
                if rec:
                    tel.record("fit/epoch", tel.now_us() - dt * 1e6,
                               cat="fit", epoch=epoch, steps=nb)
                grec = gm.epoch_end(dt, epoch)
                # the memory watermark, outside the epoch's wall
                self._watermarks.sample(f"epoch{epoch}",
                                        self._local_trees(), self.device)
                summ = pm.summary()
                summ["loss"] = pml.sums.get("loss", 0.0) / max(1, nb)
                summ["epoch_time_s"] = dt
                summ["samples_per_sec"] = ((pm.train_all - seed_samples) / dt
                                           if dt > 0 else 0.0)
                summ["dispatches"] = float(ep_disp)
                summ["host_syncs"] = float(ep_sync)
                summ["goodput"] = grec["goodput"]
                history.append(summ)
                if verbose:
                    ms = " ".join(f"{mk}={v:.4f}" for mk, v in summ.items()
                                  if mk not in ("samples", "dispatches",
                                                "host_syncs"))
                    print(f"[epoch {epoch}] {ms}")
                for cb in callbacks or []:
                    if hasattr(cb, "on_epoch_end"):
                        cb.on_epoch_end(epoch, summ)
                if res is not None:
                    res.epoch_end(epoch, history)
            if res is not None:
                res.final_save(epochs, history)
        finally:
            if res is not None:
                res.guard.uninstall()
        return history

    @torch.no_grad()
    def _poison_first_param(self) -> None:
        """health/nonfinite: NaN into the first param leaf (JAX's tree
        order: layer names, then weight names, sorted), in place."""
        layer = sorted(self.params)[0]
        w = sorted(self.params[layer])[0]
        self.params[layer][w].mul_(float("nan"))

    def evaluate(self, x, y, batch_size: Optional[int] = None):
        """Loss and metrics over (x, y) in order, full batches only; the
        host waits for the device every `dispatch_ahead` batches."""
        xs = x if isinstance(x, (list, tuple)) else [x]
        batch_size = self._coerce_batch(batch_size)
        loader = SingleDataLoader(xs, y, batch_size, shuffle=False)
        pm, pml = PerfMetrics(), PerfMetrics()
        ahead = max(1, int(self.cfg.dispatch_ahead))
        nb = 0
        rows, wrap = (self._host_rows(0) if self.mesh is not None
                      else (None, None))
        gen = prefetch_to_device(loader.epoch(), self.device, rows=rows,
                                 wrap=wrap)
        try:
            for dx, dy in gen:
                loss, mvals = self.eval_step(self.params, self.state, dx, dy)
                pm.update_deferred(batch_size, mvals)
                pml.update_deferred(1, {"loss": loss})
                nb += 1
                if nb % ahead == 0 and self.device.type == "cuda":
                    # bounded dispatch-ahead, as in fit
                    torch.cuda.current_stream(self.device).synchronize()
        finally:
            gen.close()
        pml.materialize()
        out = pm.summary()
        out["loss"] = pml.sums.get("loss", 0.0) / max(1, nb)
        return out

    # ---------------------------------------------------------- checkpoints
    def save_checkpoint(self, path: str, block: Optional[bool] = None) -> str:
        """The full training state under `path` (runtime/checkpoint.py).
        With cfg.async_checkpoint (the default) the host snapshot is taken
        here and the write runs on a background thread; block=True writes
        before returning."""
        from flexflow_tpu_torch.runtime.checkpoint import save_checkpoint

        if block is None:
            block = not self.cfg.async_checkpoint
        return save_checkpoint(self, path, block=block)

    def wait_checkpoints(self) -> None:
        """Join in-flight async checkpoint writes, re-raising their
        errors."""
        from flexflow_tpu_torch.runtime.checkpoint import wait_pending

        wait_pending()

    def load_checkpoint(self, path: str) -> None:
        from flexflow_tpu_torch.runtime.checkpoint import restore_checkpoint

        restore_checkpoint(self, path)

    def forward(self, *inputs):
        if self.params is None:
            self.init()
        outs = [_full(o) for o in self.infer(self.params, self.state, inputs)]
        return outs[0] if len(outs) == 1 else outs

    # -------------------------------------------------------------- weights
    def parallel_view(self, layer_name: str, out_idx: int = 0):
        """The ParallelTensor view of a layer output under the compiled
        strategy: per-dim degrees, the shard shape, the replica axes (JAX
        `compile.py:1599`)."""
        from flexflow_tpu_torch.parallel.ptensor import ParallelTensor

        layer = self.model.get_layer_by_name(layer_name)
        sh = self.strategy.op_shardings.get(layer_name)
        dims = sh.outputs[out_idx] if sh and out_idx < len(sh.outputs) else []
        return ParallelTensor.build(layer.outputs[out_idx].spec, list(dims),
                                    self.machine)

    def weight_view(self, layer_name: str, wname: str = "kernel"):
        """The ParallelTensor view of a weight under the compiled strategy;
        a fork-join branch's "b{i}.{sub}.{w}" on stacked storage is the
        stacked weight's slice, without the stacked dim and its sharding
        (JAX `compile.py:1624`)."""
        from flexflow_tpu_torch.core.tensor import TensorSpec
        from flexflow_tpu_torch.parallel.ptensor import ParallelTensor

        layer = self.model.get_layer_by_name(layer_name)
        sh = self.strategy.op_shardings.get(layer_name)
        alias = self._stacked_alias(layer, wname)
        if alias is not None:
            spec = layer.weight_specs[alias[0]]
            dims = list(sh.weights.get(alias[0], []) if sh else [])
            return ParallelTensor.build(
                TensorSpec(spec.shape[1:], spec.dtype), dims[1:],
                self.machine)
        dims = sh.weights.get(wname, []) if sh else []
        return ParallelTensor.build(layer.weight_specs[wname], list(dims),
                                    self.machine)

    @staticmethod
    def _stacked_alias(layer, wname: str):
        """A fork-join branch's "b{i}.{sub}.{w}" resolved against stacked
        storage: (the "stk.{sub}.{w}" key, i), or None (JAX's rule)."""
        if wname in layer.weight_specs or not wname.startswith("b"):
            return None
        head, _, rest = wname.partition(".")
        if not rest or not head[1:].isdigit():
            return None
        stk = f"stk.{rest}"
        return (stk, int(head[1:])) if stk in layer.weight_specs else None

    def get_weight(self, layer_name: str, wname: str = "kernel") -> np.ndarray:
        alias = self._stacked_alias(self.model.get_layer_by_name(layer_name),
                                    wname)
        if alias is not None:
            stk, b = alias
            return _full(self.params[layer_name][stk].detach())[b].cpu() \
                .numpy().copy()
        # over a mesh the full weight, gathered (every rank calls it)
        return _full(self.params[layer_name][wname].detach()).cpu().numpy() \
            .copy()

    def set_weight(self, layer_name: str, wname: str, value):
        """Replace one weight by `value` (an array, or a tensor on any
        device), as a new device tensor: the fused optimizer's pointer
        table is rebuilt at the next step. A fork-join branch's
        "b{i}.{sub}.{w}" on stacked storage writes slice i of the stacked
        weight in place; over a mesh each rank writes its own block of it
        (the rank holding row i of the stacked dim, its block of the
        other dims), and nothing is gathered (JAX `compile.py:1656-1667`)."""
        layer = self.model.get_layer_by_name(layer_name)
        alias = self._stacked_alias(layer, wname)
        if alias is not None:
            stk, b = alias
            target = self.params[layer_name][stk]
            value = to_device(_host_or_tensor(value), self.device)
            if tuple(value.shape) != tuple(target.shape[1:]):
                raise ValueError(f"{layer_name}.{wname}: shape "
                                 f"{tuple(value.shape)} vs expected "
                                 f"{tuple(target.shape[1:])}")
            with torch.no_grad():
                if self.mesh is None:
                    target[b].copy_(value)
                else:
                    self._set_stacked_block(target, b, value)
            return
        self.params[layer_name][wname] = self._place(
            _host_or_tensor(value), layer.weight_specs[wname],
            f"{layer_name}.{wname}", (layer_name, wname))

    def _set_stacked_block(self, target, b: int, value) -> None:
        """Row b of a stacked DTensor `target` := `value`, on the rank(s)
        whose block of the stacked dim holds row b: the block of `value`
        that the other dims' placements give this rank."""
        from torch.distributed.tensor import Replicate, Shard

        from flexflow_tpu_torch.runtime.distributed import local_rows

        coord = self.mesh.get_coordinate()
        lo, n = 0, target.shape[0]
        for j, p in enumerate(target.placements):
            if isinstance(p, Shard) and p.dim == 0:
                n //= self.mesh.size(j)
                lo += coord[j] * n
        if not lo <= b < lo + n:
            return
        rest = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 0
                else Replicate() for p in target.placements]
        local = target.to_local()
        local[b - lo].copy_(local_rows(value, self.mesh, rest))

    # ------------------------------------------------------------ cost model
    def _candidate_for(self, layer):
        """The sharding candidate matching the compiled strategy's weight
        layout for this layer (candidates.compiled_candidate)."""
        from flexflow_tpu_torch.search.candidates import compiled_candidate

        batch_sizes = {t.shape[0] for t in self.model.input_tensors
                       if t.ndim > 0}
        return compiled_candidate(layer, self.strategy, self.machine,
                                  batch_sizes)

    def memory_stats(self) -> dict:
        """Per-device memory: what the cost model PREDICTS for this
        compile's strategy and optimizer (params + grads + moments, and the
        search's peak with the live activations) next to what the device
        holds (the params' and moments' bytes, and on a CUDA device
        `torch.cuda.max_memory_allocated` since the last
        `reset_peak_memory_stats`); over a mesh, this rank's blocks."""
        from flexflow_tpu_torch.search import cost_model as cmod
        from flexflow_tpu_torch.search.optimize import strategy_cost

        opt_mem = cmod.opt_mem_spec(self.optimizer, self.cfg, self.machine)
        pred_w = pred_opt = 0
        for layer in self.model.layers:
            if not layer.weight_specs:
                continue
            cand = self._candidate_for(layer)
            pred_w += cand.weight_mem_bytes(layer, self.machine, opt_mem)
            for w, spec in layer.weight_specs.items():
                dims = cand.weight_dims.get(w, [])
                elems = cmod.shard_bytes(spec, dims, self.machine) \
                    // max(1, spec.dtype.itemsize)
                pred_opt += (opt_mem.moments * elems * opt_mem.state_itemsize
                             // cmod.zero_divisor(spec, dims, self.machine,
                                                  opt_mem.zero_axes))

        def tree_bytes(tree):
            # this rank's blocks over a mesh
            return sum(_local(t).numel() * _local(t).element_size()
                       for ws in (tree or {}).values() for t in ws.values())

        moments = 0
        for k, v in (self.opt_state or {}).items():
            if isinstance(v, dict):
                moments += tree_bytes(v)
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else None)
        deg = 1
        for a in _zero_axes_of(self._axes):
            deg *= self._axes[a]
        return {
            "zero_sharding": self._zero,
            "data_axis_degree": deg,
            "predicted_weight_state_bytes": int(pred_w),
            "predicted_opt_state_bytes": int(pred_opt),
            "predicted_peak_bytes": int(strategy_cost(
                self.model, self.machine, self.strategy,
                optimizer=self.optimizer).mem_bytes),
            "actual_param_bytes_per_device": tree_bytes(self.params),
            "actual_opt_state_bytes_per_device": moments,
            "max_memory_allocated_bytes": peak,
        }

    def search_cache_stats(self) -> dict:
        """Search fast-path observability: this compile's strategy-cache
        event, the process-wide cache counters, the memoized-costing hit
        rates and the DP work counters."""
        from flexflow_tpu_torch.search import memo
        from flexflow_tpu_torch.search import strategy_cache as sc
        from flexflow_tpu_torch.search.dp import SEARCH_STATS

        return {
            "strategy_cache": dict(sc.STATS.as_dict(),
                                   this_compile=self.search_cache_info),
            "memo": memo.stats(),
            "dp": dict(SEARCH_STATS),
        }

    def predicted_step_time(self, cost_fn=None) -> Optional[float]:
        """The cost model's per-update time for this compile: the search's
        own best cost when the strategy came out of graph_optimize (or its
        cache), else the additive sum of the compiled candidates' op times
        — analytic, or `cost_fn(layer, cand)`'s (a MeasuredCost's op_time)
        when given. Scaled by accum_steps (one update is N microbatch
        passes)."""
        accum = max(1, int(self._accum_steps))
        pc = getattr(self.strategy, "_predicted_cost", None)
        if pc and cost_fn is None:
            return float(pc) * accum
        total = 0.0
        for layer in self.model.layers:
            cand = self._candidate_for(layer)
            if not cand.passthrough:
                total += (cost_fn(layer, cand) if cost_fn is not None
                          else cand.op_time(layer, self.machine))
        return total * accum if total > 0 else None

    def export_sim_trace(self, path: str, cost_fn=None):
        """Replay the compiled strategy through the event-driven simulator
        (search/simulator.py) with the search's segment size and write its
        timeline to `path` as a Chrome trace; `cost_fn` (a MeasuredCost's
        op_time) prices the ops instead of the analytic model. Wired to
        `simulator_trace`. Returns the SimReport."""
        from flexflow_tpu_torch.search.simulator import simulate_strategy

        choices = {l.name: self._candidate_for(l) for l in self.model.layers}
        report = simulate_strategy(self.model, choices, self.machine,
                                   cost_fn=cost_fn,
                                   segment_bytes=self.cfg.simulator_segment_size)
        report.export_trace(path)
        return report

    # ------------------------------------------------------------- reports
    def drift_stats(self) -> dict:
        """The cost model's drift: predicted against measured step time
        (telemetry.drift_stats over the last fit's per-epoch (steps,
        seconds) windows)."""
        return tel.drift_stats(self.predicted_step_time(),
                               list(self._drift_windows))

    def goodput_report(self) -> dict:
        """The last fit's wall-clock buckets (health.GoodputMeter.report):
        seconds per bucket, goodput, the unattributed residual and the
        accounted fraction. {} before any fit."""
        return self._goodput.report() if self._goodput is not None else {}

    def health_report(self) -> dict:
        """Run health: the sentinels' status (non-finite windows, spikes)
        and the memory watermark against the cost model's prediction
        (health.watermark_drift). On a CUDA device the peak is the caching
        allocator's `allocated_bytes.all.peak`: every live tensor (params,
        gradients, moments, activations, a CUDA graph's pool) at its
        highest since the process started or the caller's last
        `torch.cuda.reset_peak_memory_stats`; it is held against the
        search's predicted peak (`predicted_peak_bytes`, activations
        included). On the CPU the sample is the params' and moments' bytes,
        held against `predicted_weight_state_bytes`, as JAX's fallback.
        `watermarks["predicted"]` names which."""
        sent = self._sentinels.state.status() \
            if self._sentinels is not None else None
        wm = None
        if self._watermarks.samples:
            mem = self.memory_stats()
            which = ("predicted_peak_bytes" if self.device.type == "cuda"
                     else "predicted_weight_state_bytes")
            wm = self._watermarks.report(mem[which])
            wm["predicted"] = which
        return {"sentinels": sent, "watermarks": wm}

    def op_attribution(self, step_time_s: Optional[float] = None,
                       source: str = "auto", top: int = 0,
                       print_table: bool = True) -> dict:
        """Per-op attribution (attribution.py): each compiled op's measured
        time (the --profiling trace when one can be read, else MeasuredCost
        on this compile's device) against the search's per-op predicted
        cost and its roofline. step_time_s defaults to the drift monitor's
        measured per-update time of the LAST fit (attributed times are
        rescaled to sum to it). Emits op/attr and op/drift_topk when
        telemetry is on. Returns the report ({"rows", "top_drift",
        "coverage", "source", ...})."""
        from flexflow_tpu_torch import attribution

        if step_time_s is None:
            step_time_s = self.drift_stats().get("measured_step_time_s")
        pred = getattr(self.strategy, "_predicted_op_costs", None) or {}
        items = []
        for layer in topo_order(self.model.layers):
            cand = self._candidate_for(layer)
            if cand.passthrough:
                continue
            items.append({"layer": layer, "cand": cand,
                          "machine": self.machine,
                          "predicted_s": pred.get(layer.name),
                          "stage": None})
        profile_dir = (self.cfg.profile_dir or "./ff_profile") \
            if self.cfg.profiling else None
        report = attribution.build_report(
            items, step_time_s=step_time_s,
            mult=max(1, int(self._accum_steps)),
            profile_dir=profile_dir, source=source, device=self.device,
            compute_dtype=self.cfg.compute_dtype,
            enable_fusion=self.cfg.enable_fusion)
        if print_table:
            for line in attribution.format_report(report, top=top):
                print(line)
        return report

    def profile_report(self, top: int = 0, print_table: bool = True):
        """Per-op timing table: each layer's analytic time and its time
        measured alone (MeasuredCost, repeats 3, not persisted) under the
        candidate of its compiled sharding, then the memory, drift,
        goodput and health lines, and with `profile_ops` the attribution
        join. Returns the rows."""
        from flexflow_tpu_torch.search.measure import MeasuredCost

        mc = MeasuredCost(self.machine, repeats=3, warmup=1, cache_dir="",
                          device=self.device,
                          compute_dtype=self.cfg.compute_dtype,
                          enable_fusion=self.cfg.enable_fusion)
        rows = []
        for layer in self.model.layers:
            cand = self._candidate_for(layer)
            if cand.passthrough:
                continue
            rows.append({
                "layer": layer.name,
                "op": layer.op_type.value,
                "candidate": cand.name,
                "analytic_us": cand.op_time(layer, self.machine) * 1e6,
                "measured_us": mc.op_time(layer, cand) * 1e6,
            })
        rows.sort(key=lambda x: -x["measured_us"])
        if top:
            rows = rows[:top]
        if print_table:
            from flexflow_tpu_torch.runtime.checkpoint import \
                report_failed_writes

            total = sum(x["measured_us"] for x in rows) or 1.0
            print(f"{'layer':28} {'op':18} {'analytic':>10} "
                  f"{'measured':>10} {'%':>5}")
            for x in rows:
                print(f"{x['layer'][:28]:28} {x['op'][:18]:18} "
                      f"{x['analytic_us']:9.1f}u {x['measured_us']:9.1f}u "
                      f"{100 * x['measured_us'] / total:4.1f}%")
            from flexflow_tpu_torch.search import memo

            stats = self.search_cache_stats()
            cs, dp = stats["strategy_cache"], stats["dp"]
            info = self.search_cache_info or {}
            print(f"[strategy-cache] this_compile="
                  f"{info.get('event', 'off/skipped')} "
                  f"hits={cs['hits']} misses={cs['misses']} "
                  f"stores={cs['stores']} invalidated={cs['invalidated']}")
            print(f"[search] dp_calls={dp.get('calls', 0)} "
                  f"expansions={dp.get('expansions', 0)} "
                  f"prefix_skipped_layers={dp.get('layers_skipped', 0)}; "
                  f"{memo.stats_line()}")
            mem = self.memory_stats()
            mb = 1024 * 1024
            print(f"[memory] predicted/device: weight-state "
                  f"{mem['predicted_weight_state_bytes'] / mb:.2f}MB (opt "
                  f"{mem['predicted_opt_state_bytes'] / mb:.2f}MB), peak "
                  f"{mem['predicted_peak_bytes'] / mb:.2f}MB")
            print(f"[memory] actual/device:    params "
                  f"{mem['actual_param_bytes_per_device'] / mb:.2f}MB, "
                  f"opt state "
                  f"{mem['actual_opt_state_bytes_per_device'] / mb:.2f}MB")
            for line in tel.format_drift(self.drift_stats()):
                print(line)
            if self._goodput is not None and self._goodput.epochs:
                for line in health.format_goodput(self._goodput.report()):
                    print(line)
            hr = self.health_report()
            for line in health.format_health(hr["sentinels"],
                                             hr["watermarks"]):
                print(line)
            if self.cfg.profile_ops:
                self.op_attribution(print_table=True, top=top)
            else:
                print("[drift] per-op attribution: --profile-ops / "
                      "op_attribution()")
            for line in report_failed_writes():
                print(line)
        return rows

    # ------------------------------------------------- recompile-on-condition
    def recompile_on_condition(self, trigger_fn, alter_fn):
        """After every single-step dispatch of fit, `trigger_fn(cm)`; when
        it is true, `alter_fn(cm)` and the forward and the step programs
        are rebuilt. A registered trigger makes fit take one step a
        dispatch with a host sync after each (as in JAX)."""
        self.recompile_state = (trigger_fn, alter_fn)

    def _maybe_recompile(self):
        if self.recompile_state is None:
            return
        trigger, alter = self.recompile_state
        if trigger(self):
            alter(self)
            self.forward_fn = self._build_forward()
            # a captured graph holds the old forward and the old params'
            # addresses, and the fused optimizer's plan their pointer
            # tables: drop both
            self._multi_cache.clear()
            if self.fopt_plan is not None:
                self.fopt_plan = fused_optim.plan_for(self.optimizer)
            if self._goodput is not None:
                # the rebuild is the recompile bucket
                self._goodput.lap("recompile")
