"""compile_model and CompiledModel: the training entry points
(counterpart: flexflow_tpu/compiler/compile.py).

`compile_model(model, optimizer, loss_type, metrics)` builds the graph's
forward (compiler/lowering.py) and returns a `CompiledModel` with
`init`, `train_step`, `eval_step`, `infer`, `fit`, `evaluate`, `forward`,
`save_checkpoint`, `load_checkpoint`, `get_weight` and `set_weight`, as
the JAX package's. It runs on one device: ZeRO, pipelines, the fused
multi-step dispatch, the retry policy, health and telemetry are not
ported yet.

The strategy is chosen as in JAX (`_pick_strategy`): a strategy file
(`import_strategy_file`), else the Unity search (search/) of the search
machine when `search_budget > 0` and that machine has more than one device
(`search_num_nodes` / `search_num_workers` describe one larger than the
real machine), else the data-parallel strategy; it is saved to
`export_strategy_file` when that is set. The machine is
`machine_model_file`'s or the one device the compile runs on
(`resolve_machine`); a machine file of more than one device raises, as
the port executes on one. On one
device the shardings are carried and none is applied, as a one-device
mesh applies none in JAX; the strategy's `remat` map ({layer: "full" |
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

`fit` feeds the step through `runtime/dataloader.prefetch_to_device`
(so does `evaluate`), and takes durable periodic checkpoints, a SIGTERM
drain and `resume` through runtime/resilience.py (the JAX fit's,
non-pipeline, without telemetry).

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

import time
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from flexflow_tpu_torch import random as ff_random
from flexflow_tpu_torch.compiler.lowering import build_forward
from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.device import resolve_device, to_device
from flexflow_tpu_torch.initializers import init_params
from flexflow_tpu_torch.kernels import fused_ce, fused_optim
from flexflow_tpu_torch.losses import LossType, compute_loss
from flexflow_tpu_torch.metrics import MetricsType, PerfMetrics, compute_metrics
from flexflow_tpu_torch.optimizers import SGDOptimizer
from flexflow_tpu_torch.parallel.default_strategy import data_parallel_strategy
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.parallel.sharding import Strategy
from flexflow_tpu_torch.runtime.dataloader import (SingleDataLoader,
                                                   group_microbatches,
                                                   prefetch_to_device)


def resolve_machine(cfg, device=None) -> MachineSpec:
    """The machine a compile runs on: `machine_model_file`'s, else the one
    device it executes on (`MachineSpec.detect`, parallel/machine.py). The
    port executes on one device: a machine file of more than one raises."""
    if not cfg.machine_model_file:
        return MachineSpec.detect(device=device)
    machine = MachineSpec.from_file(cfg.machine_model_file)
    if machine.num_devices > 1:
        raise NotImplementedError(
            f"machine {dict(machine.mesh_axes)} has {machine.num_devices} "
            "devices: the port executes on one (multi-GPU execution is "
            "ROADMAP Queue 1 item 7); search a larger machine with "
            "search_num_nodes / search_num_workers and export_strategy_file")
    return machine


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
    """A strategy file, else a search of the search machine, else data
    parallel (JAX's order). No fallback: a search that fails raises."""
    cfg = model.config
    if cfg.pipeline_stages > 1:
        raise NotImplementedError(
            "pipeline_stages > 1: pipelined compiles are not ported yet "
            "(ROADMAP Queue 1 item 9: the pipeline and its cut search)")
    if cfg.import_strategy_file:
        strategy = Strategy.load(cfg.import_strategy_file)
    else:
        sm = _search_machine(cfg, machine)
        if sm is not machine and sm.mesh_axes != machine.mesh_axes \
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
            strategy = graph_optimize(model, sm, optimizer=optimizer,
                                      measure_device=device)
        else:
            strategy = data_parallel_strategy(model, machine)
    if strategy.pipeline:
        raise NotImplementedError(
            "pipeline strategies are not ported yet (ROADMAP Queue 1 item 9)")
    return strategy


def compile_model(model, optimizer, loss_type, metrics: Sequence = (),
                  device=None) -> "CompiledModel":
    """The training program of `model`'s graph, its output the last
    layer's first output (SGD at its default step size when no optimizer
    is given, as in JAX)."""
    device = resolve_device(device)
    optimizer = optimizer or SGDOptimizer()
    machine = resolve_machine(model.config, device)
    strategy = _pick_strategy(model, machine, optimizer, device)
    if model.config.export_strategy_file:
        strategy.save(model.config.export_strategy_file)
    return CompiledModel(model, optimizer, LossType.from_any(loss_type),
                         [MetricsType.from_any(m) for m in metrics],
                         model.layers[-1].outputs[:1], device=device,
                         strategy=strategy, machine=machine)


class CompiledModel:
    def __init__(self, model, optimizer, loss_type: LossType,
                 metrics: List[MetricsType], outputs, device=None,
                 strategy: Optional[Strategy] = None,
                 machine: Optional[MachineSpec] = None):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.config
        self.optimizer = optimizer
        self.loss_type = loss_type
        self.metrics = metrics
        # the machine the cost model prices this compile on (one device)
        self.machine = machine or resolve_machine(self.cfg, self.device)
        self.strategy = strategy or data_parallel_strategy(model, self.machine)
        # this compile's strategy-cache event (None when nothing searched)
        self.search_cache_info = getattr(self.strategy, "_cache_info", None)
        # --remat (deprecated alias): uniform "full" per-layer policy
        if self.cfg.remat and not self.strategy.remat:
            self.strategy.remat = {l.name: "full" for l in model.layers}
        self.forward_fn = build_forward(model.layers, model.input_tensors,
                                        outputs,
                                        compute_dtype=self.cfg.compute_dtype,
                                        enable_fusion=self.cfg.enable_fusion,
                                        remat=self.strategy.remat)
        # optimizer updates taken (the fit rng and checkpoints count them)
        self._iteration = 0
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
        # dispatches (optimizer updates) / host_syncs of the last fit
        self.step_stats: Dict[str, int] = {}
        self.params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.state: Dict[str, Any] = {}
        self.opt_state: Optional[Dict[str, Any]] = None

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
                w: self._place(params[layer.name][w], spec, f"{layer.name}.{w}")
                for w, spec in sorted(layer.weight_specs.items())}
        self.params = placed
        self.state = {}
        self.opt_state = self.optimizer.init_state(placed)
        return self.params

    def _place(self, value, spec, what: str) -> torch.Tensor:
        x = to_device(value, self.device)
        if tuple(x.shape) != tuple(spec.shape):
            raise ValueError(f"{what}: shape {tuple(x.shape)} vs expected "
                             f"{tuple(spec.shape)}")
        x = x.to(spec.dtype.torch_dtype).clone(memory_format=torch.contiguous_format)
        return x.requires_grad_(x.is_floating_point())

    # ---------------------------------------------------------------- steps
    def _loss(self, logits, label):
        if fused_ce.use_fused_ce(self.loss_type, logits, self.fused_loss_mode,
                                 self.cfg.enable_fusion):
            return fused_ce.fused_cross_entropy(logits, label)
        return compute_loss(self.loss_type, logits.float(), label)

    def _apply_update(self, params, opt_state, grads):
        if self.fopt_plan is not None:
            return fused_optim.fused_update(self.fopt_plan, grads, opt_state,
                                            params)
        return self.optimizer.update(grads, opt_state, params)

    def value_and_grads(self, params, state, inputs, label, rng=None):
        """Forward in training mode (its dropout drawn from `rng`), loss,
        and the gradient of every floating param: (loss, logits,
        new_state, grads tree)."""
        inputs = [to_device(x, self.device) for x in inputs]
        label = to_device(label, self.device)
        order = [(l, w) for l, ws in params.items() for w, t in ws.items()
                 if t.requires_grad]
        outs, new_state = self.forward_fn(params, state, inputs,
                                          training=True, rng=rng)
        logits = outs[0]
        loss = self._loss(logits, label)
        flat = torch.autograd.grad(loss, [params[l][w] for l, w in order])
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (l, w), g in zip(order, flat):
            grads.setdefault(l, {})[w] = g
        return loss.detach(), logits.detach(), new_state, grads

    def _metrics(self, logits, label):
        # no f32 copy of the logits when there is no metric to compute
        if not self.metrics:
            return {}
        with torch.no_grad():
            return compute_metrics(self.metrics, logits.float(), label)

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
        label = to_device(label, self.device)
        loss, logits, new_state, grads = self.value_and_grads(
            params, state, inputs, label, rng)
        opt_state = self._apply_update(params, opt_state, grads)
        return params, opt_state, new_state, loss, self._metrics(logits, label)

    def _accum_step(self, params, opt_state, state, inputs, label, rng=None):
        n = self._accum_steps
        inputs = [to_device(x, self.device) for x in inputs]
        label = to_device(label, self.device)
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
        opt_state = self._apply_update(params, opt_state, gsum)
        return (params, opt_state, state, lsum * inv,
                {k: v * inv for k, v in msum.items()})

    @torch.no_grad()
    def eval_step(self, params, state, inputs, label):
        inputs = [to_device(x, self.device) for x in inputs]
        label = to_device(label, self.device)
        outs, _ = self.forward_fn(params, state, inputs)
        logits = outs[0].float()
        return (compute_loss(self.loss_type, logits, label),
                compute_metrics(self.metrics, logits, label))

    @torch.no_grad()
    def infer(self, params, state, inputs):
        outs, _ = self.forward_fn(
            params, state, [to_device(x, self.device) for x in inputs])
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
            accum_steps: Optional[int] = None,
            resume: Optional[str] = None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every_steps: Optional[int] = None,
            checkpoint_every_secs: Optional[float] = None):
        """Train for `epochs` over (x, y), shuffled by the config's seed,
        the batches copied ahead by `prefetch_to_device`. With accum_steps
        N > 1 (None = the config's value) every N consecutive batches make
        one update. The loss stays on the device and is read every
        `sync_every` updates (0 = at epoch end only); a callback with
        `on_batch_end(iteration, logs)` reads it after every update.
        `checkpoint_dir`, `checkpoint_every_steps`/`_secs` and `resume`
        (None = the config's) take durable snapshots, drain on SIGTERM or
        SIGINT (a final snapshot, then `Preempted`) and resume the same
        trajectory (runtime/resilience.py). Returns one summary dict per
        epoch; `step_stats` counts the fit's dispatches (optimizer updates)
        and its mid-epoch host syncs."""
        from flexflow_tpu_torch.runtime.checkpoint import warn_failed_writes
        from flexflow_tpu_torch.runtime.resilience import (FitResilience,
                                                           progress_dict,
                                                           start_state)

        xs = x if isinstance(x, (list, tuple)) else [x]
        epochs = epochs or self.cfg.epochs
        sync = max(0, int(self.cfg.sync_every if sync_every is None
                          else sync_every))
        self._accum_steps = max(1, int(self.cfg.accum_steps if accum_steps
                                       is None else accum_steps))
        accum = self._accum_steps
        if self.params is None:
            self.init()
        batch_size = self._coerce_batch(batch_size or self.cfg.batch_size)
        res = FitResilience.build(self, resume, checkpoint_dir,
                                  checkpoint_every_steps,
                                  checkpoint_every_secs)
        progress = None
        if res is not None:
            res.set_effective(batch_size, accum)
            progress = res.resume_now(verbose)
        loader = SingleDataLoader(xs, y, batch_size, shuffle=True,
                                  seed=self.cfg.seed)
        base_rng = ff_random.key(self.cfg.seed + 17)
        per_batch_cbs = [cb for cb in callbacks or []
                         if hasattr(cb, "on_batch_end")]
        if per_batch_cbs:
            sync = 1  # the callbacks read every update's loss
        stats = self.step_stats = {"dispatches": 0, "host_syncs": 0}
        start_epoch, skip_steps, history = start_state(progress)
        if progress:
            # the epochs before start_epoch drew their shuffles
            loader.advance_epochs(start_epoch)
        if res is not None:
            res.install_guard()
        try:
            for epoch in range(start_epoch, epochs):
                pm, pml = PerfMetrics(), PerfMetrics()
                nb = since_sync = ep_sync = ep_disp = seed_samples = 0
                t0 = time.perf_counter()
                # resume mid-epoch: skip the accumulation groups consumed
                # before the snapshot, and re-seed the epoch's sums so its
                # summary covers the whole epoch
                resuming = epoch == start_epoch and bool(progress)
                batches = group_microbatches(loader.epoch(
                    skip_batches=skip_steps * accum if resuming else 0),
                    accum)
                if resuming:
                    nb = skip_steps
                    pml.sums["loss"] = float(progress.get("loss_sum", 0.0))
                    pml.train_all = nb
                    pm.sums = {k: float(v) for k, v in
                               (progress.get("metric_sums") or {}).items()}
                    pm.train_all = seed_samples = int(
                        progress.get("samples", 0))

                def make_progress(_pml=pml, _pm=pm, _epoch=epoch):
                    _pml.materialize()
                    _pm.materialize()
                    return progress_dict(_epoch, nb,
                                         _pml.sums.get("loss", 0.0),
                                         _pm.sums, _pm.train_all, history)

                gen = prefetch_to_device(batches, self.device)
                try:
                    for dx, dy in gen:
                        rng = ff_random.fold_in(base_rng, self._iteration)
                        (self.params, self.opt_state, self.state, loss,
                         mvals) = self.train_step(self.params,
                                                  self.opt_state, self.state,
                                                  dx, dy, rng)
                        self._iteration += 1
                        nb += 1
                        since_sync += 1
                        ep_disp += 1
                        stats["dispatches"] += 1
                        pml.update_deferred(1, {"loss": loss})
                        pm.update_deferred(batch_size * accum, mvals)
                        if sync and since_sync >= sync:
                            pml.materialize()
                            pm.materialize()
                            stats["host_syncs"] += 1
                            ep_sync += 1
                            since_sync = 0
                        if res is not None:
                            res.maybe_checkpoint(make_progress)
                        for cb in per_batch_cbs:
                            cb.on_batch_end(self._iteration,
                                            {"loss": float(loss)})
                finally:
                    gen.close()
                # epoch end: the one read the loop cannot avoid (not
                # counted as a mid-epoch host sync)
                pml.materialize()
                summ = pm.summary()
                dt = time.perf_counter() - t0
                summ["loss"] = pml.sums.get("loss", 0.0) / max(1, nb)
                summ["epoch_time_s"] = dt
                summ["samples_per_sec"] = ((pm.train_all - seed_samples) / dt
                                           if dt > 0 else 0.0)
                summ["dispatches"] = float(ep_disp)
                summ["host_syncs"] = float(ep_sync)
                history.append(summ)
                if verbose:
                    ms = " ".join(f"{k}={v:.4f}" for k, v in summ.items()
                                  if k not in ("samples", "dispatches",
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
        warn_failed_writes(verbose)
        return history

    def evaluate(self, x, y, batch_size: Optional[int] = None):
        """Loss and metrics over (x, y) in order, full batches only."""
        xs = x if isinstance(x, (list, tuple)) else [x]
        batch_size = self._coerce_batch(batch_size)
        loader = SingleDataLoader(xs, y, batch_size, shuffle=False)
        pm, pml = PerfMetrics(), PerfMetrics()
        nb = 0
        gen = prefetch_to_device(loader.epoch(), self.device)
        try:
            for dx, dy in gen:
                loss, mvals = self.eval_step(self.params, self.state, dx, dy)
                pm.update_deferred(batch_size, mvals)
                pml.update_deferred(1, {"loss": loss})
                nb += 1
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
        outs = self.infer(self.params, self.state, inputs)
        return outs[0] if len(outs) == 1 else outs

    # -------------------------------------------------------------- weights
    def get_weight(self, layer_name: str, wname: str = "kernel") -> np.ndarray:
        return self.params[layer_name][wname].detach().cpu().numpy().copy()

    def set_weight(self, layer_name: str, wname: str, value):
        """Replace one weight (a new device tensor: the fused optimizer's
        pointer table is rebuilt at the next step)."""
        layer = self.model.get_layer_by_name(layer_name)
        self.params[layer_name][wname] = self._place(
            np.asarray(value), layer.weight_specs[wname],
            f"{layer_name}.{wname}")

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
        `reset_peak_memory_stats`)."""
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
            return sum(t.numel() * t.element_size()
                       for ws in (tree or {}).values() for t in ws.values())

        moments = 0
        for k, v in (self.opt_state or {}).items():
            if isinstance(v, dict):
                moments += tree_bytes(v)
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else None)
        return {
            "zero_sharding": "off",
            "data_axis_degree": 1,
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
