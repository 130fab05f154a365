"""compile_model and CompiledModel: the training entry points
(counterpart: flexflow_tpu/compiler/compile.py).

`compile_model(model, optimizer, loss_type, metrics)` builds the graph's
forward (compiler/lowering.py) and returns a `CompiledModel` with
`init`, `train_step`, `eval_step`, `infer`, `fit`, `evaluate`, `forward`,
`get_weight` and `set_weight`, as the JAX package's. One device, no mesh:
the strategy search, ZeRO, the fused multi-step dispatch, resilience,
health and telemetry are not ported yet.

Gradient accumulation is `compile.py:655-701`'s: with `accum_steps` N > 1
(the config's, or `fit(accum_steps=N)`) the train step takes inputs and
labels with a leading (N, ...) microbatch dim, runs `value_and_grads` on
each microbatch, sums the f32 gradients, multiplies the sum by 1 / N and
applies ONE optimizer update; loss and metrics are the microbatch sums
times 1 / N. `fit` groups N consecutive loader batches per update
(`runtime/dataloader.group_microbatches`).

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

from flexflow_tpu_torch.compiler.lowering import build_forward
from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.device import resolve_device, to_device
from flexflow_tpu_torch.initializers import init_params
from flexflow_tpu_torch.kernels import fused_ce, fused_optim
from flexflow_tpu_torch.losses import LossType, compute_loss
from flexflow_tpu_torch.metrics import MetricsType, PerfMetrics, compute_metrics
from flexflow_tpu_torch.optimizers import SGDOptimizer
from flexflow_tpu_torch.runtime.dataloader import (SingleDataLoader,
                                                   group_microbatches)


def compile_model(model, optimizer, loss_type, metrics: Sequence = (),
                  device=None) -> "CompiledModel":
    """The training program of `model`'s graph, its output the last
    layer's first output (SGD at its default step size when no optimizer
    is given, as in JAX)."""
    return CompiledModel(model, optimizer or SGDOptimizer(),
                         LossType.from_any(loss_type),
                         [MetricsType.from_any(m) for m in metrics],
                         model.layers[-1].outputs[:1], device=device)


class CompiledModel:
    def __init__(self, model, optimizer, loss_type: LossType,
                 metrics: List[MetricsType], outputs, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.config
        self.optimizer = optimizer
        self.loss_type = loss_type
        self.metrics = metrics
        self.forward_fn = build_forward(model.layers, model.input_tensors,
                                        outputs,
                                        compute_dtype=self.cfg.compute_dtype,
                                        enable_fusion=self.cfg.enable_fusion)
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

    def value_and_grads(self, params, state, inputs, label):
        """Forward in training mode, loss, and the gradient of every
        floating param: (loss, logits, new_state, grads tree)."""
        inputs = [to_device(x, self.device) for x in inputs]
        label = to_device(label, self.device)
        order = [(l, w) for l, ws in params.items() for w, t in ws.items()
                 if t.requires_grad]
        outs, new_state = self.forward_fn(params, state, inputs,
                                          training=True)
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

    def train_step(self, params, opt_state, state, inputs, label):
        """One optimizer update: `value_and_grads`, then the update, or
        with accum_steps N > 1 the accumulating step over the (N, ...)
        microbatches of `inputs` and `label`. `params` and `opt_state` are
        updated in place and returned with the new state, the loss and the
        metrics (device scalars)."""
        if self._accum_steps > 1:
            return self._accum_step(params, opt_state, state, inputs, label)
        label = to_device(label, self.device)
        loss, logits, new_state, grads = self.value_and_grads(
            params, state, inputs, label)
        opt_state = self._apply_update(params, opt_state, grads)
        return params, opt_state, new_state, loss, self._metrics(logits, label)

    def _accum_step(self, params, opt_state, state, inputs, label):
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
            loss, logits, state, grads = self.value_and_grads(
                params, state, [x[j] for x in inputs], label[j])
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
            epochs: Optional[int] = None, verbose: bool = True,
            sync_every: Optional[int] = None,
            accum_steps: Optional[int] = None):
        """Train for `epochs` over (x, y), shuffled by the config's seed.
        With accum_steps N > 1 (None = the config's value) every N
        consecutive batches make one update. The loss stays on the device
        and is read every `sync_every` updates (0 = at epoch end only).
        Returns one summary dict per epoch; `step_stats` counts the fit's
        dispatches (optimizer updates) and its mid-epoch host syncs."""
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
        loader = SingleDataLoader(xs, y, batch_size, shuffle=True,
                                  seed=self.cfg.seed)
        stats = self.step_stats = {"dispatches": 0, "host_syncs": 0}
        history = []
        for epoch in range(epochs):
            pm, pml = PerfMetrics(), PerfMetrics()
            nb = since_sync = ep_sync = 0
            t0 = time.perf_counter()
            for dx, dy in group_microbatches(loader.epoch(), accum):
                (self.params, self.opt_state, self.state, loss,
                 mvals) = self.train_step(self.params, self.opt_state,
                                          self.state, dx, dy)
                nb += 1
                since_sync += 1
                stats["dispatches"] += 1
                pml.update_deferred(1, {"loss": loss})
                pm.update_deferred(batch_size * accum, mvals)
                if sync and since_sync >= sync:
                    pml.materialize()
                    pm.materialize()
                    stats["host_syncs"] += 1
                    ep_sync += 1
                    since_sync = 0
            # epoch end: the one read the loop cannot avoid (not counted
            # as a mid-epoch host sync)
            pml.materialize()
            summ = pm.summary()
            dt = time.perf_counter() - t0
            summ["loss"] = pml.sums.get("loss", 0.0) / max(1, nb)
            summ["epoch_time_s"] = dt
            summ["samples_per_sec"] = pm.train_all / dt if dt > 0 else 0.0
            summ["dispatches"] = float(nb)
            summ["host_syncs"] = float(ep_sync)
            history.append(summ)
            if verbose:
                ms = " ".join(f"{k}={v:.4f}" for k, v in summ.items()
                              if k not in ("samples", "dispatches",
                                           "host_syncs"))
                print(f"[epoch {epoch}] {ms}")
        return history

    def evaluate(self, x, y, batch_size: Optional[int] = None):
        """Loss and metrics over (x, y) in order, full batches only."""
        xs = x if isinstance(x, (list, tuple)) else [x]
        batch_size = self._coerce_batch(batch_size)
        loader = SingleDataLoader(xs, y, batch_size, shuffle=False)
        pm, pml = PerfMetrics(), PerfMetrics()
        nb = 0
        for dx, dy in loader.epoch():
            loss, mvals = self.eval_step(self.params, self.state, dx, dy)
            pm.update_deferred(batch_size, mvals)
            pml.update_deferred(1, {"loss": loss})
            nb += 1
        pml.materialize()
        out = pm.summary()
        out["loss"] = pml.sums.get("loss", 0.0) / max(1, nb)
        return out

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
