"""Pipeline-parallel execution: sequential stages on disjoint groups of
ranks (counterpart: flexflow_tpu/parallel/pipeline.py).

The JAX package runs one controller over sub-meshes: `PipelinedModel`
dispatches each stage's jitted program onto its device group, and raises
when there is more than one process (`pipeline.py:184-187`). The port has
one process a GPU (runtime/distributed.py), so its pipeline is MPMD over
ranks, the departure from JAX's single controller:

- The world is S x (devices a stage). A 2-D `DeviceMesh` ("pipe", stage
  axes) gives this rank its stage s and its stage sub-mesh
  (parallel/machine.py `build_pipeline_mesh`); stages are contiguous and
  stage-major, as JAX's `stage_device_groups`. A stage of one device runs
  the one-device program.
- Each rank builds and runs ONLY its stage: the stage's sub-graph
  (`compiler/lowering.build_forward` of its layers, its external inputs and
  its one boundary output; the last stage returns every model output) in
  a CompiledModel on the stage machine and sub-mesh, so the strategy's
  DTensor placements, ZeRO and the fused optimizer apply inside a stage as
  they do to a whole model.
- Each rank walks its own stage's ops in `cost_model.pipeline_order`, the
  one definition the cut search prices, the simulator replays and this
  executor runs. The boundary hop is runtime/distributed.py `StageLink`:
  rank (s, i) sends to (s + 1, i) and back, one process group a
  direction, receives posted ahead; each send runs under the
  `pipe/boundary_hop` fault and retry site, stage 0's input copies under
  `dataloader/transfer` (JAX `pipeline.py:507-525`).
- At world 1, `pipeline_stages > 1` raises JAX's "need N devices, have M".

Backward (JAX `pipeline.py:313-478`): recompute-based. A stage stashes
only its INPUT (one a microbatch in flight: M under gpipe, at most S under
1f1b); B re-runs the stage forward with grad on and takes
`torch.autograd.grad` of the parameters and, for s > 0, the input (stage
0's integer inputs get none). The last stage's F only stashes; its B is
the loss's value and gradient from the LIVE state, so batch norm's
running stats chain across microbatches under both schedules; interior
stages recompute from the state they stashed at F.

Numerics: the sequential accum_steps loop's up to float reassociation.
Microbatch m of update i draws from fold_in(fold_in(key(seed + 17), i), m)
in F and in its recompute, and dropout folds by layer guid, so a pipelined
run draws the sequential run's masks. Weights equal the sequential twin's
bit for bit: every rank draws the whole model's init order from one
generator (initializers.init_params) and keeps its stage's layers. The
stage update: the sum of M gradients times 1/M, through the port's
optimizer path on the stage's leaves (the fused kernels on CUDA, ZeRO on
the stage's batch axis), one update a group.

Every rank returns the same history: the loss and metrics live on the
last stage, every stage's regularizer penalty and its sentinel squared
gradient norm on its own ranks; they meet at the epoch-end
materialization (one gather of a few host numbers), no host sync a
microbatch. With telemetry on, each op is timed to completion and
recorded as `pipe/F`, `pipe/B` and `pipe/update` (stage, micro, update,
fit); the measured bubble is `telemetry.bubble_from_ops` over every
stage's ops, gathered at the update's end on CLOCK_MONOTONIC, which the
ranks of one host share and the ranks of several hosts do not (there the
measured bubble is not comparable). The goodput meter carves it out of
the dispatch bucket (health.py).
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from flexflow_tpu_torch import health
from flexflow_tpu_torch import random as ff_random
from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.core.graph import topo_order
from flexflow_tpu_torch.parallel.machine import (MachineSpec,
                                                 build_pipeline_mesh,
                                                 stage_device_groups)
from flexflow_tpu_torch.parallel.sharding import Strategy
from flexflow_tpu_torch.runtime import faults as _faults
from flexflow_tpu_torch.runtime.dataloader import (SingleDataLoader,
                                                   group_microbatches)
from flexflow_tpu_torch.runtime.resilience import (RetryPolicy, progress_dict,
                                                   run_resilient, start_state)
from flexflow_tpu_torch.search import cost_model as cm

# process-wide fit sequence: pipe events carry fit=<id>, so the bubble
# grouping never merges two fits whose update counters both restarted at 0
_FIT_SEQ = itertools.count()


def partition_layers(model, cuts: Sequence[int]):
    """The model's topo order split at `cuts` (cut after topo index c) into
    stage layer lists, and the boundary tensor each cut moves. A cut must
    be a single-tensor cut point."""
    from flexflow_tpu_torch.search.candidates import cut_boundary_tensor
    from flexflow_tpu_torch.search.unity import sequence_cut_indices

    order = topo_order(model.layers)
    cuts = sorted(cuts)  # stages and boundaries index the same order
    bounds = [-1] + cuts + [len(order) - 1]
    stages = [order[bounds[si] + 1:bounds[si + 1] + 1]
              for si in range(len(bounds) - 1)]
    ok = set(sequence_cut_indices(order, model.input_tensors))
    boundaries = []
    for c in cuts:
        if c not in ok:
            raise ValueError(
                f"cut after layer {order[c].name} (topo {c}) is not a "
                f"single-tensor cut point; valid cuts: {sorted(ok)}")
        boundaries.append(cut_boundary_tensor(order, c))
    s0 = {id(l) for l in stages[0]}
    for t in model.input_tensors:
        for l in order:
            if any(x.guid == t.guid for x in l.inputs) and id(l) not in s0:
                raise ValueError(f"model input {t.name} consumed outside "
                                 f"stage 0 (layer {l.name})")
    return stages, boundaries


def balanced_cuts(model, stage_machine: MachineSpec, num_stages: int):
    """The cuts when the search is off: the best-balanced candidate of the
    enumerator the search uses."""
    from flexflow_tpu_torch.search.candidates import stage_cut_candidates

    combos = stage_cut_candidates(model, stage_machine, num_stages,
                                  max_candidates=1)
    if not combos:
        raise ValueError(f"model has too few single-tensor cut points for "
                         f"{num_stages} pipeline stages")
    return list(combos[0])


class _StageGraph:
    """One stage's sub-graph in the shape a CompiledModel reads from a
    model: its layers, its external inputs, the model's config and
    initializer overrides, and the regularizers of its own layers."""

    def __init__(self, model, layers, inputs):
        names = {l.name for l in layers}
        self.layers = list(layers)
        self.input_tensors = list(inputs)
        self.config = model.config
        self._initializer_overrides = model._initializer_overrides
        self._weight_regularizers = {
            k: v for k, v in model._weight_regularizers.items()
            if k[0] in names}
        self._by_name = {l.name: l for l in layers}

    def get_layer_by_name(self, name: str):
        return self._by_name[name]


def _now_mono_us() -> float:
    """CLOCK_MONOTONIC in microseconds: one clock for every process of a
    host (telemetry's now_us counts from each process's own start)."""
    return time.clock_gettime(time.CLOCK_MONOTONIC) * 1e6


class PipelinedModel:
    """The pipeline-parallel counterpart of CompiledModel on this rank: the
    same fit / evaluate / forward / init / checkpoint / report surface,
    executed as this rank's stage of S under a GPipe or 1F1B schedule.
    One step is one optimizer update over M = accum_steps microbatches."""

    def __init__(self, model, machine: MachineSpec,
                 stage_machine: MachineSpec, strategy: Strategy,
                 optimizer, loss_type, metrics, outputs, device=None):
        import torch.distributed as dist

        from flexflow_tpu_torch.compiler.compile import CompiledModel
        from flexflow_tpu_torch.device import resolve_device
        from flexflow_tpu_torch.runtime.distributed import StageLink

        if not strategy.pipeline:
            raise ValueError("strategy carries no pipeline block")
        self.model = model
        self.machine = machine          # the full machine
        self.stage_machine = stage_machine
        self.strategy = strategy
        self.optimizer = optimizer
        self.loss_type = loss_type
        self.metrics = list(metrics)
        self.outputs = list(outputs)
        self.cfg = model.config
        self.device = resolve_device(device)
        self.num_stages = S = int(strategy.pipeline["stages"])
        if S < 2:
            raise ValueError("PipelinedModel needs >= 2 stages; the plain "
                             "CompiledModel runs 1")
        self.schedule = strategy.pipeline.get("schedule",
                                              self.cfg.pipeline_schedule)
        # an imported strategy may carry its cuts out of order
        self.cuts = sorted(int(c) for c in strategy.pipeline["cuts"])
        self._retry_policy = RetryPolicy.from_config(self.cfg)
        self._iteration = 0
        self.step_stats: Dict[str, Any] = {}
        self._drift_windows: List[tuple] = []
        self._bubble_sum, self._bubble_n = 0.0, 0
        self._goodput: Optional[health.GoodputMeter] = None
        self._watermarks = health.WatermarkTracker()
        self._sentinel_state: Optional[health.SentinelState] = None
        self._sentinels_on = bool(self.cfg.health_sentinels)
        self._fit_id = 0

        self.stage_layers, self.boundaries = partition_layers(model,
                                                              self.cuts)
        per = stage_machine.num_devices
        self.groups = stage_device_groups(S, per)
        self.stage, self.stage_mesh = build_pipeline_mesh(stage_machine, S,
                                                          self.device)
        self.per_stage = per
        self.rank = dist.get_rank()
        self.index = self.rank % per
        # every stage's process group, for the stage's own reductions (the
        # sentinel norm); made by every rank in the same order
        self._stage_group = None
        if per > 1:
            for g in self.groups:
                pg = dist.new_group(g)
                if self.rank in g:
                    self._stage_group = pg
        self.link = StageLink(S, per, self.device, self._retry_policy)

        s = self.stage
        seg = self.stage_layers[s]
        internal = {o.guid for l in seg for o in l.outputs}
        ext, seen = [], set()
        for l in seg:
            for t in l.inputs:
                if t.guid not in internal and t.guid not in seen:
                    seen.add(t.guid)
                    ext.append(t)
        self.stage_inputs = ext
        self.stage_outputs = ([self.boundaries[s]] if s < S - 1
                              else self.outputs)
        self.last = s == S - 1
        self.stage_cm = CompiledModel(
            _StageGraph(model, seg, ext), optimizer, loss_type, self.metrics,
            self.stage_outputs, device=self.device, strategy=strategy,
            machine=stage_machine, mesh=self.stage_mesh)
        self._has_regs = bool(self.stage_cm._regularizers)
        self._bound_pl = self._boundary_placements()

    # ------------------------------------------------------------ layouts
    def _batch_sizes(self):
        return {t.shape[0] for t in self.model.input_tensors if t.ndim > 0}

    def _boundary_placements(self):
        """{boundary index: placements} of each boundary this rank touches
        on its stage sub-mesh: the batch-sharded layout on both sides (JAX
        gives both sub-meshes the same dp spec, `pipeline.py:256-268`)."""
        if self.stage_mesh is None:
            return {}
        from flexflow_tpu_torch.search.candidates import _dp_dims

        out = {}
        for b in (self.stage - 1, self.stage):
            if 0 <= b < self.num_stages - 1:
                shape = tuple(self.boundaries[b].shape)
                out[b] = self.stage_cm._pl(
                    _dp_dims(shape, self.stage_machine, self._batch_sizes()),
                    shape)
        return out

    def _to_wire(self, t, b: int) -> torch.Tensor:
        """A boundary tensor as this rank's block under the boundary's
        layout (what the hop carries)."""
        if self.stage_mesh is None:
            return t
        return t.redistribute(self.stage_mesh, self._bound_pl[b]).to_local()

    def _from_wire(self, local: torch.Tensor, b: int):
        if self.stage_mesh is None:
            return local
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, self.stage_mesh, self._bound_pl[b],
                                  run_check=False)

    def _in_put(self, arr, tensor):
        """A stage-0 input on the device (over the stage mesh its
        DTensor), under the `dataloader/transfer` site."""
        scm = self.stage_cm

        def put():
            if self.stage_mesh is None:
                from flexflow_tpu_torch.device import to_device

                return to_device(arr, self.device)
            return scm._put(arr, scm.input_placements(tensor))
        return run_resilient("dataloader/transfer", put, self._retry_policy)

    def _label(self, y):
        scm = self.stage_cm
        if self.stage_mesh is None:
            from flexflow_tpu_torch.device import to_device

            return to_device(y, self.device)
        return scm._put(y, scm.label_placements(tuple(y.shape)))

    # ---------------------------------------------------------------- init
    @property
    def params(self):
        return self.stage_cm.params

    @property
    def opt_state(self):
        return self.stage_cm.opt_state

    @property
    def stage_state(self):
        return self.stage_cm.state

    def init(self, seed: Optional[int] = None):
        """The sequential twin's weights: every rank draws the whole
        model's init order from one generator seeded with `seed`
        (initializers.init_params) and keeps its stage's layers; then a
        fresh optimizer state. The draw's seconds are in
        `step_stats["init_draw_s"]`."""
        from flexflow_tpu_torch.initializers import init_params

        seed = self.cfg.seed if seed is None else seed
        layers = [l for l in topo_order(self.model.layers) if l.weight_specs]
        t0 = time.perf_counter()
        full = init_params(layers, self.model._initializer_overrides, seed,
                           self.device)
        self.step_stats["init_draw_s"] = time.perf_counter() - t0
        mine = {l.name for l in self.stage_cm._weight_layers()}
        out = self.load_params({k: v for k, v in full.items() if k in mine})
        del full
        return out

    def load_params(self, params):
        """Adopt this stage's part of a params tree (a tree of the whole
        model is cut to the stage's layers), with a fresh optimizer
        state."""
        mine = {l.name for l in self.stage_cm._weight_layers()}
        self.stage_cm.load_params({k: v for k, v in params.items()
                                   if k in mine})
        self._iteration = 0
        return self.stage_cm.params

    # ----------------------------------------------------- the stage ops
    def _leaves(self):
        p = self.stage_cm.params
        return [(l, w) for l, ws in p.items() for w, t in ws.items()
                if t.requires_grad]

    def _reg_loss(self, params):
        r = None
        for (ln, wn), terms in self.stage_cm._regularizers.items():
            w = params[ln][wn].float()
            for mode, lam in terms:
                t = lam * (w.abs().sum() if mode == "l1" else (w * w).sum())
                r = t if r is None else r + t
        return r

    def _grads(self, roots, grad_outputs, x):
        """The gradients of `roots` (with `grad_outputs`) for the stage's
        params and, when `x` is given, its boundary input: ({l: {w: g}},
        gx or None). A param the outputs do not reach gets zeros."""
        p = self.stage_cm.params
        order = self._leaves()
        leaves = [p[l][w] for l, w in order] + ([x] if x is not None else [])
        flat = torch.autograd.grad(roots, leaves, grad_outputs=grad_outputs,
                                   allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (l, w), g in zip(order, flat):
            grads.setdefault(l, {})[w] = (torch.zeros_like(p[l][w])
                                          if g is None else g)
        return grads, (flat[-1] if x is not None else None)

    def _f(self, x, state, rng):
        """F of an interior or first stage: the boundary output (no grad)
        and the new state."""
        scm = self.stage_cm
        with torch.no_grad():
            outs, new_state = scm.forward_fn(scm.params, state, x,
                                             training=True, rng=rng)
        return outs[0], new_state

    def _b_mid(self, x, state, gy, rng):
        """B of a non-last stage from its stash: (grads, gx, penalty)."""
        scm = self.stage_cm
        xin = None
        if self.stage > 0:
            xin = x[0].detach().requires_grad_(x[0].is_floating_point())
            x = [xin]
        with torch.enable_grad():
            outs, _ = scm.forward_fn(scm.params, state, x, training=True,
                                     rng=rng)
            y = outs[0]
            if self.stage_mesh is not None:
                y = y.redistribute(self.stage_mesh,
                                   self._bound_pl[self.stage])
            roots, gos = [y], [gy]
            rv = self._reg_loss(scm.params) if self._has_regs else None
            if rv is not None:
                roots.append(rv)
                gos.append(torch.ones_like(rv))
            grads, gx = self._grads(roots, gos, xin)
        return grads, gx, (rv.detach() if rv is not None else None)

    def _b_last(self, x, state, label, rng):
        """B of the last stage from the live state: (loss, grads, gx, new
        state, metrics)."""
        from flexflow_tpu_torch.compiler.compile import _full

        scm = self.stage_cm
        xin = x[0].detach().requires_grad_(x[0].is_floating_point())
        with torch.enable_grad():
            outs, new_state = scm.forward_fn(scm.params, state, [xin],
                                             training=True, rng=rng)
            logits = outs[0]
            loss = scm._loss(logits, label)
            rv = self._reg_loss(scm.params) if self._has_regs else None
            if rv is not None:
                loss = loss + rv
            grads, gx = self._grads([loss], None, xin)
        mv = scm._metrics(logits.detach(), label)
        return _full(loss.detach()), grads, gx, new_state, mv

    # ------------------------------------------------------------ the step
    def _pipeline_step(self, micro_xs, micro_y, rng_iter, order, M: int):
        """One optimizer update of this rank's stage: its ops in
        `pipeline_order`, the hops, then the stage update. Returns (loss
        part, metrics, squared grad norm): the loss part is the mean loss
        on the last stage and the mean regularizer penalty elsewhere."""
        scm, link = self.stage_cm, self.link
        s, S = self.stage, self.num_stages
        rngs = [ff_random.fold_in(rng_iter, m) for m in range(M)]
        rec = tel.enabled()
        cuda = self.device.type == "cuda"
        upd, fid = self._iteration, self._fit_id
        ops: List[tuple] = []
        stash_x: Dict[int, Any] = {}
        stash_st: Dict[int, Any] = {}
        acc = None
        part = msum = None
        state = scm.state
        link.begin_update(M)

        def done(name, t0, m0, m):
            if cuda:
                torch.cuda.current_stream(self.device).synchronize()
            ops.append((s, m0, _now_mono_us()))
            tel.record(name, t0, cat="pipeline", stage=s, micro=m,
                       update=upd, fit=fid)

        for ph, m in order:
            if ph == "F":
                if s == 0:
                    x = [self._in_put(a[m], t)
                         for a, t in zip(micro_xs, self.stage_inputs)]
                else:
                    x = [self._from_wire(link.recv_act(m), s - 1)]
                stash_x[m], stash_st[m] = x, state
                if not self.last:
                    if rec:
                        t0, m0 = tel.now_us(), _now_mono_us()
                    y, state = self._f(x, state, rngs[m])
                    if rec:
                        done("pipe/F", t0, m0, m)
                    link.send_act(self._to_wire(y, s), m)
                # the last stage's F only stashes: its B is its forward
                continue
            if rec:
                t0, m0 = tel.now_us(), _now_mono_us()
            if self.last:
                loss, grads, gx, state, mv = self._b_last(
                    stash_x[m], state, self._label(micro_y[m]), rngs[m])
                part = loss if part is None else part + loss
                msum = mv if msum is None else \
                    {k: msum[k] + v for k, v in mv.items()}
            else:
                gy = self._from_wire(link.recv_grad(m), s)
                grads, gx, rv = self._b_mid(stash_x[m], stash_st[m], gy,
                                            rngs[m])
                if rv is not None:
                    part = rv if part is None else part + rv
            if rec:
                done("pipe/B", t0, m0, m)
            del stash_x[m], stash_st[m]
            if s > 0:
                link.send_grad(self._to_wire(gx, s - 1))
            if scm._zero == "zero2":
                grads = scm._sync_grads(grads)
            if acc is None:
                acc = grads
            else:
                for l, ws in grads.items():
                    for w, g in ws.items():
                        acc[l][w].add_(g)
        link.end_update()
        inv = 1.0 / M
        t0 = tel.now_us() if rec else 0.0
        gn_sq = None
        if acc is not None:
            for ws in acc.values():
                for g in ws.values():
                    g.mul_(inv)
            acc = scm._sync_grads(acc)
            if self._sentinels_on:
                gn_sq = self._grad_norm_sq(acc)
            scm.opt_state = scm._apply_update(scm.params, scm.opt_state, acc)
        if rec:
            if cuda:
                torch.cuda.current_stream(self.device).synchronize()
            tel.record("pipe/update", t0, cat="pipeline-update", stage=s,
                       update=upd, fit=fid)
            b = self._gathered_bubble(ops)
            if b is not None:
                self._bubble_sum += b
                self._bubble_n += 1
        scm.state = state
        mvals = {k: v * inv for k, v in msum.items()} if msum else {}
        return (part * inv if part is not None else None), mvals, gn_sq

    def _grad_norm_sq(self, grads) -> torch.Tensor:
        """The stage's squared grad global norm, a device scalar (over a
        stage mesh each rank's blocks over their replicas, summed over the
        stage's group)."""
        if self.stage_mesh is None:
            return health.grad_global_norm(grads).float() ** 2
        import torch.distributed as dist
        from torch.distributed.tensor import Replicate

        from flexflow_tpu_torch.compiler.compile import _local

        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for ws in grads.values():
            for g in ws.values():
                reps = 1
                for j, p in enumerate(g.placements):
                    if isinstance(p, Replicate):
                        reps *= self.stage_mesh.size(j)
                sq = sq + torch.linalg.vector_norm(
                    _local(g).float()) ** 2 / reps
        dist.all_reduce(sq, group=self._stage_group)
        return sq

    def _gathered_bubble(self, ops) -> Optional[float]:
        """The update's executed bubble over every stage's ops (each stage
        index 0's), gathered."""
        import torch.distributed as dist

        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, ops if self.index == 0 else [])
        allops = [o for g in got for o in g]
        return tel.bubble_from_ops(self.num_stages, allops)

    # ------------------------------------------------------ epoch-end sums
    def _gather_epoch(self, part_sum, gn_sum, pm, t_epoch, grec):
        """The epoch's numbers every rank reports, from one gather of host
        numbers: the loss (the last stage's plus every stage's penalty),
        the squared grad norm summed over stages, the last stage's metric
        sums and samples, rank 0's clock."""
        import torch.distributed as dist

        mine = {"stage": self.stage, "index": self.index,
                "part": float(part_sum) if part_sum is not None else 0.0,
                "gn_sq": float(gn_sum) if gn_sum is not None else 0.0,
                "metric_sums": dict(pm.sums) if self.last else {},
                "train_all": int(pm.train_all) if self.last else 0,
                "wall_s": t_epoch, "goodput": grec["goodput"]}
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, mine)
        firsts = [g for g in got if g["index"] == 0]
        last = next(g for g in firsts if g["stage"] == self.num_stages - 1)
        return {"loss_sum": sum(g["part"] for g in firsts),
                "gn_sq": sum(g["gn_sq"] for g in firsts),
                "metric_sums": last["metric_sums"],
                "train_all": last["train_all"],
                "wall_s": got[0]["wall_s"], "goodput": got[0]["goodput"]}

    # ------------------------------------------------------------ training
    def fit(self, x, y, batch_size: Optional[int] = None,
            epochs: Optional[int] = None, callbacks=None,
            verbose: bool = True, accum_steps: Optional[int] = None,
            steps_per_dispatch: Optional[int] = None,
            resume: Optional[str] = None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every_steps: Optional[int] = None,
            checkpoint_every_secs: Optional[float] = None, **_ignored):
        """CompiledModel.fit's contract (JAX `pipeline.py:668-907`):
        `accum_steps` is the microbatch count M the schedule pipelines
        over; steps_per_dispatch is recorded in step_stats only, as in JAX
        (the loop reads no device value mid-epoch). Durable checkpoints,
        the SIGTERM drain and resume work as on the flat path, through the
        per-layer pipeline checkpoint, so a relaunch may use another stage
        count or stage mesh; periodic snapshots come by steps or by rank
        0's clock, and a SIGTERM on any rank drains them all (the ranks
        agree once an update: runtime/resilience.py `FitResilience`)."""
        from flexflow_tpu_torch.compiler.compile import matmul_precision
        from flexflow_tpu_torch.metrics import PerfMetrics
        from flexflow_tpu_torch.runtime.resilience import FitResilience

        xs = x if isinstance(x, (list, tuple)) else [x]
        if self.stage_cm.params is None:
            self.init()
        gb = self.model.input_tensors[0].shape[0]
        if batch_size is not None and batch_size != gb:
            import warnings

            warnings.warn(f"batch_size={batch_size} coerced to graph "
                          f"batch {gb}")
        batch_size = gb
        epochs = epochs or self.cfg.epochs
        M = max(1, int(accum_steps or self.cfg.accum_steps))
        order = cm.pipeline_order(self.schedule, self.num_stages,
                                  M)[self.stage]
        res = FitResilience.build(self, resume, checkpoint_dir,
                                  checkpoint_every_steps,
                                  checkpoint_every_secs)
        if res is not None:
            res.set_effective(batch_size, M)
            self._retry_policy = self.link.retry_policy = res.policy
        gm = self._goodput = health.GoodputMeter()
        t_res = time.perf_counter()
        progress = res.resume_now(verbose) if res is not None else None
        gm.add("resume", time.perf_counter() - t_res)
        loader = SingleDataLoader(xs, y, batch_size, shuffle=True,
                                  seed=self.cfg.seed)
        base_rng = ff_random.key(self.cfg.seed + 17)
        stats = self.step_stats = {
            "updates": 0, "microbatches": 0, "barriers": 0,
            "stages": self.num_stages, "schedule": self.schedule,
            "stage": self.stage,
            "steps_per_dispatch": int(steps_per_dispatch
                                      or self.cfg.steps_per_dispatch),
            "init_draw_s": self.step_stats.get("init_draw_s")}
        ahead = max(1, int(self.cfg.dispatch_ahead))
        self._drift_windows = []
        self._bubble_sum, self._bubble_n = 0.0, 0
        self._fit_id = next(_FIT_SEQ)
        sstate = self._sentinel_state = health.SentinelState() \
            if self._sentinels_on else None
        halt_on = bool(self.cfg.halt_on_nonfinite)
        start_epoch, skip_steps, history = start_state(progress)
        if progress:
            loader.advance_epochs(start_epoch)
        faults_on = _faults.active()
        cuda = self.device.type == "cuda"
        if res is not None:
            res.install_guard()
        try:
            for epoch in range(start_epoch, epochs):
                part_sum = gn_sum = None
                pm = PerfMetrics()
                t0 = time.perf_counter()
                gm.tick()
                nb = seed_steps = 0
                seed_loss = 0.0
                resuming = epoch == start_epoch and bool(progress)
                grouped = group_microbatches(
                    loader.epoch(skip_batches=skip_steps * M
                                 if resuming else 0), M)
                if resuming:
                    nb = seed_steps = skip_steps
                    seed_loss = float(progress.get("loss_sum") or 0.0)
                    if self.last:
                        pm.sums = {mk: float(mv) for mk, mv in
                                   (progress.get("metric_sums")
                                    or {}).items()}
                        pm.train_all = int(progress.get("samples", 0))

                def make_progress(_pm=pm, _epoch=epoch):
                    _pm.materialize()
                    g = self._gather_epoch(part_sum, gn_sum, _pm, 0.0,
                                           {"goodput": 0.0})
                    return progress_dict(_epoch, nb, seed_loss
                                         + g["loss_sum"], g["metric_sums"],
                                         g["train_all"], history)

                for gxs, gy in grouped:
                    gm.lap("prefetch_wait")
                    if M == 1:
                        gxs = [a[None] for a in gxs]
                        gy = gy[None]
                    if faults_on:
                        run_resilient("fit/dispatch", lambda: None,
                                      self._retry_policy,
                                      index=self._iteration + 1)
                        if _faults.poison("health/nonfinite",
                                          index=self._iteration + 1) \
                                and self.stage == 0:
                            self.stage_cm._poison_first_param()
                    rng_iter = ff_random.fold_in(base_rng, self._iteration)
                    with matmul_precision(self.cfg):
                        part, mvals, gn_sq = self._pipeline_step(
                            gxs, gy, rng_iter, order, M)
                    gm.lap("dispatch")
                    if part is not None:
                        part_sum = part if part_sum is None \
                            else part_sum + part
                    if gn_sq is not None:
                        gn_sum = gn_sq if gn_sum is None else gn_sum + gn_sq
                    if self.last:
                        pm.update_deferred(batch_size * M, mvals)
                    self._iteration += 1
                    nb += 1
                    stats["updates"] += 1
                    stats["microbatches"] += M
                    gm.lap("loop")
                    if nb % ahead == 0:
                        # bounded dispatch-ahead: wait for this rank's
                        # device, read nothing
                        if cuda:
                            torch.cuda.current_stream(
                                self.device).synchronize()
                        stats["barriers"] += 1
                        gm.lap("barrier")
                    if res is not None:
                        res.maybe_checkpoint(make_progress)
                        gm.lap("checkpoint")
                dt = time.perf_counter() - t0
                self._drift_windows.append((nb - seed_steps, dt))
                bubble = (self._bubble_sum / self._bubble_n
                          if self._bubble_n else None)
                if bubble is not None:
                    stats["measured_bubble"] = bubble
                if tel.enabled():
                    tel.record("fit/epoch", tel.now_us() - dt * 1e6,
                               cat="fit", epoch=epoch, steps=nb)
                pm.materialize()
                grec = gm.epoch_end(dt, epoch, bubble_frac=bubble)
                g = self._gather_epoch(part_sum, gn_sum, pm, dt, grec)
                summ = {k: v / max(1, g["train_all"])
                        for k, v in g["metric_sums"].items()}
                loss_mean = (seed_loss + g["loss_sum"]) / nb if nb else 0.0
                summ["loss"] = loss_mean
                if sstate is not None and nb > seed_steps:
                    win = nb - seed_steps
                    gsq = g["gn_sq"]
                    grad_norm = float(np.sqrt(gsq / win)) \
                        if gsq == gsq else float("nan")
                    nonfinite = 0.0 if (np.isfinite(loss_mean)
                                        and np.isfinite(grad_norm)) else 1.0
                    verdict = sstate.observe(self._iteration,
                                             loss_mean=loss_mean,
                                             grad_norm=grad_norm,
                                             nonfinite=nonfinite)
                    if verdict == "nonfinite" and halt_on:
                        health.halt_nonfinite(
                            self._iteration,
                            res.root if res is not None else None,
                            detail="pipeline epoch-end window")
                summ["epoch_time_s"] = g["wall_s"]
                summ["samples_per_sec"] = (
                    (nb - seed_steps) * M * batch_size / g["wall_s"]
                    if g["wall_s"] > 0 else 0.0)
                summ["dispatches"] = float(nb)
                summ["goodput"] = g["goodput"]
                self._watermarks.sample(f"epoch{epoch}", self._local_trees(),
                                        self.device)
                history.append(summ)
                if verbose:
                    ms = " ".join(f"{k}={v:.4f}" for k, v in summ.items())
                    print(f"[epoch {epoch}] stage {self.stage} {ms}")
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
        self._fit_end_report(verbose)
        if self.cfg.profile_ops and (verbose or tel.enabled()):
            self.op_attribution(print_table=verbose)
        return history

    def _fit_end_report(self, verbose: bool) -> None:
        from flexflow_tpu_torch.runtime.checkpoint import warn_failed_writes

        tel.emit_fit_end(self.drift_stats(), verbose,
                         measured_bubble=self.step_stats.get(
                             "measured_bubble"))
        warn_failed_writes(verbose)

    def _local_trees(self):
        return self.stage_cm._local_trees()

    # ----------------------------------------------------- inference path
    def _run_forward(self, xs, with_label=None):
        """One batch through the stages in inference mode: the last stage
        returns its outputs (and, with a label, the loss and metrics);
        the others None."""
        from flexflow_tpu_torch.compiler.compile import _full, matmul_precision
        from flexflow_tpu_torch.losses import compute_loss
        from flexflow_tpu_torch.metrics import compute_metrics

        scm, link, s = self.stage_cm, self.link, self.stage
        link.begin_update(1)
        with torch.no_grad(), matmul_precision(self.cfg):
            if s == 0:
                x = [self._in_put(a, t) for a, t in zip(xs, self.stage_inputs)]
            else:
                x = [self._from_wire(link.recv_act(0), s - 1)]
            outs, _ = scm.forward_fn(scm.params, scm.state, x)
            if not self.last:
                link.send_act(self._to_wire(outs[0], s), 0, want_grad=False)
                link.end_update()
                return None
            link.end_update()
            if with_label is None:
                return [_full(o) for o in outs]
            lab = self._label(with_label)
            logits = outs[0].float()
            loss = _full(compute_loss(self.loss_type, logits, lab))
            return loss, compute_metrics(self.metrics, _full(logits),
                                         _full(lab))

    def _from_last(self, obj):
        """`obj` of the last stage's first rank, on every rank."""
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(
            box, src=(self.num_stages - 1) * self.per_stage)
        return box[0]

    def evaluate(self, x, y, batch_size: Optional[int] = None):
        from flexflow_tpu_torch.metrics import PerfMetrics

        xs = x if isinstance(x, (list, tuple)) else [x]
        gb = self.model.input_tensors[0].shape[0]
        loader = SingleDataLoader(xs, y, gb, shuffle=False)
        pm = PerfMetrics()
        loss_sum, nb = 0.0, 0
        for bxs, by in loader.epoch():
            r = self._run_forward(bxs, with_label=by)
            if r is not None:
                loss_sum += float(r[0])
                pm.update_deferred(gb, r[1])
            nb += 1
        pm.materialize()
        out = pm.summary() if self.last else None
        if self.last:
            out["loss"] = loss_sum / nb if nb else 0.0
        return self._from_last(out)

    def forward(self, *inputs):
        """The model's outputs for one batch, on every rank (CPU tensors,
        from the last stage)."""
        if self.stage_cm.params is None:
            self.init()
        outs = self._run_forward([np.asarray(a) for a in inputs])
        if outs is not None:
            outs = [o.detach().cpu() for o in outs]
        outs = self._from_last(outs)
        return outs[0] if len(outs) == 1 else outs

    # --------------------------------------------------------------- state
    def merged_params(self) -> Dict[str, Any]:
        """One params tree keyed by layer name, every stage's layers as
        full CPU tensors, on every rank (a collective): the checkpoint's
        schema."""
        import torch.distributed as dist

        from flexflow_tpu_torch.compiler.compile import _full

        mine = {l: {w: _full(t).detach().cpu() for w, t in ws.items()}
                for l, ws in (self.stage_cm.params or {}).items()}
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, mine if self.index == 0 else {})
        merged: Dict[str, Any] = {}
        for g in got:
            merged.update(g)
        return merged

    def get_weight(self, layer_name: str, wname: str = "kernel"):
        merged = self.merged_params()
        if layer_name not in merged:
            raise KeyError(layer_name)
        return merged[layer_name][wname].numpy()

    def set_weight(self, layer_name: str, wname: str, value):
        """Every rank calls it; the ranks of the owning stage write."""
        if layer_name in (self.stage_cm.params or {}):
            self.stage_cm.set_weight(layer_name, wname, value)
        elif not any(layer_name == l.name for l in self.model.layers):
            raise KeyError(layer_name)

    def memory_stats(self) -> dict:
        """Per-device persistent memory, pipeline edition: every stage's
        param and optimizer-state bytes (this rank's blocks, gathered
        from each stage's first rank), next to the schedule's in-flight
        boundary inputs."""
        import torch.distributed as dist

        from flexflow_tpu_torch.health import _tree_bytes

        p, o = self._local_trees()
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (self.stage, self.index,
                                     _tree_bytes(p), _tree_bytes(o)))
        per_p = [0] * self.num_stages
        per_o = [0] * self.num_stages
        for st, idx, pb, ob in got:
            if idx == 0:
                per_p[st], per_o[st] = pb, ob
        return {
            "pipeline_stages": self.num_stages,
            "schedule": self.schedule,
            "cuts": list(self.cuts),
            "stage": self.stage,
            "zero_sharding": self.stage_cm._zero,
            "per_stage_param_bytes": per_p,
            "per_stage_opt_bytes": per_o,
            "actual_param_bytes_per_device": max(per_p),
            "actual_opt_state_bytes_per_device": max(per_o),
            "inflight_activations": cm.pipeline_inflight_acts(
                self.schedule, self.num_stages,
                max(1, int(self.cfg.accum_steps))),
        }

    # ------------------------------------------------------------ reports
    def predicted_schedule(self, num_micro: Optional[int] = None) -> dict:
        """The cost model's view of this compile's schedule: per-stage
        analytic times, the replay's makespan and bubble, and the closed
        form."""
        from flexflow_tpu_torch.search.candidates import layer_candidates
        from flexflow_tpu_torch.search.simulator import simulate_pipeline

        M = int(num_micro or self.cfg.accum_steps) or 1
        bs = self._batch_sizes()
        stage_costs = []
        for seg in self.stage_layers:
            t = 0.0
            for layer in seg:
                cands = layer_candidates(layer, self.stage_machine, bs)
                if not cands[0].passthrough:
                    t += cands[0].op_time(layer, self.stage_machine)
            stage_costs.append(t)
        fwd, bwd = cm.pipeline_phase_times(stage_costs)
        rep = simulate_pipeline(fwd, bwd, self.schedule, M)
        return {"stage_costs_s": stage_costs,
                "makespan_s": rep["makespan"], "bubble": rep["bubble"],
                "bubble_closed_form": cm.pipeline_bubble_fraction(
                    self.schedule, self.num_stages, M)}

    def predicted_step_time(self) -> Optional[float]:
        """The per-update prediction: the replay's makespan over M
        microbatches (what the cut search ranked by)."""
        t = float(self.predicted_schedule()["makespan_s"])
        return t if t > 0 else None

    def drift_stats(self) -> dict:
        return tel.drift_stats(self.predicted_step_time(),
                               list(self._drift_windows))

    def goodput_report(self) -> dict:
        return self._goodput.report() if self._goodput is not None else {}

    def health_report(self) -> dict:
        """Sentinel status, and the memory watermark against the heaviest
        stage's persistent bytes (a collective: memory_stats gathers)."""
        sent = self._sentinel_state.status() \
            if self._sentinel_state is not None else None
        wm = None
        if self._watermarks.samples:
            mem = self.memory_stats()
            wm = self._watermarks.report(
                mem["actual_param_bytes_per_device"]
                + mem["actual_opt_state_bytes_per_device"])
        return {"sentinels": sent, "watermarks": wm}

    def _gather_stage_rows(self, mine) -> list:
        """`mine` of the first rank of each stage, in stage order, on
        every rank (a host-side gather of picklable values, as at an
        epoch's end)."""
        import torch.distributed as dist

        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (self.stage, self.index, mine))
        return [v for _, _, v in sorted(
            (g for g in got if g[1] == 0), key=lambda g: g[0])]

    def op_attribution(self, step_time_s: Optional[float] = None,
                       source: str = "auto", top: int = 0,
                       print_table: bool = True) -> dict:
        """Per-op attribution of every stage (attribution.py, JAX
        `pipeline.py:1093`), rows tagged with their stage, every column per
        update (mult = M): each stage's rows are measured on its first
        rank, every rank gathers them (one host-side gather, as at an
        epoch's end) and rescales the pooled rows to the update's measured
        wall time, the makespan of concurrent stages, so attributed times
        are each op's share of the wall clock. Every rank calls it."""
        from flexflow_tpu_torch import attribution
        from flexflow_tpu_torch.search.candidates import compiled_candidate

        if step_time_s is None:
            step_time_s = self._gather_stage_rows(
                self.drift_stats().get("measured_step_time_s"))[0]
        pred = getattr(self.strategy, "_predicted_op_costs", None) or {}
        bs = self._batch_sizes()
        items = []
        for layer in self.stage_layers[self.stage]:
            cand = compiled_candidate(layer, self.strategy,
                                      self.stage_machine, bs)
            if cand.passthrough:
                continue
            items.append({"layer": layer, "cand": cand,
                          "machine": self.stage_machine,
                          "predicted_s": pred.get(layer.name),
                          "stage": self.stage})
        profile_dir = (self.cfg.profile_dir or "./ff_profile") \
            if self.cfg.profiling else None
        mult = max(1, int(self.cfg.accum_steps))
        rows, att = attribution.measure_rows(
            items, step_time_s=step_time_s, mult=mult,
            profile_dir=profile_dir, source=source, device=self.device,
            compute_dtype=self.cfg.compute_dtype,
            enable_fusion=self.cfg.enable_fusion)
        pooled = self._gather_stage_rows((rows, att))
        if len({a is None for _, a in pooled}) > 1:
            raise ValueError("pipelined op_attribution: some stages read a "
                             "profiler trace and others measured; profile "
                             "every stage or none")
        atts = [a for _, a in pooled if a is not None]
        if atts:
            att = {"layers": {k: v for a in atts
                              for k, v in a["layers"].items()},
                   "file": atts[0]["file"],
                   "device_us": sum(a["device_us"] for a in atts),
                   "credited_us": sum(a["credited_us"] for a in atts),
                   "kernels": {k: v for a in atts
                               for k, v in a["kernels"].items()}}
        report = attribution.assemble_report(
            [r for rs, _ in pooled for r in rs], att if atts else None,
            step_time_s=step_time_s, mult=mult)
        if print_table:
            for line in attribution.format_report(report, top=top):
                print(line)
        return report

    def profile_report(self, top: int = 0, print_table: bool = True):
        """Per-op timing of every stage (analytic, and measured alone on
        the stage's first rank; JAX `pipeline.py:1135`), rows tagged with
        their stage and gathered to every rank, with [pipeline] predicted
        against measured bubble, [drift], [goodput], [health] and [memory]
        lines. Every rank calls it (the rows and memory_stats gather)."""
        from flexflow_tpu_torch.search.candidates import layer_candidates
        from flexflow_tpu_torch.search.measure import MeasuredCost

        mc = MeasuredCost(self.stage_machine, repeats=3, warmup=1,
                          cache_dir="", device=self.device,
                          compute_dtype=self.cfg.compute_dtype,
                          enable_fusion=self.cfg.enable_fusion)
        bs = self._batch_sizes()
        rows = []
        for layer in self.stage_layers[self.stage]:
            cand = layer_candidates(layer, self.stage_machine, bs)[0]
            if cand.passthrough:
                continue
            rows.append({"stage": self.stage, "layer": layer.name,
                         "op": layer.op_type.value, "candidate": cand.name,
                         "analytic_us": cand.op_time(
                             layer, self.stage_machine) * 1e6,
                         "measured_us": mc.op_time(layer, cand) * 1e6})
        rows = [r for rs in self._gather_stage_rows(rows) for r in rs]
        rows.sort(key=lambda x: (x["stage"], -x["measured_us"]))
        if top:
            rows = rows[:top]
        mem = self.memory_stats()
        hrep = self.health_report()
        if print_table:
            for x in rows:
                print(f"{x['stage']:2d} {x['layer'][:26]:26} "
                      f"{x['op'][:16]:16} {x['analytic_us']:9.1f}u "
                      f"{x['measured_us']:9.1f}u")
            pred = self.predicted_schedule()
            mb = self.step_stats.get("measured_bubble")
            print(f"[pipeline] stages={self.num_stages} "
                  f"schedule={self.schedule} cuts={list(self.cuts)} "
                  f"predicted_bubble={pred['bubble']:.3f} "
                  + (f"measured_bubble={mb:.3f}" if mb is not None
                     else "measured_bubble=n/a (enable --telemetry-dir)"))
            for line in tel.format_drift(self.drift_stats()):
                print(line)
            if self._goodput is not None and self._goodput.epochs:
                for line in health.format_goodput(self._goodput.report()):
                    print(line)
            for line in health.format_health(hrep["sentinels"],
                                             hrep["watermarks"]):
                print(line)
            mbyte = 1024 * 1024
            for s in range(self.num_stages):
                print(f"[memory] stage {s}: params "
                      f"{mem['per_stage_param_bytes'][s] / mbyte:.2f}MB, "
                      f"opt state "
                      f"{mem['per_stage_opt_bytes'][s] / mbyte:.2f}MB "
                      "per device")
            from flexflow_tpu_torch.runtime.checkpoint import \
                report_failed_writes

            for line in report_failed_writes():
                print(line)
        return rows

    # ---------------------------------------------------------- checkpoint
    def save_checkpoint(self, path: str, block: Optional[bool] = None) -> str:
        from flexflow_tpu_torch.runtime.checkpoint import \
            save_pipeline_checkpoint

        return save_pipeline_checkpoint(self, path)

    def load_checkpoint(self, path: str) -> None:
        from flexflow_tpu_torch.runtime.checkpoint import \
            restore_pipeline_checkpoint

        restore_pipeline_checkpoint(self, path)

    def wait_checkpoints(self) -> None:
        from flexflow_tpu_torch.runtime.checkpoint import wait_pending

        wait_pending()
