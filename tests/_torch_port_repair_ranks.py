"""Rank code of tests/test_torch_port_repairs.py (a module the spawned gloo
ranks import, with no JAX at its top; `_torch_port_ranks.shared(world,
__name__)` runs its functions on every rank)."""

import os
import signal

import numpy as np

import flexflow_tpu_torch as F


def fat_fork_join(pkg, cfg, hidden=64):
    """Two congruent dense branches joined by add (stacked weights), and a
    head: tests/test_interop.py's placed model at a small width."""
    m = pkg.FFModel(cfg)
    x = m.create_tensor([32, 16], name="x")

    def branch(act):
        def build(mm, t):
            return mm.dense(mm.dense(t, hidden, activation=act, name="mid"),
                            16, name="out")
        return build
    t = m.fork_join(x, [branch("relu"), branch("gelu")], join="add",
                    name="fj")
    m.dense(t, 4, name="head")
    return m


def rank_set_branch(params, value):
    """The placed ensemble over {"model": 2} (each rank one branch's block
    of the stacked weights): set one branch's kernel, read both back."""
    from flexflow_tpu_torch.parallel.templates import apply_branch_placement

    m = fat_fork_join(F, F.FFConfig(batch_size=32, mesh_shape={"model": 2},
                                    only_data_parallel=True))
    cm = m.compile(F.SGDOptimizer(lr=0.01), "mean_squared_error", [],
                   device="cpu")
    apply_branch_placement(cm.strategy, m.get_layer_by_name("fj"), "model")
    cm._build_steps()
    cm.load_params(params)
    before = cm.params["fj"]["stk.mid.kernel"].to_local().clone()
    cm.set_weight("fj", "b1.mid.kernel", value)
    after = cm.params["fj"]["stk.mid.kernel"].to_local()
    return {"b1": cm.get_weight("fj", "b1.mid.kernel"),
            "b0": cm.get_weight("fj", "b0.mid.kernel"),
            "local": tuple(after.shape),
            "local_changed": bool((before != after).any())}


def _pipelined(accum=2):
    m = F.FFModel(F.FFConfig(batch_size=8, only_data_parallel=True, seed=3,
                             pipeline_stages=2, accum_steps=accum))
    t = m.create_tensor([8, 64], name="x")
    h = m.dense(t, 256, activation="gelu", name="up")
    h = m.dense(h, 64, name="down")
    h = m.dense(h, 128, activation="relu", name="mid")
    m.dense(h, 8, name="head")
    return m, m.compile(F.AdamOptimizer(alpha=0.01),
                        "sparse_categorical_crossentropy", [], device="cpu")


def _mlp_data(n=32):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, 64)).astype(np.float32),
            rng.integers(0, 8, size=(n,)).astype(np.int32))


def rank_pipeline_reports():
    """The pipelined report rows after a fit, as each rank returns them."""
    _, cm = _pipelined()
    cm.init(seed=0)
    cm.fit(*_mlp_data(), epochs=1, verbose=False)
    att = cm.op_attribution(source="measure", print_table=False)
    prof = cm.profile_report(print_table=False)
    rows = prof if isinstance(prof, list) else prof["rows"]
    return {"stage": cm.stage,
            "attribution": sorted((r["stage"], r["layer"], r["op"],
                                   r["candidate"]) for r in att["rows"]),
            "attributed_total": att["attributed_total_s"],
            "step_time": att["step_time_s"],
            "profile": [(r["stage"], r["layer"], r["op"], r["candidate"])
                        for r in rows]}


def _record_saves(res_cls, saved):
    save = res_cls.save

    def recording(self, progress, block=None):
        saved.append(int(self.model._iteration))
        return save(self, progress, block)
    return save, recording


def rank_time_trigger(root, flat):
    """A fit with `checkpoint_every_secs=1` whose rank-0 clock runs 1000x
    fast (rank 1's is real): the updates each rank snapshotted."""
    import time

    import torch.distributed as dist

    from flexflow_tpu_torch.runtime import resilience as R

    saved = []
    save, recording = _record_saves(R.FitResilience, saved)
    R.FitResilience.save = recording
    if dist.get_rank() == 0:
        t0 = time.monotonic()

        class Fast:
            @staticmethod
            def monotonic():
                return t0 + 1000.0 * (time.monotonic() - t0)

            sleep = staticmethod(time.sleep)
        R.time = Fast
    try:
        cm = _flat() if flat else _pipelined()[1]
        cm.init(seed=0)
        hist = cm.fit(*_mlp_data(), epochs=1, verbose=False,
                      checkpoint_dir=root, checkpoint_every_secs=1.0)
        cm.wait_checkpoints()
    finally:
        R.FitResilience.save = save
        R.time = time
    return {"saved": saved, "iteration": cm._iteration,
            "losses": [h["loss"] for h in hist],
            "snapshots": [s for s, _, _ in R.committed_snapshots(root)]}


def _flat():
    m = F.FFModel(F.FFConfig(batch_size=8, mesh_shape={"data": 2}, seed=3))
    t = m.create_tensor([8, 64], name="x")
    m.dense(m.dense(t, 128, activation="relu", name="up"), 8, name="head")
    return m.compile(F.AdamOptimizer(alpha=0.01),
                     "sparse_categorical_crossentropy", [], device="cpu")


def rank_sigterm_one_rank(root, flat):
    """SIGTERM sent to rank 1 only, right after its second update: how
    each rank's fit ended and the snapshots committed."""
    import torch.distributed as dist

    from flexflow_tpu_torch.runtime.resilience import (Preempted,
                                                       committed_snapshots)

    cm = _flat() if flat else _pipelined()[1]
    cm.init(seed=0)
    if dist.get_rank() == 1:
        if flat:
            step = cm.train_step

            def stepping(*a, **k):
                out = step(*a, **k)
                if cm._iteration == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out
            cm.train_step = stepping
        else:
            step = cm._pipeline_step

            def stepping(*a, **k):
                out = step(*a, **k)
                if cm._iteration == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out
            cm._pipeline_step = stepping
    try:
        cm.fit(*_mlp_data(), epochs=2, verbose=False, checkpoint_dir=root)
        ended = "finished"
    except Preempted as e:
        ended = f"preempted code {e.code}"
    return {"ended": ended, "iteration": cm._iteration,
            "snapshots": [s for s, _, _ in committed_snapshots(root)]}


def quickstart_mlp(cfg):
    """The quickstart notebook's MLP (64 -> 4096 relu -> 64 -> 10)."""
    m = F.FFModel(cfg)
    x = m.create_tensor([64, 64], name="x")
    h = m.dense(x, 4096, activation="relu", name="up")
    h = m.dense(h, 64, name="down")
    m.dense(h, 10, name="head")
    cm = m.compile(F.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy",
                   ["accuracy"], device="cpu")
    cm.init(seed=0)
    return cm


def rank_class_sharded_fit(xs, ys):
    """The quickstart's MLP over {"data": 1, "model": 2} searched on the
    H100 preset's machine (its pick splits the head over its classes), two
    epochs, counting DTensor's functional all-gathers."""
    import torch.distributed._functional_collectives as fc

    from flexflow_tpu_torch.parallel import machine as mm

    detect, gathers = mm.MachineSpec.detect, []
    # every functional all-gather (torch's versions name them apart)
    saved = {n: getattr(fc, n) for n in dir(fc)
             if n.startswith("all_gather") and callable(getattr(fc, n))}

    def h100(mesh_axes=None, dcn_axes=(), device=None):
        m = detect(mesh_axes, dcn_axes, device)
        return mm.MachineSpec(mesh_axes=dict(m.mesh_axes), chip="h100",
                              dcn_axes=tuple(dcn_axes))

    def counted(fn):
        def call(*a, **kw):
            gathers.append(1)
            return fn(*a, **kw)
        return call
    mm.MachineSpec.detect = staticmethod(h100)
    for n, fn in saved.items():
        setattr(fc, n, counted(fn))
    try:
        cm = quickstart_mlp(F.FFConfig(batch_size=64, search_budget=8,
                                       mesh_shape={"data": 1, "model": 2}))
        hist = cm.fit(xs, ys, epochs=2, verbose=False)
    finally:
        mm.MachineSpec.detect = staticmethod(detect)
        for n, fn in saved.items():
            setattr(fc, n, fn)
    return {"head": [list(d) if isinstance(d, (list, tuple)) else d
                     for d in cm.strategy.op_shardings["head"].weights[
                         "kernel"]],
            "gathers": len(gathers), "losses": [h["loss"] for h in hist],
            "accuracy": hist[-1]["accuracy"]}
