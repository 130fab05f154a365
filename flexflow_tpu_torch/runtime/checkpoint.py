"""Checkpoint and restore of the full training state (counterpart:
flexflow_tpu/runtime/checkpoint.py).

A checkpoint is a directory: `meta.json` (iteration, state keys, the
strategy's JSON, the model fingerprint) and `tree/state.pt`, the params,
optimizer state and non-trainable state as CPU tensors (`torch.save`).
The JAX package's orbax format is not read: weights cross packages
through `convert.py`.

Non-blocking saves copy, then write: `save_checkpoint(..., block=False)`
takes the device-to-host snapshot ON THE CALLER THREAD before it returns.
That is required: the optimizer updates params and moments in place (the
port's analog of the JAX step's buffer donation), so the next step would
overwrite what a background thread read. A daemon writer thread then does
the serialization and the fsync. `wait_pending()` joins writers and
re-raises their errors; a restore waits for an in-flight write to the
same directory, and a save to a directory with a write in flight waits
for it first. Failed writes stay listed (`failed_writes()`) until an
error is re-raised to a caller, and a drain at interpreter exit joins the
writers so that a save issued just before exit is not cut off.

The fingerprint (`model_fingerprint`) is what the saved tree depends on:
each weighted layer's op type and weight shapes and dtypes, and the
optimizer's class, moment count and state dtype. A restore into another
model raises `CheckpointMismatchError`, listing the layers that differ.

Over a mesh (JAX's round trip across meshes, `tests/test_zero.py:253`)
a checkpoint still holds full arrays: every rank gathers each DTensor
(a collective), rank 0 writes, blocking, and every rank waits at a
barrier for the write; a restore reads the full arrays on every rank and
each keeps its own block under the live layout, whatever mesh, strategy
or ZeRO mode wrote them.

A pipeline checkpoint (`save_pipeline_checkpoint`, JAX `checkpoint.py:
476-580`) keeps the params as one tree keyed by layer and the optimizer
state per layer (`_split_opt_by_layer`; `meta.json` says "opt_schema":
"per-layer"), so a restore lands on another stage mesh AND another stage
count or cut set; the stage-keyed legacy schema is refused. Each stage's
first rank writes its layers (`tree/stage-<s>.pt`), rank 0 writes
`meta.json` once every stage's file is written, and the commit runs
after it; every rank waits at a barrier for both.

Telemetry (telemetry.py): the spans `checkpoint/snapshot` (the copy on
the caller thread), `checkpoint/write` (on the writer thread, or on the
caller's with `blocking`) and `checkpoint/drain` (`wait_pending`), and
the error event `checkpoint/write_failed` the moment a write fails.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from flexflow_tpu_torch import telemetry as tel

_LOG = logging.getLogger("flexflow_tpu_torch")
TREE_FILE = os.path.join("tree", "state.pt")


def _ckpt_dir(path: str) -> str:
    return os.path.abspath(path)


# ------------------------------------------------------- model fingerprints
class CheckpointMismatchError(ValueError):
    """The checkpoint was written by another model or optimizer than the
    one it is restored into."""


def _graph_fingerprint(model) -> Dict[str, str]:
    """Per weighted layer, a digest of its op type and each weight's
    (name, shape, dtype), keyed by layer name so that a mismatch can list
    the layers. Layers without weights add nothing to the tree."""
    out = {}
    for l in model.layers:
        if not l.weight_specs:
            continue
        desc = f"{l.op_type.value}|" + ";".join(
            f"{w}:{tuple(sp.shape)}:{sp.dtype}"
            for w, sp in sorted(l.weight_specs.items()))
        out[l.name] = hashlib.sha1(desc.encode()).hexdigest()[:10]
    return out


def model_fingerprint(cm) -> Dict[str, Any]:
    """Graph, optimizer state schema and format of a CompiledModel, or a
    PipelinedModel's whole graph in the "pipeline" format (the learning
    rate and betas are not part of it: resuming under another schedule is
    legitimate)."""
    opt = cm.optimizer
    return {
        "format": "pipeline" if hasattr(cm, "stage_cm") else "flat",
        "graph": _graph_fingerprint(cm.model),
        "optimizer": {
            "class": type(opt).__name__,
            "moments": int(opt.moment_count()),
            "state_dtype": str(getattr(opt, "state_dtype", None)
                               or "float32"),
        },
    }


def _validate_fingerprint(meta: Dict[str, Any], live: Dict[str, Any],
                          path: str) -> None:
    saved = meta.get("fingerprint")
    if not saved:
        return
    diffs: List[str] = []
    if saved.get("format") != live["format"]:
        diffs.append(f"format: checkpoint={saved.get('format')} "
                     f"model={live['format']}")
    sg = dict(saved.get("graph") or {})
    lg = live["graph"]
    only_ck = sorted(set(sg) - set(lg))
    only_live = sorted(set(lg) - set(sg))
    changed = sorted(k for k in set(sg) & set(lg) if sg[k] != lg[k])
    if only_ck:
        diffs.append(f"graph: layers only in checkpoint: {only_ck[:8]}")
    if only_live:
        diffs.append(f"graph: layers only in model: {only_live[:8]}")
    if changed:
        diffs.append("graph: layers with different weight schema "
                     f"(op/shape/dtype): {changed[:8]}")
    so = dict(saved.get("optimizer") or {})
    lo = live["optimizer"]
    for k in ("class", "moments", "state_dtype"):
        if so.get(k) != lo.get(k):
            diffs.append(f"optimizer {k}: checkpoint={so.get(k)!r} "
                         f"model={lo.get(k)!r}")
    if diffs:
        raise CheckpointMismatchError(
            f"checkpoint {path} does not match the model:\n  "
            + "\n  ".join(diffs))


# ------------------------------------------------------- async write registry
_PENDING: Dict[str, "_AsyncSave"] = {}
_PENDING_LOCK = threading.Lock()
# failed async writes whose error no caller has seen yet
_FAILED: List[Dict[str, Any]] = []


def failed_writes() -> List[Dict[str, str]]:
    """Failed async writes whose error has not been re-raised yet."""
    with _PENDING_LOCK:
        return [{"path": d["path"], "error": d["error"]} for d in _FAILED]


def warn_failed_writes(verbose: bool) -> None:
    """Log (and, verbose, print) the failed writes not yet reported."""
    fw = failed_writes()
    if not fw:
        return
    msg = (f"{len(fw)} async checkpoint write(s) FAILED: "
           + "; ".join(f"{f['path']}: {f['error']}" for f in fw)
           + " — call wait_checkpoints() to re-raise")
    _LOG.warning(msg)
    if verbose:
        print(f"[checkpoint] WARNING: {msg}")


def report_failed_writes() -> List[str]:
    """One `profile_report` line per failed write not yet reported."""
    return [f"[checkpoint] FAILED async write: {f['path']}: {f['error']}"
            for f in failed_writes()]


def active_writes(prefix: Optional[str] = None) -> List[str]:
    """Paths of async writes whose thread is still running."""
    with _PENDING_LOCK:
        items = list(_PENDING.items())
    return [p for p, h in items
            if (not prefix or p.startswith(prefix))
            and h._thread is not None and h._thread.is_alive()]


_EXIT_HOOKED = False
# the exit drain and the resume drain wait at most this long for writers
DRAIN_TIMEOUT = float(os.environ.get("FF_CKPT_EXIT_TIMEOUT", "120"))


def _wait_pending_at_exit():
    # writer threads are daemons: without this join a save issued just
    # before exit would be killed mid-write
    try:
        wait_pending(timeout=DRAIN_TIMEOUT)
    except TimeoutError as e:
        _LOG.error("exit drain timed out (%s); abandoned write(s) may be "
                   "TRUNCATED: %s — raise FF_CKPT_EXIT_TIMEOUT to wait "
                   "longer", e, active_writes() or "<none>")
    except Exception as e:
        _LOG.error("async checkpoint write failed at exit: %s", e)
    finally:
        warn_failed_writes(verbose=True)


def _register_exit_drain():
    """Install the exit drain at the first async save, as a hook of
    threading's shutdown (it runs before the interpreter tears down)."""
    global _EXIT_HOOKED
    with _PENDING_LOCK:
        if _EXIT_HOOKED:
            return
        _EXIT_HOOKED = True
    try:
        threading._register_atexit(_wait_pending_at_exit)
    except Exception:  # private API; fall back to atexit
        atexit.register(_wait_pending_at_exit)


class _AsyncSave:
    """Handle of one background checkpoint write."""

    def __init__(self, path: str):
        self.path = path
        self._exc: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def _run(self, write_fn):
        try:
            with tel.span("checkpoint/write", cat="checkpoint",
                          path=self.path):
                write_fn()
            # a FAILED handle stays registered until result() reports it
            with _PENDING_LOCK:
                if _PENDING.get(self.path) is self:
                    del _PENDING[self.path]
        except BaseException as e:  # surfaced by result()/wait_pending()
            self._exc = e
            with _PENDING_LOCK:
                _FAILED.append({"path": self.path, "error": repr(e),
                                "handle": self})
            tel.error("checkpoint/write_failed", path=self.path,
                      error=repr(e))
            _LOG.error("async checkpoint write to %s failed: %s",
                       self.path, e)

    def start(self, write_fn):
        self._thread = threading.Thread(
            target=self._run, args=(write_fn,), daemon=True,
            name=f"ff-ckpt-write:{os.path.basename(self.path)}")
        self._thread.start()

    def result(self, timeout: Optional[float] = None) -> str:
        assert self._thread is not None
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"checkpoint write to {self.path} still "
                               f"running after {timeout}s")
        with _PENDING_LOCK:
            if _PENDING.get(self.path) is self:
                del _PENDING[self.path]
        if self._exc is not None:
            with _PENDING_LOCK:  # reported here: clear the registry
                _FAILED[:] = [d for d in _FAILED
                              if d.get("handle") is not self]
            raise self._exc
        return self.path


def wait_pending(path: Optional[str] = None,
                 timeout: Optional[float] = None) -> None:
    """Join in-flight async writes (all, or `path`'s). Every handle is
    joined before the first error is re-raised; `timeout` bounds the whole
    wait (TimeoutError past it; the write keeps running). A write failure
    outranks a timeout."""
    with _PENDING_LOCK:
        if path is None:
            handles: List[_AsyncSave] = list(_PENDING.values())
        else:
            h = _PENDING.get(_ckpt_dir(path))
            handles = [h] if h is not None else []
    if not handles:
        return
    deadline = None if timeout is None else time.monotonic() + timeout
    first_exc: Optional[BaseException] = None
    with tel.span("checkpoint/drain", cat="checkpoint",
                  pending=len(handles)):
        for h in handles:
            remaining = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            try:
                h.result(timeout=remaining)
            except BaseException as e:
                if first_exc is None or (isinstance(first_exc, TimeoutError)
                                         and h._exc is not None):
                    first_exc = e
                elif h._exc is not None:
                    # not re-raised: keep it listed as failed
                    with _PENDING_LOCK:
                        _FAILED.append({"path": h.path, "error": repr(e),
                                        "handle": h})
    if first_exc is not None:
        raise first_exc


# ------------------------------------------------------------------ save/load
def _snapshot(tree):
    """A CPU copy of every tensor of `tree` (dicts of tensors and ints),
    complete when this returns; a DTensor's full value, gathered.
    Device tensors go through pinned memory, one synchronization for the
    whole tree."""
    from torch.distributed.tensor import DTensor

    streams = set()

    def copy(x):
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if isinstance(x, DTensor):
            x = x.full_tensor()
        if x.device.type != "cuda":
            return x.clone()
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x, non_blocking=True)
        streams.add(torch.cuda.current_stream(x.device))
        return out

    host = copy(tree)
    for s in streams:
        s.synchronize()
    return host


def _write_tree(path: str, host_tree: Dict[str, Any],
                meta: Dict[str, Any]) -> None:
    """The slow half of a save: the tree, then meta.json, each fsync'd."""
    tfile = os.path.join(path, TREE_FILE)
    os.makedirs(os.path.dirname(tfile), exist_ok=True)
    with open(tfile, "wb") as f:
        torch.save(host_tree, f)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(cm, path: str, block: bool = True, commit=None,
                    retry_policy=None) -> str:
    """Persist a CompiledModel's training state (params, optimizer state,
    non-trainable state, iteration, strategy) under `path`. With
    block=False the host snapshot is taken here and the write runs on a
    background thread; `commit` (the durable snapshots' rename) runs after
    the write, on whichever thread wrote. The write and the commit run as
    ONE `checkpoint/write` operation under `retry_policy` (one fault index
    a save): a transient fault in the commit retries both halves, and the
    commit does nothing once its rename has landed."""
    from flexflow_tpu_torch.runtime.resilience import run_resilient

    path = _ckpt_dir(path)
    wait_pending(path)  # never two writers on one directory
    mesh = getattr(cm, "mesh", None)
    meta = {
        "iteration": int(cm._iteration),
        "state_keys": sorted(cm.state),
        "strategy": cm.strategy.to_json(),
        "fingerprint": model_fingerprint(cm),
    }
    with tel.span("checkpoint/snapshot", cat="checkpoint", path=path):
        host = _snapshot({"params": cm.params, "opt_state": cm.opt_state,
                          "state": cm.state})

    def write_and_commit():
        def once():
            _write_tree(path, host, meta)
            if commit is not None:
                commit()

        run_resilient("checkpoint/write", once, retry_policy)

    if mesh is not None:
        import torch.distributed as dist

        # rank 0 writes the gathered arrays; the others wait for it
        if dist.get_rank() == 0:
            with tel.span("checkpoint/write", cat="checkpoint", path=path,
                          blocking=True):
                write_and_commit()
        dist.barrier()
        return path
    if block:
        with tel.span("checkpoint/write", cat="checkpoint", path=path,
                      blocking=True):
            write_and_commit()
        return path
    _register_exit_drain()
    handle = _AsyncSave(path)
    with _PENDING_LOCK:
        _PENDING[path] = handle
    handle.start(write_and_commit)
    return path


def _copy_into(live, saved, where: str):
    """`saved` copied into the live tree in place (the tensors, and the
    fused optimizer's pointer table built on them, stay); non-tensor
    leaves (Adam's count) are replaced."""
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(live) != set(saved):
            raise CheckpointMismatchError(
                f"{where}: keys {sorted(saved) if isinstance(saved, dict) else saved!r} "
                f"vs the model's {sorted(live)}")
        return {k: _copy_into(live[k], saved[k], f"{where}.{k}")
                for k in live}
    if isinstance(live, torch.Tensor):
        from torch.distributed.tensor import DTensor

        if tuple(live.shape) != tuple(saved.shape):
            raise CheckpointMismatchError(
                f"{where}: shape {tuple(saved.shape)} vs the model's "
                f"{tuple(live.shape)}")
        with torch.no_grad():
            if isinstance(live, DTensor):
                from flexflow_tpu_torch.runtime.distributed import local_rows

                # this rank's block under the live layout
                live.to_local().copy_(local_rows(saved, live.device_mesh,
                                                 live.placements))
            else:
                live.copy_(saved)
        return live
    return saved


def restore_checkpoint(cm, path: str) -> None:
    """Restore `save_checkpoint` output into a CompiledModel of the same
    graph and optimizer; the iteration resumes. Joins an in-flight write
    to `path` first."""
    path = _ckpt_dir(path)
    wait_pending(path)
    if cm.params is None:
        cm.init()
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    _validate_fingerprint(meta, model_fingerprint(cm), path)
    with open(os.path.join(path, TREE_FILE), "rb") as f:
        tree = torch.load(f, map_location="cpu", weights_only=True)
    cm.params = _copy_into(cm.params, tree["params"], "params")
    cm.opt_state = _copy_into(cm.opt_state, tree["opt_state"], "opt_state")
    cm.state = {k: v.to(cm.device) if isinstance(v, torch.Tensor) else v
                for k, v in tree.get("state", {}).items()}
    cm._iteration = int(meta.get("iteration", 0))


# ---------------------------------------------------- pipeline checkpoints
def _split_opt_by_layer(opt_state: Dict[str, Any]):
    """An optimizer state {key: {layer: {weight: t}} or scalar} as (per
    layer {layer: {key: {weight: t}}}, the scalars {key: value}): the
    schema a restore re-keys onto any stage partition (JAX
    `_split_opt_by_layer`)."""
    per: Dict[str, Dict[str, Any]] = {}
    scalars: Dict[str, Any] = {}
    for k, v in (opt_state or {}).items():
        if isinstance(v, dict):
            for l, ws in v.items():
                per.setdefault(l, {})[k] = ws
        else:
            scalars[k] = v
    return per, scalars


def _join_opt_by_layer(per: Dict[str, Any], scalars: Dict[str, Any],
                       live: Dict[str, Any]) -> Dict[str, Any]:
    """The saved per-layer state in the live state's shape (its layers)."""
    out: Dict[str, Any] = {}
    for k, v in live.items():
        if isinstance(v, dict):
            out[k] = {l: per[l][k] for l in v}
        else:
            out[k] = scalars[k]
    return out


def save_pipeline_checkpoint(pm, path: str, commit=None,
                             retry_policy=None) -> str:
    """Checkpoint a PipelinedModel (parallel/pipeline.py; module docstring):
    every rank calls it. Synchronous: the stages write at once."""
    import torch.distributed as dist

    from flexflow_tpu_torch.runtime.resilience import run_resilient

    path = _ckpt_dir(path)
    wait_pending(path)
    scm = pm.stage_cm
    with tel.span("checkpoint/snapshot", cat="checkpoint", path=path):
        # a DTensor's full value: a collective over the stage's ranks
        host = _snapshot({"params": scm.params, "opt_state": scm.opt_state,
                          "state": scm.state})
    per, scalars = _split_opt_by_layer(host["opt_state"])
    part = {"params": host["params"], "opt_state": per, "scalars": scalars,
            "state": host["state"]}
    meta = {
        "iteration": int(pm._iteration),
        "strategy": pm.strategy.to_json(),
        "mesh_axes": dict(pm.stage_machine.mesh_axes),
        "pipeline": {"stages": pm.num_stages, "schedule": pm.schedule,
                     "cuts": list(pm.cuts)},
        "zero_sharding": scm._zero,
        "opt_schema": "per-layer",
        "fingerprint": model_fingerprint(pm),
    }
    tfile = os.path.join(path, "tree", f"stage-{pm.stage}.pt")

    def write_part():
        os.makedirs(os.path.dirname(tfile), exist_ok=True)
        with open(tfile, "wb") as f:
            torch.save(part, f)
            f.flush()
            os.fsync(f.fileno())

    def write_meta_and_commit():
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if commit is not None:
            commit()

    with tel.span("checkpoint/write", cat="checkpoint", path=path,
                  blocking=True):
        if pm.index == 0:
            run_resilient("checkpoint/write", write_part, retry_policy)
        dist.barrier()
        if dist.get_rank() == 0:
            run_resilient("checkpoint/write", write_meta_and_commit,
                          retry_policy)
        dist.barrier()
    return path


def restore_pipeline_checkpoint(pm, path: str) -> None:
    """Restore a pipeline checkpoint into a PipelinedModel of the same
    model graph: every rank reads every stage's file and keeps its own
    layers, each under its live layout, so the saving run's stage count,
    cuts and stage mesh may differ from this one's. The legacy
    stage-keyed optimizer schema and another model raise
    CheckpointMismatchError."""
    path = _ckpt_dir(path)
    wait_pending(path)
    scm = pm.stage_cm
    if scm.params is None:
        pm.init()
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    _validate_fingerprint(meta, model_fingerprint(pm), path)
    saved = meta.get("pipeline", {})
    if meta.get("opt_schema") != "per-layer":
        raise CheckpointMismatchError(
            f"checkpoint {path} uses the legacy stage-keyed optimizer "
            f"schema (stages={saved.get('stages')} cuts={saved.get('cuts')})"
            "; this version stores pipeline optimizer state per layer: "
            "re-save the checkpoint to restore it")
    if saved.get("stages") != pm.num_stages or \
            sorted(saved.get("cuts", [])) != sorted(pm.cuts):
        _LOG.info("pipeline checkpoint %s saved with stages=%s cuts=%s, "
                  "restoring onto stages=%s cuts=%s", path,
                  saved.get("stages"), saved.get("cuts"), pm.num_stages,
                  list(pm.cuts))
    params, per, scalars, state = {}, {}, {}, {}
    tdir = os.path.join(path, "tree")
    for name in sorted(os.listdir(tdir)):
        if not (name.startswith("stage-") and name.endswith(".pt")):
            continue
        with open(os.path.join(tdir, name), "rb") as f:
            part = torch.load(f, map_location="cpu", weights_only=True)
        params.update(part["params"])
        per.update(part["opt_state"])
        scalars.update(part["scalars"])
        state.update(part["state"])
    mine = {l: params[l] for l in scm.params}
    scm.params = _copy_into(scm.params, mine, "params")
    scm.opt_state = _copy_into(
        scm.opt_state, _join_opt_by_layer(per, scalars, scm.opt_state),
        "opt_state")
    names = {l.name for l in pm.stage_layers[pm.stage]}
    scm.state = {k: v.to(scm.device) if isinstance(v, torch.Tensor) else v
                 for k, v in state.items() if k.split("/")[0] in names}
    pm._iteration = int(meta.get("iteration", 0))
