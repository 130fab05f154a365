"""Durable checkpoints, preemption and auto-resume (counterpart:
flexflow_tpu/runtime/resilience.py).

- Durable snapshots commit atomically: `save_durable` writes the training
  state into a hidden `.tmp-*` directory (runtime/checkpoint.py, async by
  default), then commits: MANIFEST.json (step, format, training progress,
  the trajectory's config) fsync'd into it, one `os.replace` into
  `ckpt-<step>`, and an fsync of the root. A reader never sees a half
  written snapshot: discovery skips `.tmp-*` and any directory whose
  manifest does not validate. With an async save the commit runs at the
  end of the writer thread, so the step loop pays only for the snapshot.
- `PreemptionGuard` turns SIGTERM/SIGINT into a flag that the fit loop
  polls after each update: it then takes a final durable snapshot and
  raises `Preempted` (a SystemExit with code 0).
- `restore_auto` restores the newest committed snapshot, falling back to
  older ones when one fails to load, with the manifest's progress (epoch,
  step in epoch, loss and metric sums, history), so that
  `fit(resume="auto")` continues the same trajectory.

- Retries: `run_resilient(site, fn, policy)` checks the site's armed
  fault (runtime/faults.py) and runs `fn` under a bounded number of
  attempts with exponential backoff and a seeded jitter
  (`RetryPolicy`); a failure past the budget escalates to the caller.
  It wraps loader transfers, checkpoint writes (write and commit), fit's
  dispatch admission and the serving dispatches. Each retry emits a
  telemetry `retry` event and an exhausted budget a `retry/exhausted`
  error (telemetry.py), and both are logged, as in JAX. A commit emits
  `checkpoint/committed`, a restore `resume/restored`, a drain
  `preempt/drained`, and the failures `resume/drain_timeout` and
  `resume/snapshot_unusable` as errors.
- A PipelinedModel's snapshot (parallel/pipeline.py) is the "pipeline"
  format: its manifest carries the stage mesh and the pipeline block
  (stages, schedule, cuts; JAX `resilience.py:319-366`), every rank
  writes its stage's part of one `.tmp-<step>` directory (a name every
  rank derives from the step alone), and rank 0 commits it.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import signal
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flexflow_tpu_torch import telemetry as tel
from flexflow_tpu_torch.runtime import faults

MANIFEST = "MANIFEST.json"
_LOG = logging.getLogger("flexflow_tpu_torch")


class Preempted(SystemExit):
    """Raised by fit once a preemption signal has been drained and the
    final durable snapshot committed: a SystemExit with code 0, so an
    unhandled preemption exits cleanly (the relaunch resumes with
    resume="auto")."""

    def __init__(self, signum: int, checkpoint_path: Optional[str] = None):
        super().__init__(0)
        self.signum = signum
        self.checkpoint_path = checkpoint_path

    def __str__(self) -> str:
        return (f"training preempted by signal {self.signum}; final "
                f"snapshot: {self.checkpoint_path or '<none>'}")


# ------------------------------------------------------------------- retries
@dataclass
class RetryPolicy:
    """Bounded exponential backoff with jitter. `attempts` counts all
    tries; the jitter's rng is seeded, so a fault plan replays the same
    schedule."""

    attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.25
    seed: int = 0
    # what may be transient: RuntimeError (CUDA and injected faults),
    # filesystem and socket errors. A ValueError or TypeError is a
    # program's fault and surfaces at once.
    retryable: tuple = (RuntimeError, OSError, ConnectionError, TimeoutError)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._lock = threading.Lock()

    @staticmethod
    def from_config(cfg) -> "RetryPolicy":
        """The config's policy. The jitter's seed mixes in the pid, so the
        processes of one run (which share cfg.seed) do not retry in step;
        a test that needs a replayable schedule builds
        RetryPolicy(seed=...) itself."""
        return RetryPolicy(
            attempts=max(1, int(getattr(cfg, "retry_attempts", 3))),
            base_delay=float(getattr(cfg, "retry_base_delay", 0.05)),
            seed=int(getattr(cfg, "seed", 0)) ^ (os.getpid() << 8))

    def delay(self, attempt: int) -> float:
        d = min(self.max_delay, self.base_delay * (2.0 ** max(0, attempt - 1)))
        with self._lock:
            j = 1.0 + self.jitter * (2.0 * float(self._rng.random()) - 1.0)
        return max(0.0, d * j)


DEFAULT_POLICY = RetryPolicy()


def run_resilient(site: str, fn, policy: Optional[RetryPolicy] = None,
                  index: Optional[int] = None):
    """faults.check(site), then fn(), under the retry policy. The check
    runs before fn on every attempt, at the same operation index, so a
    retry redoes the same work; a failure past the budget is raised."""
    pol = policy or DEFAULT_POLICY
    attempt = 0
    fault_idx = index
    while True:
        try:
            if faults.active():
                if fault_idx is None:
                    fault_idx = faults.next_index(site)
                faults.check(site, index=fault_idx)
            return fn()
        except pol.retryable as e:
            attempt += 1
            if attempt >= max(1, pol.attempts):
                tel.error("retry/exhausted", site=site, attempts=attempt,
                          error=repr(e))
                _LOG.warning("%s failed after %d attempts: %r", site,
                             attempt, e)
                raise
            d = pol.delay(attempt)
            tel.retry(site, attempt, e, delay_s=d)
            _LOG.warning("transient failure at %s (attempt %d/%d, retrying "
                         "in %.3fs): %s", site, attempt, pol.attempts, d, e)
            time.sleep(d)


# -------------------------------------------------------- durable checkpoints
def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse a directory fsync; rename is atomic
    finally:
        os.close(fd)


def load_manifest(path: str) -> Optional[Dict[str, Any]]:
    """The snapshot's manifest, or None when `path` is not a committed,
    complete durable snapshot."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(man, dict) or not man.get("committed"):
        return None
    try:
        man["step"] = int(man["step"])
    except (KeyError, TypeError, ValueError):
        return None
    if not os.path.exists(os.path.join(path, "meta.json")):
        return None
    if not os.path.isdir(os.path.join(path, "tree")):
        return None
    return man


def committed_snapshots(root: str) -> List[Tuple[int, str, Dict[str, Any]]]:
    """(step, path, manifest) of every committed snapshot under `root`,
    by step."""
    out: List[Tuple[int, str, Dict[str, Any]]] = []
    if not root or not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        if not name.startswith("ckpt-"):
            continue
        path = os.path.join(root, name)
        man = load_manifest(path)
        if man is None:
            continue
        out.append((int(man["step"]), path, man))
    out.sort(key=lambda t: (t[0], t[1]))
    return out


def latest_checkpoint(root: str) -> Optional[str]:
    """The newest committed snapshot under `root`."""
    snaps = committed_snapshots(root)
    return snaps[-1][1] if snaps else None


def _prune(root: str, keep: int) -> None:
    if keep <= 0:
        return
    for _step, path, _man in committed_snapshots(root)[:-keep]:
        shutil.rmtree(path, ignore_errors=True)


def clean_stale_tmp(root: str) -> None:
    """Remove leftover `.tmp-*` directories (a killed writer's output),
    except those a writer thread of this process is still writing."""
    from flexflow_tpu_torch.runtime import checkpoint as ck

    if not root or not os.path.isdir(root):
        return
    live = set(ck.active_writes())
    for name in os.listdir(root):
        path = os.path.join(root, name)
        if name.startswith(".tmp-") and path not in live:
            shutil.rmtree(path, ignore_errors=True)


def progress_dict(epoch: int, step_in_epoch: int, loss_sum: float,
                  metric_sums: Optional[Dict[str, Any]], samples: int,
                  history: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The manifest's progress schema."""
    return {"epoch": int(epoch), "step_in_epoch": int(step_in_epoch),
            "loss_sum": float(loss_sum),
            "metric_sums": {k: float(v)
                            for k, v in (metric_sums or {}).items()},
            "samples": int(samples), "history": list(history)}


def start_state(progress: Optional[Dict[str, Any]],
                ) -> Tuple[int, int, List[Dict[str, Any]]]:
    """(start_epoch, step_in_epoch, history) of a restored snapshot's
    progress; (0, 0, []) on a fresh start."""
    if not progress:
        return 0, 0, []
    return (int(progress.get("epoch", 0)),
            int(progress.get("step_in_epoch", 0)),
            [dict(h) for h in progress.get("history", [])])


def effective_config(model, batch_size: Optional[int] = None,
                     accum_steps: Optional[int] = None) -> Dict[str, int]:
    """The knobs that define what the progress counters mean: the seed
    (data order), and the fit call's batch size and accum_steps."""
    cfg = model.cfg
    return {
        "seed": int(getattr(cfg, "seed", 0)),
        "batch_size": int(batch_size if batch_size is not None
                          else getattr(cfg, "batch_size", 0)),
        "accum_steps": int(accum_steps if accum_steps is not None
                           else getattr(cfg, "accum_steps", 1)),
    }


def save_durable(model, root: str, progress: Optional[Dict[str, Any]] = None,
                 block: Optional[bool] = None, keep: int = 0,
                 config: Optional[Dict[str, int]] = None,
                 policy: Optional[RetryPolicy] = None) -> str:
    """Atomic-commit durable snapshot of a CompiledModel into `root`.
    Returns the committed path (with block=False the commit is pending
    until `wait_pending()` or the exit drain joins the writer). The write
    and the commit run as one `checkpoint/write` operation under
    `policy`."""
    from flexflow_tpu_torch.runtime import checkpoint as ck

    root = os.path.abspath(root)
    os.makedirs(root, exist_ok=True)
    # one writer at a time under a root: a snapshot of the same step (the
    # end-of-fit one after a periodic one) commits after the other
    for p in ck.active_writes(os.path.join(root, ".tmp-")):
        ck.wait_pending(p)
    step = int(model._iteration)
    pipelined = hasattr(model, "stage_cm")
    if pipelined:
        # every rank writes into it: a name from the step alone (the
        # pipelined save is synchronous, so no two writers share it)
        tmp = os.path.join(root, f".tmp-{step:010d}")
    else:
        tag = f"{os.getpid():x}-{os.urandom(3).hex()}"
        tmp = os.path.join(root, f".tmp-{step:010d}-{tag}")
    final = os.path.join(root, f"ckpt-{step:010d}")
    manifest = {
        "version": 1,
        "committed": True,
        "step": step,
        "format": "pipeline" if pipelined else "flat",
        "mesh_axes": dict(model.stage_machine.mesh_axes if pipelined
                          else model.strategy.mesh_axes),
        "progress": dict(progress or {}),
        "config": dict(config) if config else effective_config(model),
    }
    if pipelined:
        manifest["pipeline"] = {"stages": model.num_stages,
                                "schedule": model.schedule,
                                "cuts": list(model.cuts)}

    def commit():
        if not os.path.isdir(tmp) and os.path.isdir(final):
            return  # a retry after the rename landed: already committed
        mpath = os.path.join(tmp, MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f, default=float)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        old = None
        if os.path.exists(final):
            # a re-save of the same step: move the committed one aside
            # first, so that no moment leaves only a .tmp-* on disk
            old = final + ".old"
            shutil.rmtree(old, ignore_errors=True)
            os.replace(final, old)
        os.replace(tmp, final)
        _fsync_dir(root)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        tel.event("checkpoint/committed", cat="checkpoint", path=final,
                  step=step)
        _prune(root, keep)

    if pipelined:
        ck.save_pipeline_checkpoint(model, tmp, commit=commit,
                                    retry_policy=policy)
        return final
    if block is None:
        block = not getattr(model.cfg, "async_checkpoint", True)
    ck.save_checkpoint(model, tmp, block=block, commit=commit,
                       retry_policy=policy)
    return final


def _validate_resume_config(model, man: Dict[str, Any], path: str,
                            expected: Optional[Dict[str, int]] = None) -> None:
    """Resuming under another seed, batch size or accum_steps would skip
    or repeat samples: refuse it."""
    saved = dict(man.get("config") or {})
    if not saved:
        return
    live_all = expected or effective_config(model)
    diffs = []
    for key in ("seed", "batch_size", "accum_steps"):
        live = live_all[key]
        if key in saved and int(saved[key]) != live:
            diffs.append(f"{key}: checkpoint={saved[key]} run={live}")
    if diffs:
        raise ValueError(
            f"cannot resume from {path}: the snapshot's training config "
            "differs in trajectory-defining knobs (" + ", ".join(diffs)
            + "); relaunch with the saved values")


def _drain_before_resume(ck) -> None:
    """Join pending writes before discovery, for at most
    checkpoint.DRAIN_TIMEOUT; past it, resume from what is committed. A
    failed write re-raises."""
    try:
        ck.wait_pending(timeout=ck.DRAIN_TIMEOUT)
    except TimeoutError as e:
        tel.error("resume/drain_timeout", error=repr(e))
        _LOG.warning("pending checkpoint write(s) did not drain in %ss "
                     "(%s); resuming from the newest already-committed "
                     "snapshot", ck.DRAIN_TIMEOUT, e)


def restore_auto(model, resume: str, root: str = "", verbose: bool = False,
                 expected_config: Optional[Dict[str, int]] = None,
                 ) -> Optional[Dict[str, Any]]:
    """Restore the newest usable durable snapshot. resume="auto" scans
    `root` newest first and skips snapshots that fail to load; a path
    restores that snapshot (or the newest under it), and a plain
    checkpoint directory restores with empty progress. Returns the
    manifest's progress, or None on a fresh start. A
    CheckpointMismatchError (another model) is raised, not skipped."""
    from flexflow_tpu_torch.runtime import checkpoint as ck

    _drain_before_resume(ck)
    if resume == "auto":
        if not root:
            raise ValueError('fit(resume="auto") needs a checkpoint root: '
                             "set checkpoint_dir / --checkpoint-dir")
        cands = committed_snapshots(root)[::-1]
    else:
        p = os.path.abspath(resume)
        man = load_manifest(p)
        if man is not None:
            cands = [(int(man["step"]), p, man)]
        elif os.path.exists(os.path.join(p, "meta.json")):
            model.load_checkpoint(p)
            return {}
        else:
            cands = committed_snapshots(p)[::-1]
            if not cands:
                raise FileNotFoundError(
                    f"resume={resume!r}: no committed durable snapshot "
                    f"found at or under {p}")
    for step, path, man in cands:
        _validate_resume_config(model, man, path, expected_config)
        try:
            model.load_checkpoint(path)
        except ck.CheckpointMismatchError:
            raise
        except Exception as e:
            tel.error("resume/snapshot_unusable", path=path, error=repr(e))
            _LOG.warning("durable snapshot %s unusable (%s); falling back "
                         "to the previous one", path, e)
            continue
        tel.event("resume/restored", cat="checkpoint", path=path, step=step)
        _LOG.info("resumed from %s (step %d)", path, step)
        if verbose:
            print(f"[resume] restored {path} (step {step})")
        return dict(man.get("progress") or {})
    if resume == "auto":
        _LOG.info("resume='auto': no usable snapshot under %s; fresh start",
                  root)
        return None
    raise FileNotFoundError(f"resume={resume!r}: no usable snapshot")


# ----------------------------------------------------------------- preemption
class PreemptionGuard:
    """SIGTERM/SIGINT set a flag that the fit loop polls; the drain runs
    from the loop. Installs only on the main thread (elsewhere it stays
    inert). A second signal restores the previous handlers and re-raises
    the signal, so a stuck drain can still be interrupted."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.requested = False
        self.signum: Optional[int] = None
        self._prev: Dict[int, Any] = {}
        self._installed = False

    def _handler(self, signum, frame):
        if self.requested:
            self.uninstall()
            signal.raise_signal(signum)
            return
        self.requested = True
        self.signum = signum

    def install(self) -> "PreemptionGuard":
        try:
            for s in self.SIGNALS:
                self._prev[s] = signal.signal(s, self._handler)
            self._installed = True
        except ValueError:  # not the main thread
            self._prev.clear()
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, h in self._prev.items():
            try:
                signal.signal(s, h)
            except ValueError:
                pass
        self._prev.clear()
        self._installed = False


# ------------------------------------------------------------ fit integration
class FitResilience:
    """What fit needs in one handle: the snapshot policy (every N updates
    or every T seconds), the preemption guard, and resume. Built per fit
    call; None when neither a checkpoint root nor a resume is set.

    Over a process group of several ranks (a mesh or a pipeline: one
    process a rank, where JAX has one controller) every rank must snapshot
    the same updates and drain together: once an update the ranks agree
    by one max all-reduce of a small host tensor (`_agreed`) on the
    preemption flag (a SIGTERM on any one rank drains every rank), on
    whether a snapshot is due (the step count, alike everywhere, and rank
    0's clock alone for `every_secs`) and on whether any rank's previous
    async write is still running (then no rank starts the next)."""

    def __init__(self, model, root: str, every_steps: int, every_secs: float,
                 resume: str, keep: int, policy: Optional[RetryPolicy] = None):
        self.model = model
        # the retry policy of the fit's transfers, writes and dispatches
        self.policy = policy or RetryPolicy.from_config(model.cfg)
        self.root = os.path.abspath(root) if root else ""
        self.every_steps = max(0, int(every_steps))
        self.every_secs = max(0.0, float(every_secs))
        self.resume_spec = resume
        self.keep = int(keep)
        self.guard = PreemptionGuard()
        self.effective: Dict[str, int] = {}
        self._last_iter = int(model._iteration)
        self._last_time = time.monotonic()

    @staticmethod
    def build(model, resume=None, checkpoint_dir=None, every_steps=None,
              every_secs=None) -> Optional["FitResilience"]:
        """Per-call values override the config's (None = the config's)."""
        cfg = model.cfg
        resume = cfg.resume if resume is None else (resume or "")
        root = cfg.checkpoint_dir if checkpoint_dir is None else checkpoint_dir
        es = cfg.checkpoint_every_steps if every_steps is None else every_steps
        esec = cfg.checkpoint_every_secs if every_secs is None else every_secs
        if not root and not resume:
            return None
        return FitResilience(model, root or "", es or 0, esec or 0.0,
                             resume, getattr(cfg, "keep_checkpoints", 3),
                             RetryPolicy.from_config(cfg))

    def set_effective(self, batch_size: Optional[int],
                      accum_steps: Optional[int]) -> None:
        """The fit call's batch size and accum_steps, stamped into every
        manifest and matched on resume."""
        self.effective = effective_config(self.model, batch_size,
                                          accum_steps)

    def resume_now(self, verbose: bool = False) -> Optional[Dict[str, Any]]:
        from flexflow_tpu_torch.runtime import checkpoint as ck

        if not self.resume_spec:
            if self.root:
                _drain_before_resume(ck)
                clean_stale_tmp(self.root)
            return None
        progress = restore_auto(self.model, self.resume_spec, self.root,
                                verbose=verbose,
                                expected_config=self.effective or None)
        clean_stale_tmp(self.root)
        self._last_iter = int(self.model._iteration)
        self._last_time = time.monotonic()
        return progress

    def due(self) -> bool:
        if not self.root or not (self.every_steps or self.every_secs):
            return False
        if self.every_steps and \
                int(self.model._iteration) - self._last_iter >= self.every_steps:
            return True
        return bool(self.every_secs) and self._clock_due()

    def _clock_due(self) -> bool:
        """The time trigger: over a group only rank 0's clock says."""
        from flexflow_tpu_torch.runtime.distributed import rank

        return (not self._grouped() or rank() == 0) and \
            time.monotonic() - self._last_time >= self.every_secs

    @staticmethod
    def _grouped() -> bool:
        from flexflow_tpu_torch.runtime.distributed import world_size

        return world_size() > 1

    def _agreed(self, *flags) -> List[bool]:
        """Each flag's max over the ranks of the group (one all-reduce of a
        host tensor, a collective every rank makes at the same update);
        the flags as they are on one process."""
        if not self._grouped():
            return [bool(f) for f in flags]
        import torch
        import torch.distributed as dist

        from flexflow_tpu_torch.runtime.distributed import host_group

        t = torch.tensor([float(bool(f)) for f in flags], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
        return [bool(v) for v in t.tolist()]

    def save(self, progress: Dict[str, Any],
             block: Optional[bool] = None) -> str:
        path = save_durable(self.model, self.root, progress, block=block,
                            keep=self.keep, config=self.effective or None,
                            policy=self.policy)
        self._last_iter = int(self.model._iteration)
        self._last_time = time.monotonic()
        return path

    def install_guard(self) -> None:
        """Arm the guard only when there is a root to save into: without
        one a converted signal would exit 0 with nothing saved."""
        if self.root:
            self.guard.install()

    def maybe_checkpoint(self, make_progress) -> None:
        """After each update: on a preemption request, the final snapshot
        and `Preempted`; when a periodic snapshot is due, an async save,
        skipped while the previous one is still being written (it fires
        once that writer is done)."""
        from flexflow_tpu_torch.runtime import checkpoint as ck

        def busy():
            return bool(self.root) and bool(
                ck.active_writes(os.path.join(self.root, ".tmp-")))
        if self._grouped():
            requested, due, busy_now = self._agreed(
                self.guard.requested, self.due(), busy())
        else:
            requested, due = self.guard.requested, self.due()
            busy_now = not requested and due and busy()
        if not (requested or due) or (not requested and busy_now):
            return
        prog = make_progress()
        if requested:
            self.preempt_now(prog)
        self.save(prog)

    def epoch_end(self, epoch: int, history: List[Dict[str, Any]]) -> None:
        """A signal that landed after the epoch's last update drains here,
        with the next epoch's start as the progress."""
        if self._agreed(self.guard.requested)[0]:
            self.preempt_now(progress_dict(epoch + 1, 0, 0.0, {}, 0,
                                           history))

    def final_save(self, epochs: int, history: List[Dict[str, Any]]) -> None:
        """End-of-fit snapshot: a relaunch with resume="auto" returns the
        stored history instead of training the last epoch again."""
        if self.root:
            self.save(progress_dict(epochs, 0, 0.0, {}, 0, history))

    @property
    def preempt_requested(self) -> bool:
        return self.guard.requested

    def preempt_now(self, progress: Dict[str, Any]):
        """The final snapshot (synchronous: the process is about to exit)
        and the clean-exit raise."""
        path = self.save(progress, block=True) if self.root else None
        signum = self.guard.signum or signal.SIGTERM
        tel.event("preempt/drained", cat="preempt", signum=signum,
                  checkpoint=path)
        _LOG.warning("preempted by signal %s: drained, snapshot %s; "
                     "exiting cleanly", signum, path or "<no checkpoint dir>")
        raise Preempted(signum, path)
