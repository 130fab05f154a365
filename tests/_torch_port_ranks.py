"""A group of spawned ranks for the port's multi-process CPU tests.

`RankGroup(world, module)` spawns `world` processes once; each starts a
gloo process group (flexflow_tpu_torch.runtime.distributed) and then runs
the cases the test asks for: `group.run("case_name", *args)` calls
`module.case_name(*args)` on every rank (the rank code lives in the test
module, which must import no JAX at its top) and returns the per-rank
results in rank order. A watchdog bounds every case: a rank that raises
fails the case with its traceback, and a case that does not finish in
`timeout` seconds (a wedged collective) fails with the ranks still out.
Either way the group is killed, and the next case of the file spawns a
new one (`shared`).
"""

import importlib
import queue
import socket
import time
import traceback

import torch.multiprocessing as mp

CASE_TIMEOUT_S = 90.0
START_TIMEOUT_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _serve(rank, world, port, module, cmd, res):
    """A rank's loop: start the group, then run cases until told to stop."""
    try:
        import torch

        torch.set_num_threads(1)
        from flexflow_tpu_torch.runtime.distributed import init_distributed

        init_distributed(f"localhost:{port}", world, rank, backend="gloo")
        mod = importlib.import_module(module)
        res.put((rank, "ready", None))
    except Exception:  # reported: the parent fails the case with it
        res.put((rank, "error", traceback.format_exc()))
        return
    while True:
        case, args = cmd.get()
        if case is None:
            break
        try:
            res.put((rank, "ok", getattr(mod, case)(*args)))
        except Exception:  # reported: the parent fails the case with it
            res.put((rank, "error", traceback.format_exc()))
    import torch.distributed as dist

    dist.destroy_process_group()


# a port free when `_free_port` picks it can be taken by another process
# before rank 0 binds it: the group then starts again on a fresh port
START_ATTEMPTS = 3


class RankGroup:
    def __init__(self, world: int, module: str):
        for attempt in range(START_ATTEMPTS):
            try:
                self._start(world, module)
                return
            except AssertionError as e:
                if "EADDRINUSE" not in str(e) or \
                        attempt == START_ATTEMPTS - 1:
                    raise

    def _start(self, world: int, module: str):
        ctx = mp.get_context("spawn")
        self.world = world
        self.cmd = [ctx.Queue() for _ in range(world)]
        self.res = ctx.Queue()
        port = _free_port()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, port, module, self.cmd[r],
                                        self.res))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.alive = True
        self._collect("start", START_TIMEOUT_S)

    def _collect(self, case, timeout):
        out = {}
        deadline = time.monotonic() + timeout
        while len(out) < self.world:
            left = deadline - time.monotonic()
            try:
                rank, kind, val = self.res.get(timeout=max(0.05, left))
            except queue.Empty:
                self.kill()
                raise AssertionError(
                    f"case {case}: ranks {sorted(set(range(self.world)) - set(out))} "
                    f"did not finish in {timeout:.0f} s (a wedged collective?)")
            if kind == "error":
                self.kill()
                raise AssertionError(f"case {case}, rank {rank}:\n{val}")
            out[rank] = val
        return [out[r] for r in range(self.world)]

    def run(self, case: str, *args, timeout: float = CASE_TIMEOUT_S):
        for q in self.cmd:
            q.put((case, args))
        return self._collect(case, timeout)

    def kill(self):
        self.alive = False
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(5)

    def close(self):
        if self.alive:
            for q in self.cmd:
                q.put((None, ()))
            for p in self.procs:
                p.join(10)
        self.kill()


_GROUPS = {}


def shared(world: int, module: str) -> RankGroup:
    """The file's group of `world` ranks, spawned at its first case and
    again after a case killed it."""
    g = _GROUPS.get((world, module))
    if g is None or not g.alive:
        g = _GROUPS[(world, module)] = RankGroup(world, module)
    return g


def close_all() -> None:
    for g in _GROUPS.values():
        g.close()
    _GROUPS.clear()


