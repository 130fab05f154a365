"""Dataloader (counterpart: flexflow_tpu/runtime/dataloader.py).

`SingleDataLoader` keeps the dataset in host numpy arrays and yields one
batch at a time, shuffled by `np.random.default_rng(seed)` exactly as the
JAX package's loader shuffles, so both packages draw the same batches in
the same order. Only full batches are drawn (the JAX loader's default).
`group_microbatches` stacks N consecutive batches for gradient
accumulation, as the JAX package's does. `epoch(skip_batches)` and
`advance_epochs` are the resume cursor, with the JAX loader's rng
consumption.

`prefetch_multi` overlaps the host-to-device copy of the next batches
with the current step, and feeds the fused K-step dispatch
(`CompiledModel.make_multi_step`): a daemon thread stacks K consecutive
batches into (K, ...) arrays, copies each group into pinned host memory,
then to the device on a side CUDA stream, and records an event; the
consumer's stream waits on that event, and each tensor is
`record_stream`ed on the consumer's stream so the allocator does not hand
its memory out again while the step still reads it. Groups are tagged
"k"; the epoch's tail and the batches of a group broken by a ragged batch
go singly, tagged "1". Every copy runs as one `dataloader/transfer`
operation under the retry policy (runtime/resilience.py). On the CPU the
same thread and queue run without streams. `prefetch_to_device` is its
k = 1 case, as in JAX.

Over a mesh each rank copies only its own rows: `rows(kind, i, array)`
cuts batch array i (the inputs, then the label) on the host before the
copy, and `wrap(kind, dx, dy, shapes)` makes the device blocks the
DTensors of the full `shapes` (compiler/compile.py `_host_rows`).

A batch is gathered by numpy's index. The native core's `batch_gather`
(flexflow_tpu_torch/native), which the JAX loader takes, is not used here:
on the H100 machine's host it ran slower than numpy's index at a GPT-2
token batch and at a ResNet-50 image batch (chip_smoke.py 16d; PERF.md).
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch import telemetry as tel


class SingleDataLoader:
    def __init__(self, xs: Sequence[np.ndarray], y: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        self.xs = [np.asarray(x) for x in xs]
        self.y = np.asarray(y)
        n = self.y.shape[0]
        for x in self.xs:
            if x.shape[0] != n:
                raise ValueError("all arrays must share the sample dim "
                                 f"({x.shape[0]} vs {n})")
        self.num_samples = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    @property
    def num_batches(self) -> int:
        return self.num_samples // self.batch_size

    def epoch(self, skip_batches: int = 0,
              ) -> Iterator[Tuple[List[np.ndarray], np.ndarray]]:
        """One pass, shuffled when `shuffle` (one permutation per epoch).
        `skip_batches` resumes mid-epoch: the full permutation is drawn (the
        rng moves as in an epoch without a skip), and the leading batches
        are never gathered."""
        order = np.arange(self.num_samples)
        if self.shuffle:
            self.rng.shuffle(order)
        for b in range(max(0, int(skip_batches)), self.num_batches):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield [x[idx] for x in self.xs], self.y[idx]

    def advance_epochs(self, n: int) -> None:
        """Move the shuffle rng past `n` epochs without touching the data,
        as `epoch()` moves it (one shuffle an epoch)."""
        for _ in range(max(0, int(n))):
            if self.shuffle:
                self.rng.shuffle(np.arange(self.num_samples))


def _batch_shapes(xs, y):
    return tuple(np.asarray(x).shape for x in xs) + (np.asarray(y).shape,)


def group_microbatches(it, n: int):
    """Stack `n` consecutive (inputs, label) batches into (n, ...) arrays,
    one item per accumulating train step. A group that cannot be completed
    with batches of one shape is dropped: the trailing short group, and
    any group broken by a batch of another shape."""
    if n <= 1:
        yield from it
        return
    buf = []
    for xs, y in it:
        if buf and _batch_shapes(xs, y) != _batch_shapes(*buf[0]):
            buf = []  # a ragged batch: the partial group cannot stack
        buf.append((xs, y))
        if len(buf) == n:
            yield ([np.stack([b[0][i] for b in buf])
                    for i in range(len(buf[0][0]))],
                   np.stack([b[1] for b in buf]))
            buf = []


# how long the consumer waits for the worker to end after it stops early
PREFETCH_JOIN_S = 10.0


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def prefetch_to_device(it, device, depth: int = 2, retry_policy=None,
                       rows=None, wrap=None):
    """Yield the (inputs, label) batches of `it` as tensors on `device`,
    copied `depth` batches ahead: `prefetch_multi` at k = 1, untagged."""
    gen = prefetch_multi(it, 1, device, depth=depth,
                         retry_policy=retry_policy, rows=rows, wrap=wrap)
    try:
        for _kind, dx, dy in gen:
            yield dx, dy
    finally:
        gen.close()


def prefetch_multi(it, k: int, device, depth: int = 2, retry_policy=None,
                   rows=None, wrap=None):
    """Yield ("k", dx, dy) for each group of `k` consecutive batches of
    `it`, stacked to (k, ...) and copied to `device` as one transfer, and
    ("1", dx, dy) for the batches that go singly: the epoch's tail (fewer
    than k left), and a partial group flushed when a batch of another
    shape arrives. With k <= 1 every batch goes singly. A daemon thread
    copies `depth` items ahead (see the module docstring); each copy is a
    `dataloader/transfer` operation under `retry_policy`. An exception in
    the worker reaches the consumer after the items queued ahead of it.
    When the consumer stops early (a `break`, an exception, `close()`),
    the worker stops too and is joined."""
    from flexflow_tpu_torch.runtime.resilience import run_resilient

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        # the worker thread selects the device by index
        device = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.Stream(device) if cuda else None
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(1, int(depth)))
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue_mod.Full:
                continue
        return False

    # telemetry, read once: a span a transfer and the queue's depth,
    # from the worker thread
    rec = tel.enabled()

    def put_counted(item) -> bool:
        ok = put(item)
        if rec and ok:
            tel.counter("dataloader/queue_depth", q.qsize(),
                        cat="dataloader")
        return ok

    def move(kind, xs, y):
        t0 = tel.now_us() if rec else 0.0

        arrays = (*xs, y)
        shapes = [tuple(np.shape(a)) for a in arrays]
        if rows is not None:
            arrays = [rows(kind, i, a) for i, a in enumerate(arrays)]

        def once():
            host = [_as_tensor(a) for a in arrays]
            if not cuda:
                return host[:-1], host[-1], None, shapes
            with torch.cuda.stream(stream):
                dev = [h.pin_memory().to(device, non_blocking=True)
                       for h in host]
                ev = torch.cuda.Event()
                ev.record(stream)
            return dev[:-1], dev[-1], ev, shapes

        out = (kind,) + run_resilient("dataloader/transfer", once,
                                      retry_policy)
        if rec:
            tel.record("dataloader/transfer", t0, cat="dataloader")
        return out

    def worker():
        try:
            if cuda:
                torch.cuda.set_device(device)
            buf: List = []
            for xs, y in it:
                if k <= 1:
                    if not put_counted(move("1", xs, y)):
                        return
                    continue
                if buf and _batch_shapes(xs, y) != _batch_shapes(*buf[0]):
                    # a ragged batch: the partial group goes singly
                    for bxs, by in buf:
                        if not put_counted(move("1", bxs, by)):
                            return
                    buf = []
                buf.append((xs, y))
                if len(buf) == k:
                    sx = [np.stack([b[0][i] for b in buf])
                          for i in range(len(buf[0][0]))]
                    sy = np.stack([b[1] for b in buf])
                    buf = []
                    if not put_counted(move("k", sx, sy)):
                        return
            for xs, y in buf:  # the tail: fewer than k batches left
                if not put_counted(move("1", xs, y)):
                    return
            put(done)
        except BaseException as e:  # forwarded to the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True, name="ff-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            kind, dx, dy, ev, shapes = item
            if ev is not None:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(ev)
                for x in (*dx, dy):
                    x.record_stream(cur)
            if wrap is not None:
                dx, dy = wrap(kind, dx, dy, shapes)
            yield kind, dx, dy
    finally:
        stop.set()
        t.join(PREFETCH_JOIN_S)
