"""Measured per-op costs — the on-device microbenchmark path
(counterpart: flexflow_tpu/search/measure.py).

Reference analog: `Op::inner_measure_operator_cost` (src/runtime/model.cu:
38-74): run the op's kernels on a real device with warm-up and repeats
under cudaEvent timing, cached by (op params, machine view)
(`Simulator::measure_operator_cost`, src/runtime/simulator.cc:537-560).

`MeasuredCost` runs an op's PyTorch lowering (ops/) at the shard-local
shapes of a candidate's layout on one device, in the compute dtype the
training step casts to (compiler/lowering.py's policy), and times the
forward (under `torch.no_grad`) and forward + backward (autograd, wrt the
weights and the floating inputs) separately; bwd = total - fwd. On a CUDA
device each call is timed by CUDA events after warm-up, with the L2 cache
flushed and the device held busy by a spin while the host enqueues the
call, so the events time the device's work; a measurement is the median
of `windows` windows of `repeats` calls. On the CPU it is timed by
`time.perf_counter` (for tests).

Measurements persist in one JSON store per machine fingerprint and
compute dtype under `cache_dir` (`measured-<fingerprint>-<dtype>.json`,
keyed by the repr of
(params key, output layout, weight layout), as in the JAX package); its
content hash is the strategy cache's calibration fingerprint. A
measurement that raises propagates: a measured search never prices an op
by the analytic model in its place.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import TYPE_CHECKING, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.compiler.lowering import cast_dtype, cast_exempt
from flexflow_tpu_torch.core.layer import Layer
from flexflow_tpu_torch.device import resolve_device
from flexflow_tpu_torch.ops.op_type import OperatorType
from flexflow_tpu_torch.ops.registry import LoweringCtx, get_op_def
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.parallel.ptensor import ParallelTensor
from flexflow_tpu_torch.search import cost_model as cm

if TYPE_CHECKING:
    from flexflow_tpu_torch.search.candidates import Candidate

# bytes zeroed before every timed call on the card: over the H100's 50 MB
# L2, so each call finds its inputs in HBM
_FLUSH_BYTES = 64 * 2**20
# the minimum spin before each timed call, in cycles (~1 ms on an H100)
_HOLD_CYCLES = 2_000_000


def _shard_shape(spec, dims, machine):
    return ParallelTensor.build(spec, list(dims or []), machine).shard_shape


def _local_layer(layer: Layer, weight_shapes: Dict[str, tuple]) -> Layer:
    """The layer as one device of the layout runs it: attention with the
    heads its shard of wq holds (head-parallel layouts split the heads).
    The other lowerings take their widths from the tensors."""
    if layer.op_type is not OperatorType.MULTIHEAD_ATTENTION:
        return layer
    p = dict(layer.params)
    head_dim = p["embed_dim"] // p["num_heads"]
    local = weight_shapes["wq"][1]
    p["embed_dim"], p["num_heads"] = local, local // head_dim
    local_layer = copy.copy(layer)  # a copy, not a new guid
    local_layer.params = p
    return local_layer


class MeasuredCost:
    def __init__(self, machine: MachineSpec, repeats: int = 5,
                 warmup: int = 2, windows: int = 3,
                 cache_dir: Optional[str] = None, device=None,
                 compute_dtype: str = "bfloat16", forward_only: bool = False,
                 state_fn: Optional[Callable[[Layer, int], dict]] = None,
                 enable_fusion: bool = True):
        # forward_only: time no backward (serving attribution; bwd is 0).
        # state_fn(layer, rows): the lowering state an op reads (a serving
        # decode attention's paged cache), else none; `layer` as one
        # device runs it (its heads), `rows` its first input's rows there
        self.forward_only = bool(forward_only)
        self.state_fn = state_fn
        # the compile's --fusion: False times the ops' plain routes, as
        # the compiled program runs them (the attention's einsum path)
        self.enable_fusion = bool(enable_fusion)
        self.machine = machine
        self.repeats = repeats
        self.warmup = warmup
        self.windows = max(1, windows)
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.cache: Dict[Tuple, Tuple[float, float]] = {}
        self._flush = None
        if cache_dir is None:
            cache_dir = os.environ.get("FF_MEASURE_CACHE_DIR", "")
        self.cache_path: Optional[str] = None
        if cache_dir:
            from flexflow_tpu_torch.search import memo

            self.cache_path = os.path.join(
                os.path.expanduser(cache_dir),
                f"measured-{memo.machine_fingerprint(machine)}"
                f"-{compute_dtype}{'' if enable_fusion else '-nofusion'}"
                ".json")
            self._load_disk()

    # ------------------------------------------------------------ store
    def _load_disk(self):
        # keys persist as repr() of the in-memory tuple key — enums, shapes
        # and dtypes all repr canonically, so the string is process-stable
        self._disk: Dict[str, list] = {}
        self._dirty: Dict[str, list] = {}  # keys THIS process measured
        self._disk_mtime = 0.0
        try:
            with open(self.cache_path) as f:
                self._disk = dict(json.load(f))
            self._disk_mtime = os.path.getmtime(self.cache_path)
        except (OSError, ValueError):
            pass

    def _persist(self, key, val):
        if not self.cache_path:
            return
        try:
            os.makedirs(os.path.dirname(self.cache_path), exist_ok=True)
            # merge-on-write: overlay only the keys this process measured
            # onto a re-read of the file, so a concurrent measurer's entries
            # survive; the mtime gate skips the re-read when nobody else
            # wrote
            self._dirty[repr(key)] = list(val)
            try:
                mtime = os.path.getmtime(self.cache_path)
            except OSError:
                mtime = 0.0
            if mtime != self._disk_mtime:
                try:
                    with open(self.cache_path) as f:
                        current = dict(json.load(f))
                except (OSError, ValueError):
                    current = {}
                current.update(self._dirty)
                self._disk = current
            else:
                self._disk[repr(key)] = list(val)
            tmp = self.cache_path + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self._disk, f, indent=0, sort_keys=True)
            os.replace(tmp, self.cache_path)
            self._disk_mtime = os.path.getmtime(self.cache_path)
        except OSError:
            self.cache_path = None  # unwritable dir: degrade to in-memory

    # ------------------------------------------------------------ costs
    def op_times(self, layer: Layer, cand: "Candidate") -> Tuple[float, float]:
        """(fwd_seconds, bwd_seconds), measured independently."""
        key = (layer.params_key(),
               tuple(tuple(map(str, d)) for d in cand.out_dims),
               tuple(sorted((w, tuple(map(str, d)))
                            for w, d in cand.weight_dims.items())))
        if key in self.cache:
            return self.cache[key]
        if self.cache_path:
            hit = self._disk.get(repr(key))
            if hit is not None:
                self.cache[key] = (float(hit[0]), float(hit[1]))
                return self.cache[key]
        fwd, bwd = self._measure(layer, cand)
        self._persist(key, (fwd, bwd))
        self.cache[key] = (fwd, bwd)
        return fwd, bwd

    def op_time(self, layer: Layer, cand: "Candidate") -> float:
        fwd, bwd = self.op_times(layer, cand)
        from flexflow_tpu_torch.search.candidates import _batch_axes

        return fwd + bwd + cand.extra_comm + cm.grad_sync_time(
            layer.weight_specs, cand.weight_dims, self.machine,
            _batch_axes(self.machine))

    def op_time_fwd(self, layer: Layer, cand: "Candidate") -> float:
        """The forward only (serving attribution): the measured forward
        plus the candidate's inherent collectives; no backward and no
        gradient sync."""
        fwd, _bwd = self.op_times(layer, cand)
        return fwd + cand.extra_comm

    # ----------------------------------------------------------- timing
    def _time(self, fn) -> float:
        """Seconds of one fn() call: the median over `windows` windows of
        the mean of `repeats` calls."""
        if self.device.type == "cuda":
            return self._time_cuda(fn)
        fn()
        for _ in range(self.warmup):
            fn()
        ts = []
        for _ in range(self.windows):
            t0 = time.perf_counter()
            for _ in range(self.repeats):
                fn()
            ts.append((time.perf_counter() - t0) / self.repeats)
        return float(np.median(ts))

    def _time_cuda(self, fn) -> float:
        dev = self.device
        if self._flush is None:
            self._flush = torch.empty(_FLUSH_BYTES, dtype=torch.uint8,
                                      device=dev)
        # warm-up, and the host's enqueue time of one call: the spin before
        # each timed call covers twice that, so the events see no host gap
        enqueue = []
        fn()
        for _ in range(self.warmup):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize(dev)
        hold = max(_HOLD_CYCLES,
                   int(2e3 * float(np.median(enqueue)) * _HOLD_CYCLES))
        ts = []
        for _ in range(self.windows):
            total = 0.0
            for _ in range(self.repeats):
                self._flush.zero_()
                torch.cuda._sleep(hold)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                total += a.elapsed_time(b) / 1e3
            ts.append(total / self.repeats)
        return float(np.median(ts))

    def _measure(self, layer: Layer, cand: "Candidate") -> Tuple[float, float]:
        machine, dev = self.machine, self.device
        cast_to = cast_dtype(self.compute_dtype)
        exempt = cast_exempt([layer]).get(layer.name, ())
        rng = np.random.default_rng(0)
        ins = []
        for i, tin in enumerate(layer.inputs):
            shp = _shard_shape(tin.spec, cand.in_dims[i]
                               if i < len(cand.in_dims) else None, machine)
            dt = tin.spec.dtype.torch_dtype
            if dt.is_floating_point:
                x = torch.from_numpy(rng.normal(size=shp).astype(np.float32))
                x = x.to(dev, cast_to or dt)
            else:
                x = torch.from_numpy(rng.integers(0, 2, size=shp)).to(dev, dt)
            ins.append(x)
        weights = {}
        for w, spec in layer.weight_specs.items():
            shp = _shard_shape(spec, cand.weight_dims.get(w), machine)
            x = torch.from_numpy(rng.normal(size=shp).astype(np.float32))
            dt = spec.dtype.torch_dtype
            weights[w] = x.to(dev, cast_to if cast_to is not None
                              and w not in exempt else dt)
        local = _local_layer(layer, {w: tuple(t.shape)
                                     for w, t in weights.items()})
        lower = get_op_def(layer.op_type).lower
        state = (self.state_fn(local, int(ins[0].shape[0]))
                 if self.state_fn is not None else {})

        def apply():
            return lower(local, ins, weights, LoweringCtx(
                state=state, training=False, device=dev,
                compute_dtype=cast_to, enable_fusion=self.enable_fusion))

        def run_fwd():
            with torch.no_grad():
                apply()

        fwd = self._time(run_fwd)
        if self.forward_only:
            return fwd, 0.0
        # backward: autograd of the lowering wrt (weights, float inputs);
        # bwd = (forward + backward) time minus the forward time
        diff = [t for t in list(weights.values()) + ins
                if t.is_floating_point()]
        for t in diff:
            t.requires_grad_(True)
        with torch.no_grad():
            has_float_out = any(o.is_floating_point() for o in apply())
        if not (diff and has_float_out):
            return fwd, 0.0

        def run_grad():
            outs = apply()
            loss = sum(o.float().sum() for o in outs if o.is_floating_point())
            torch.autograd.grad(loss, diff)

        total = self._time(run_grad)
        return fwd, max(0.0, total - fwd)
