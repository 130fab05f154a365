"""K train steps as one CUDA graph: the card's counterpart of the JAX
package's one-dispatch `make_multi_step` (a jitted `fori_loop`,
flexflow_tpu/compiler/compile.py:741-796).

`GraphedSteps(cm, n)` is what `CompiledModel.make_multi_step(n)` returns
on a CUDA device. Its first call captures `cm._run_steps` over n steps
with `torch.cuda.graph`; every call, the first included, then replays the
graph once. The graph reads:

- the stacked (n, ...) inputs and labels from static buffers, into which
  each call copies the group it is given (one device-to-device copy per
  input, on the compute stream, after the loader's copy);
- the base key and the first step's global index `i0` from two device
  int64 scalars written before each replay, so that step i draws its
  dropout masks from fold_in(base, i0 + i), as n eager steps fed the same
  keys do;
- the params and the optimizer state in place (the optimizer writes them
  in place, Adam's count and bias corrections included), and the
  non-trainable state from buffers of its own, which the last step's new
  state is copied back into.

A tree handed in that is not the captured one (a restored or replaced
tensor) is copied into the captured buffers first, and the captured trees
are returned: a caller that writes the result back keeps stepping the
same buffers. The mean loss and metrics are the graph's static outputs
(with `health_sentinels`, the grad norm and the non-finite flag among
them: means over the K steps, so a NaN in any step shows); each call
returns copies, so a deferred value survives the next replay.

Before the capture: the state gets every key the step writes (the ops'
`init_state`, the values their lowerings read in a missing key's place),
and one step runs on a side stream to build what the step builds once
(the kernels' libraries, cuDNN's algorithm choices, the fused
optimizer's pointer table, the constants' device tensors); the params
and states are then restored from a copy, so the warm-up changes
nothing. Everything the graph reads that the host writes (the inputs,
the key, i0, the fused optimizer's gradient pointers) lives outside the
graph's memory pool: a buffer from the pool may share memory with a
tensor the capture freed earlier, which the replay overwrites. A capture
or a replay that fails raises: nothing falls back to the eager steps.

Over a mesh the trees hold DTensors and the graph captures the step's
NCCL collectives (the gradients' all-reduce or reduce-scatter, ZeRO's
all-gather, the loss's and the grad norm's reductions). The warm-up step
runs every one of them before the capture, so the communicator exists
and has run when the capture starts; the collectives read and write
only the step's own tensors, which live in the graph's pool for as long
as the graph does. A gloo group cannot be captured: `make_multi_step`
refuses it on the card.
"""

from __future__ import annotations

import time
from gc import collect
from typing import Any, Dict, List

import torch

from flexflow_tpu_torch import random as ff_random
from flexflow_tpu_torch.kernels import fused_optim
from flexflow_tpu_torch.ops import get_op_def
from flexflow_tpu_torch.optimizers import step_count

# graphs captured in this process (chip_smoke and the tests read it)
captures = 0


def _tensors(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    for v in tree.values():
        if isinstance(v, dict):
            _tensors(v, out)
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


@torch.no_grad()
def _copy_into(dst: Dict[str, Any], src: Dict[str, Any], where: str) -> None:
    """Copy `src`'s values into `dst`'s tensors where they are not the
    same objects; the two trees must have the same keys."""
    if set(dst) != set(src):
        raise ValueError(f"{where}: keys {sorted(src)} differ from the "
                         f"captured graph's {sorted(dst)}")
    for k, d in dst.items():
        s = src[k]
        if isinstance(d, dict):
            _copy_into(d, s, f"{where}.{k}")
        elif s is not d:
            if isinstance(s, torch.Tensor):
                d.copy_(s)
            else:
                d.fill_(s)


class GraphedSteps:
    """make_multi_step(n) on the card: fn(params, opt_state, state,
    stacked_inputs, stacked_labels, rng, i0=0) -> (params, opt_state,
    state, mean_loss, mean_metrics)."""

    def __init__(self, cm, n: int):
        self.cm, self.n = cm, int(n)
        self.graph = None
        self.capture_s = None      # wall seconds of warm-up and capture
        self.pool_bytes = None     # memory the graph's pool added

    # ------------------------------------------------------------ capture
    def _complete_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(state)
        for layer in self.cm.model.layers:
            init = get_op_def(layer.op_type).init_state
            if init is not None:
                for k, v in init(layer, self.cm.device).items():
                    out.setdefault(k, v)
        return out

    def _body(self):
        p, o, s, loss, mv = self.cm._run_steps(
            self.n, self.params, self.opt_state, dict(self.state),
            self.inputs, self.labels, self.base, self.i0)
        if set(s) != set(self.state):
            raise RuntimeError(
                f"the captured step wrote state keys "
                f"{sorted(set(s) - set(self.state))} that no op's "
                "init_state gives")
        with torch.no_grad():
            for k, v in s.items():
                if v is not self.state[k]:
                    self.state[k].copy_(v)
        return loss, mv

    def _capture(self, params, opt_state, state, inputs, labels) -> None:
        global captures
        cm, dev = self.cm, self.cm.device
        t0 = time.perf_counter()
        if "count" in opt_state:
            step_count(opt_state, dev)
        self.params, self.opt_state = params, opt_state
        self.state = {k: v.detach().clone()
                      for k, v in self._complete_state(state).items()}
        self.inputs = [torch.empty_like(x) for x in inputs]
        self.labels = torch.empty_like(labels)
        self.base = torch.zeros((), dtype=torch.int64, device=dev)
        self.i0 = torch.zeros((), dtype=torch.int64, device=dev)
        for buf, x in zip(self.inputs + [self.labels], list(inputs) + [labels]):
            buf.copy_(x)
        # warm-up: one step on a side stream, then everything it changed
        # restored from a copy
        live = (_tensors(self.params, []) + _tensors(self.opt_state, [])
                + list(self.state.values()))
        saved = [t.detach().clone() for t in live]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            cm._run_steps(1, self.params, self.opt_state, dict(self.state),
                          [x[:1] for x in self.inputs], self.labels[:1],
                          self.base, self.i0)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for t, c in zip(live, saved):
                t.copy_(c)
        del saved
        torch.cuda.synchronize(dev)
        # what the captured kernels read by pointer must stay alive, and be
        # allocated outside the graph's pool (a replay writes only there)
        plan = cm.fopt_plan
        self._keep = [plan.get(k) for k in ("_adam_table", "_sgd_table",
                                            "_bases")] if plan else []
        if plan:
            fused_optim.begin_capture(plan, self.n, len(_tensors(
                self.params, [])), dev)
        # torch.cuda.graph empties the cache before it captures: so does
        # the reading the pool's size starts from
        collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.loss, self.metrics = self._body()
        finally:
            if plan:
                self._keep.append(fused_optim.fill_captured(plan))
        self.graph = graph
        self.pool_bytes = torch.cuda.memory_reserved(dev) - before
        self.capture_s = time.perf_counter() - t0
        captures += 1

    # ------------------------------------------------------------- replay
    def __call__(self, params, opt_state, state, inputs, labels, rng, i0=0):
        # over a mesh the rank's blocks as DTensors, at every call alike
        inputs, labels = self.cm._feed_stacked(inputs, labels)
        if self.graph is None:
            self._capture(params, opt_state, state, inputs, labels)
        else:
            want = [(tuple(b.shape), b.dtype) for b in self.inputs + [self.labels]]
            got = [(tuple(x.shape), x.dtype) for x in inputs + [labels]]
            if got != want:
                raise ValueError(f"graph of {self.n} steps was captured for "
                                 f"inputs {want}; got {got}")
            with torch.no_grad():
                for buf, x in zip(self.inputs + [self.labels],
                                  inputs + [labels]):
                    buf.copy_(x)
            _copy_into(self.params, params, "params")
            _copy_into(self.opt_state, opt_state, "opt_state")
            _copy_into(self.state, self._complete_state(state), "state")
        with torch.no_grad():
            if isinstance(rng, torch.Tensor):
                self.base.copy_(rng)
            else:
                self.base.fill_(ff_random.key_int64(rng))
            if isinstance(i0, torch.Tensor):
                self.i0.copy_(i0)
            else:
                self.i0.fill_(int(i0))
        self.graph.replay()
        return (self.params, self.opt_state, self.state, self.loss.clone(),
                {k: v.clone() for k, v in self.metrics.items()})
