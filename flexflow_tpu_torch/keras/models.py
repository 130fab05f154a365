"""Keras Model and Sequential on top of FFModel (counterpart:
flexflow_tpu/keras/models.py).

`compile()` records the optimizer, loss, metrics and the device only; the
FFModel is built and compiled at the first fit, evaluate or predict, when
the batch size is known (a compiled graph has fixed shapes), with the
graph's outputs as `outputs=`. It runs on the GPU unless `device="cpu"`
is passed to `compile()` (or the launcher's FLEXFLOW_PLATFORM asks for
the CPU).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.model import FFModel
from flexflow_tpu_torch.keras.layers import KTensor, Layer


def _collect_graph(outputs: List[KTensor]) -> List[KTensor]:
    """Topological list of KTensors reachable from outputs."""
    seen: Dict[int, KTensor] = {}
    order: List[KTensor] = []

    def visit(t: KTensor):
        if id(t) in seen:
            return
        seen[id(t)] = t
        for i in t.inputs:
            visit(i)
        order.append(t)

    for o in outputs:
        visit(o)
    return order


class BaseModel:
    def __init__(self, name: Optional[str] = None):
        self.name = name
        self.optimizer = None
        self.loss = None
        self.metrics: Sequence = ()
        self.ffconfig_overrides: Dict = {}
        self.device = None
        self._ffmodel: Optional[FFModel] = None
        self._batch_size: Optional[int] = None

    # ---- to be provided by subclasses
    def _graph_inputs(self) -> List[KTensor]:
        raise NotImplementedError

    def _graph_outputs(self) -> List[KTensor]:
        raise NotImplementedError

    # ------------------------------------------------------------ keras API
    def compile(self, optimizer, loss=None, metrics=None, device=None, **kw):
        from flexflow_tpu_torch.keras import optimizers as kopt

        self.device = device
        self.optimizer = kopt.get(optimizer)
        self.loss = loss or "sparse_categorical_crossentropy"
        self.metrics = metrics or ["accuracy"]
        return self

    def _build(self, batch_size: int) -> FFModel:
        if self._ffmodel is not None and self._batch_size == batch_size:
            return self._ffmodel
        cfg = FFConfig(batch_size=batch_size, **self.ffconfig_overrides)
        ff = FFModel(cfg)
        env: Dict[int, object] = {}
        graph_inputs = self._graph_inputs()
        for kt in graph_inputs:
            env[id(kt)] = ff.create_tensor((batch_size,) + kt.shape,
                                           dtype=kt.dtype, name=kt.name)
        emitted: Dict[Layer, List] = {}
        for kt in _collect_graph(self._graph_outputs()):
            if kt.layer is None:
                if id(kt) not in env:
                    raise ValueError(f"free input {kt.name} not among inputs")
                continue
            call_key = kt.layer, tuple(id(i) for i in kt.inputs)
            if call_key not in emitted:
                ins = [env[id(i)] for i in kt.inputs]
                emitted[call_key] = kt.layer.to_ff(ff, ins)
            env[id(kt)] = emitted[call_key][kt.idx]
        outs = [env[id(o)] for o in self._graph_outputs()]
        ff.compile(self.optimizer.to_ff(), self.loss,
                   [m for m in self.metrics], outputs=outs,
                   device=self.device)
        self._ffmodel = ff
        self._batch_size = batch_size
        return ff

    def fit(self, x, y, batch_size: Optional[int] = None, epochs: int = 1,
            callbacks=None, validation_data=None, verbose: bool = True):
        xs = x if isinstance(x, (list, tuple)) else [x]
        batch_size = batch_size or min(len(np.asarray(xs[0])),
                                       FFConfig().batch_size)
        ff = self._build(batch_size)
        for cb in callbacks or []:
            if hasattr(cb, "set_model"):
                cb.set_model(self)
        history = ff.fit(list(xs), y, batch_size=batch_size, epochs=epochs,
                         callbacks=callbacks, verbose=verbose)
        if validation_data is not None:
            vx, vy = validation_data
            history[-1]["val"] = ff.eval(vx, vy)
        return history

    def evaluate(self, x, y, batch_size: Optional[int] = None):
        xs = x if isinstance(x, (list, tuple)) else [x]
        batch_size = self._batch_size or batch_size or FFConfig().batch_size
        ff = self._build(batch_size)
        return ff.eval(list(xs), y)

    def predict(self, x, batch_size: Optional[int] = None):
        xs = x if isinstance(x, (list, tuple)) else [x]
        n = len(np.asarray(xs[0]))
        batch_size = self._batch_size or batch_size or n
        ff = self._build(batch_size)
        outs = []
        for lo in range(0, n, batch_size):
            chunk = [np.asarray(a)[lo:lo + batch_size] for a in xs]
            got = len(chunk[0])
            if got < batch_size:  # pad the tail batch, trim below
                chunk = [np.concatenate(
                    [c, np.repeat(c[-1:], batch_size - got, axis=0)]) for c in chunk]
            out = ff.forward(*chunk).detach().cpu().numpy()
            outs.append(out[:got])
        return np.concatenate(outs, axis=0) if outs else np.empty((0,))

    def summary(self) -> str:
        lines = [f"Model: {self.name or type(self).__name__}"]
        for kt in _collect_graph(self._graph_outputs()):
            if kt.layer is not None:
                lines.append(f"  {kt.layer.name} <- "
                             f"{[i.name for i in kt.inputs]}")
        return "\n".join(lines)

    @property
    def ffmodel(self) -> Optional[FFModel]:
        return self._ffmodel


class Model(BaseModel):
    """Functional API: Model(inputs, outputs)."""

    def __init__(self, inputs, outputs, name: Optional[str] = None):
        super().__init__(name)
        self._inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        self._outputs = list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]

    def _graph_inputs(self):
        return self._inputs

    def _graph_outputs(self):
        return self._outputs


class Sequential(BaseModel):
    def __init__(self, layers=None, name: Optional[str] = None):
        super().__init__(name)
        self._layers: List[Layer] = []
        self._input_shape = None
        for l in layers or []:
            self.add(l)

    def add(self, layer):
        # model.add(Input(shape=...)): FlexFlow's sequential examples
        # (e.g. seq_reuters_mlp.py) add the input tensor itself
        if isinstance(layer, KTensor):
            self._input_shape = layer.shape
            return
        self._layers.append(layer)

    def _graph_inputs(self):
        self._materialize()
        return self.__inputs

    def _graph_outputs(self):
        self._materialize()
        return self.__outputs

    def _materialize(self):
        if getattr(self, "_Sequential__outputs", None) is not None:
            return
        from flexflow_tpu_torch.keras.layers import Input

        first = self._layers[0]
        shape = self._input_shape or getattr(first, "_declared_input_shape", None)
        if shape is None:
            raise ValueError(
                "Sequential needs an added Input(...) or a first layer "
                "built with input_shape=...")
        t = Input(shape)
        self.__inputs = [t]
        for l in self._layers:
            t = l(t)
        self.__outputs = [t]


