"""Training metrics (counterpart: flexflow_tpu/metrics.py).

Metrics are PyTorch expressions computed on the device inside the step;
`PerfMetrics` accumulates them. `MetricsType` names every metric of the
JAX package, each computed as the JAX package computes it. Deferred mode
keeps the step's device scalars queued and reads them to the host only
at `materialize()` (in one transfer), so the training loop never waits
on the device for a metric.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Sequence

import torch

from flexflow_tpu_torch.losses import LossType, compute_loss


class MetricsType(enum.Enum):
    ACCURACY = "accuracy"
    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR = "mean_squared_error"
    ROOT_MEAN_SQUARED_ERROR = "root_mean_squared_error"
    MEAN_ABSOLUTE_ERROR = "mean_absolute_error"

    @staticmethod
    def from_any(x) -> "MetricsType":
        if isinstance(x, MetricsType):
            return x
        return MetricsType(str(x))


@dataclasses.dataclass
class PerfMetrics:
    """Accumulated training metrics.

    `update_deferred(batch, {name: tensor})` queues device scalars without
    reading them. Every `fold_after` queued updates are folded on the
    device into one chunk scalar per metric (device adds only, no sync);
    `materialize()` then reads every chunk and queued value in one transfer
    and sums them on the host in float64, chunks first, then the queue in
    order: the same terms in the same order as the JAX package's
    `PerfMetrics`.
    """

    train_all: int = 0
    sums: Dict[str, float] = dataclasses.field(default_factory=dict)
    fold_after: int = 256
    _pending: List = dataclasses.field(default_factory=list, repr=False)
    _dev_chunks: Dict[str, List] = dataclasses.field(
        default_factory=dict, repr=False)

    def update_deferred(self, batch: int, values: Dict[str, torch.Tensor]):
        """Queue device scalars; nothing is read to the host here."""
        self.train_all += batch
        if values:
            self._pending.append((batch, dict(values)))
            if len(self._pending) >= self.fold_after:
                self._fold_on_device()

    def _fold_on_device(self):
        chunk: Dict[str, torch.Tensor] = {}
        for batch, values in self._pending:
            for k, v in values.items():
                term = v.float() * float(batch)
                chunk[k] = term if k not in chunk else chunk[k] + term
        for k, v in chunk.items():
            self._dev_chunks.setdefault(k, []).append(v)
        self._pending.clear()

    def materialize(self) -> None:
        """Drain deferred updates into host `sums`: the one place deferred
        mode reads the device."""
        vals = [v for chunks in self._dev_chunks.values() for v in chunks]
        vals += [v for _, values in self._pending for v in values.values()]
        if not vals:
            return
        host = iter(torch.stack([v.detach().float().reshape(())
                                 for v in vals]).tolist())
        for k, chunks in self._dev_chunks.items():
            for _ in chunks:
                self.sums[k] = self.sums.get(k, 0.0) + next(host)
        for batch, values in self._pending:
            for k in values:
                self.sums[k] = self.sums.get(k, 0.0) + next(host) * batch
        self._dev_chunks.clear()
        self._pending.clear()

    def summary(self) -> Dict[str, float]:
        self.materialize()
        n = max(1, self.train_all)
        out = {"samples": float(self.train_all)}
        for k, v in self.sums.items():
            out[k] = v / n
        return out


def compute_metrics(metric_types: Sequence[MetricsType], logits: torch.Tensor,
                    labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Device scalars, one per metric; `logits` in f32, `labels` int ids
    or dense targets. Accuracy compares argmaxes: of the labels too when
    they have the logits' shape (one-hot), else the labels as ids."""
    out: Dict[str, torch.Tensor] = {}
    for mt in metric_types:
        mt = MetricsType.from_any(mt)
        if mt is MetricsType.ACCURACY:
            pred = logits.argmax(-1)
            if labels.shape == logits.shape:
                true = labels.argmax(-1)
            else:
                true = labels.reshape(pred.shape).to(pred.dtype)
            out["accuracy"] = (pred == true).float().mean()
        elif mt is MetricsType.CATEGORICAL_CROSSENTROPY:
            out["categorical_crossentropy"] = compute_loss(
                LossType.CATEGORICAL_CROSSENTROPY, logits, labels)
        elif mt is MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY:
            out["sparse_categorical_crossentropy"] = compute_loss(
                LossType.SPARSE_CATEGORICAL_CROSSENTROPY, logits, labels)
        else:
            err = logits - labels.to(logits.dtype)
            if mt is MetricsType.MEAN_SQUARED_ERROR:
                out["mean_squared_error"] = torch.square(err).mean()
            elif mt is MetricsType.ROOT_MEAN_SQUARED_ERROR:
                out["root_mean_squared_error"] = torch.sqrt(
                    torch.square(err).mean())
            else:
                out["mean_absolute_error"] = err.abs().mean()
    return out
