"""Keras callbacks (counterpart: flexflow_tpu/keras/callbacks.py). `fit`
calls `set_model` and `on_epoch_end(epoch, metrics)`, as the JAX
package's does; `on_train_end` is the caller's to call."""

from __future__ import annotations


class Callback:
    def set_model(self, model):
        self.model = model

    def on_train_begin(self):
        pass

    def on_train_end(self):
        pass

    def on_epoch_end(self, epoch, metrics=None):
        pass


class VerifyMetrics(Callback):
    """Assert final accuracy reaches a floor (FlexFlow uses a ModelAccuracy
    enum; any object with a .value in percent, or a float fraction, works)."""

    def __init__(self, accuracy):
        self.target = (accuracy.value / 100.0
                       if hasattr(accuracy, "value") else float(accuracy))
        self.last = None

    def on_epoch_end(self, epoch, metrics=None):
        if metrics:
            self.last = metrics.get("accuracy")

    def on_train_end(self):
        if self.last is not None and self.last < self.target:
            raise AssertionError(
                f"accuracy {self.last:.4f} below target {self.target:.4f}")


class EpochVerifyMetrics(Callback):
    """Track whether any epoch reached the target accuracy."""

    def __init__(self, accuracy):
        self.target = (accuracy.value / 100.0
                       if hasattr(accuracy, "value") else float(accuracy))
        self.reached = False

    def on_epoch_end(self, epoch, metrics=None):
        if metrics and metrics.get("accuracy", 0.0) >= self.target:
            self.reached = True
