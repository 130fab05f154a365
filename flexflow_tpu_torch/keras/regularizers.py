"""Keras regularizers (counterpart: flexflow_tpu/keras/regularizers.py).
A layer built with `kernel_regularizer` registers an L1/L2 term on the
FFModel (`add_weight_regularizer`) that the compiled train step adds to
its loss, so the penalty is differentiated and shows in the reported
loss."""

from __future__ import annotations


class Regularizer:
    mode: str = ""
    coeff: float = 0.0

    def terms(self):
        """[(mode, coeff)] — L1L2 contributes two."""
        return [(self.mode, self.coeff)] if self.coeff else []


class L1(Regularizer):
    def __init__(self, l1: float = 0.01):
        self.mode, self.coeff = "l1", float(l1)


class L2(Regularizer):
    def __init__(self, l2: float = 0.01):
        self.mode, self.coeff = "l2", float(l2)


class L1L2(Regularizer):
    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1, self.l2 = float(l1), float(l2)

    def terms(self):
        out = []
        if self.l1:
            out.append(("l1", self.l1))
        if self.l2:
            out.append(("l2", self.l2))
        return out


def l1(l=0.01):
    return L1(l)


def l2(l=0.01):
    return L2(l)


def l1_l2(l1=0.01, l2=0.01):
    return L1L2(l1, l2)


def get(identifier):
    if identifier is None or isinstance(identifier, Regularizer):
        return identifier
    if isinstance(identifier, str):
        return {"l1": L1(), "l2": L2(), "l1_l2": L1L2(0.01, 0.01)}[identifier]
    raise ValueError(f"unknown regularizer {identifier!r}")
