"""Loss functions (counterpart: flexflow_tpu/losses.py).

A loss is a scalar PyTorch expression of the model's output; autograd
derives its gradient. Callers pass f32 logits, as the train step does.
Every loss of the JAX package is here, with the same means: sparse
cross-entropy is logsumexp minus the label's logit
(`optax.softmax_cross_entropy_with_integer_labels`), the label's entry
taken by JAX's index rules (`_take_label`), categorical
cross-entropy -sum(labels * log_softmax) over the last dim
(`optax.softmax_cross_entropy`), both averaged over every row; with
`from_logits=False` the output is taken as probabilities, clipped at
1e-12 before the log. MSE (and its avg-reduce alias) casts the labels to
the logits' dtype and averages the squares over every element; identity
is the output's mean.
"""

from __future__ import annotations

import enum

import torch


class LossType(enum.Enum):
    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR = "mean_squared_error"
    MEAN_SQUARED_ERROR_AVG_REDUCE = "mean_squared_error_avg_reduce"
    IDENTITY = "identity"

    @staticmethod
    def from_any(x) -> "LossType":
        if isinstance(x, LossType):
            return x
        return LossType(str(x))


def _take_label(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """x[..., label] as `jnp.take_along_axis` takes it: a negative label
    counts from the end, and one outside [-v, v) reads NaN. No host sync
    and no device assert on any label."""
    v = x.shape[-1]
    idx = torch.where(labels < 0, labels + v, labels)
    ok = (idx >= 0) & (idx < v)
    # the mask is applied before the gathered dim is dropped: over a mesh
    # whose class dim is sharded, DTensor's pending masked gather is
    # resolved at the shape it was taken at
    got = torch.gather(x, -1, idx.clamp(0, v - 1)[..., None])
    return torch.where(ok[..., None], got, torch.full(
        (), float("nan"), dtype=x.dtype, device=x.device))[..., 0]


def compute_loss(loss_type, logits: torch.Tensor, labels: torch.Tensor,
                 from_logits: bool = True) -> torch.Tensor:
    """logits: the model's output; labels: int ids (sparse) or dense
    targets. Every loss is a mean over all elements, as in JAX."""
    lt = LossType.from_any(loss_type)
    if lt is LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
        labels = labels.reshape(logits.shape[:-1]).long()
        if from_logits:
            return (torch.logsumexp(logits, dim=-1)
                    - _take_label(logits, labels)).mean()
        logp = torch.log(torch.clamp(logits, min=1e-12))
        return -_take_label(logp, labels).mean()
    if lt is LossType.CATEGORICAL_CROSSENTROPY:
        labels = labels.to(logits.dtype)
        logp = (torch.log_softmax(logits, dim=-1) if from_logits
                else torch.log(torch.clamp(logits, min=1e-12)))
        return -(labels * logp).sum(dim=-1).mean()
    if lt in (LossType.MEAN_SQUARED_ERROR,
              LossType.MEAN_SQUARED_ERROR_AVG_REDUCE):
        return torch.square(logits - labels.to(logits.dtype)).mean()
    if lt is LossType.IDENTITY:
        return logits.mean()
    raise ValueError(lt)
