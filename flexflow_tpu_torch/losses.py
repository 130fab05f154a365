"""Loss functions (counterpart: flexflow_tpu/losses.py).

A loss is a scalar PyTorch expression of the model's output; autograd
derives its gradient. Callers pass f32 logits, as the train step does.
Every loss of the JAX package is here, with the same means: sparse
cross-entropy is logsumexp minus the label's logit
(`optax.softmax_cross_entropy_with_integer_labels`), categorical
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
import torch.nn.functional as F


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


def compute_loss(loss_type, logits: torch.Tensor, labels: torch.Tensor,
                 from_logits: bool = True) -> torch.Tensor:
    """logits: the model's output; labels: int ids (sparse) or dense
    targets. Every loss is a mean over all elements, as in JAX."""
    lt = LossType.from_any(loss_type)
    if lt is LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
        v = logits.shape[-1]
        labels = labels.reshape(logits.shape[:-1]).long()
        if from_logits:
            return F.cross_entropy(logits.reshape(-1, v), labels.reshape(-1))
        logp = torch.log(torch.clamp(logits, min=1e-12))
        return -torch.gather(logp, -1, labels[..., None]).mean()
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
