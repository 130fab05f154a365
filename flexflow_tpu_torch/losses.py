"""Loss functions (counterpart: flexflow_tpu/losses.py).

A loss is a scalar PyTorch expression of the model's output; autograd
derives its gradient. Sparse cross-entropy from logits is logsumexp minus
the label's logit, averaged over every token, as
`optax.softmax_cross_entropy_with_integer_labels` and `jnp.mean` give it
in the JAX package; callers pass f32 logits, as the train step does.
`LossType` names every loss of the JAX package; only sparse
cross-entropy is ported so far, and the others raise.
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


def compute_loss(loss_type, logits: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """logits: model output [..., vocab]; labels: int ids."""
    lt = LossType.from_any(loss_type)
    if lt is not LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
        raise NotImplementedError(f"loss {lt.value} is not ported yet")
    v = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, v), labels.reshape(-1).long())
