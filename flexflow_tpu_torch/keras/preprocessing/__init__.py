"""Keras preprocessing (counterpart: flexflow_tpu/keras/preprocessing/)."""

from flexflow_tpu_torch.keras.preprocessing import sequence, text
from flexflow_tpu_torch.keras.preprocessing.sequence import pad_sequences

__all__ = ["sequence", "text", "pad_sequences"]
