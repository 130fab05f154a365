"""The ONNX frontend (counterpart: flexflow_tpu/onnx/)."""

from flexflow_tpu_torch.onnx.model import ONNXModel  # noqa: F401
