"""Frontend graph: tensors, layers, the FFModel builder."""
