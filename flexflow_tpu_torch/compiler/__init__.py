"""Layer graph -> PyTorch programs."""
