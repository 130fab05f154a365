"""Parallelization strategies (counterpart: flexflow_tpu/parallel/)."""
