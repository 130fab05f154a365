"""Command-line tools of the port, each run as `python -m
flexflow_tpu_torch.tools.<name>`."""
