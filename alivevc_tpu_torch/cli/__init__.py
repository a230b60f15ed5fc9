"""Command-line entry points of the port (``python -m alivevc_tpu_torch.cli.<name>``)."""
