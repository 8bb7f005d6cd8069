"""Command-line entry points of the port (``python -m
coin_tpu_torch.tools.<name>``)."""
