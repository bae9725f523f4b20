"""Command-line tools of the port (``python -m pivot_tpu_torch.tools.<name>``)."""
