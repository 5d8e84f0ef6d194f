"""Command-line entry points (``python -m audiotokenization_tpu_torch.cli.<name>``)."""
