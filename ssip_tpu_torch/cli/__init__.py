"""Command-line entry points (``python -m ssip_tpu_torch.cli.<name>``)."""
