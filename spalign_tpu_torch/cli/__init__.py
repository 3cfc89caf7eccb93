"""Command-line entry points of the port
(``python -m spalign_tpu_torch.cli.<tool>``)."""
