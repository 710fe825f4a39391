"""Command-line entry points of the port (``python -m healnet_tpu_torch.cli.main``)."""
