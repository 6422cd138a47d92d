"""Command-line entry points of the port: ``python -m
ess_tpu_torch.cli.train`` and ``python -m ess_tpu_torch.cli.evaluate``."""
