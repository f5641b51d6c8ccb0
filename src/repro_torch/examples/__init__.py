"""Runnable examples of the port (counterparts of the repository's
``examples/``), e.g. ``python -m repro_torch.examples.serve_cluster``."""
