"""Benchmarks of the port (counterparts of the repository's
``benchmarks/``), e.g. ``python -m repro_torch.benchmarks.fig2``."""
