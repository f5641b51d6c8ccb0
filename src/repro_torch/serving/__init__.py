"""Serving substrate: the classification engine (counterpart of
``repro.serving.engine.Engine``'s classify path)."""
from repro_torch.serving.engine import Engine  # noqa: F401
