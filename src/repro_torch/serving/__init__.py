"""Serving substrate: the engine (classify, prefill, ragged batched
decode, fused sampling, generate) and continuous batching over a shared
cache (counterpart of ``repro.serving``, single device)."""
from repro_torch.serving.batching import (  # noqa: F401
    BUCKETS, ContinuousBatcher, Request, SlotScheduler)
from repro_torch.serving.engine import Engine  # noqa: F401
from repro_torch.serving.sampler import sample  # noqa: F401
