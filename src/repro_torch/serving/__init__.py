"""Serving substrate: the engine (classify, prefill, ragged batched
decode on dense or block-paged caches, bf16 or int8 KV, fused sampling,
generate), continuous batching over a shared cache and the host-side page
allocator (counterpart of ``repro.serving``, single device)."""
from repro_torch.serving.batching import (  # noqa: F401
    BUCKETS, ContinuousBatcher, Request, SlotScheduler)
from repro_torch.serving.engine import Engine  # noqa: F401
from repro_torch.serving.paged import (  # noqa: F401
    AdmissionPlan, PageAllocator, PagesExhausted)
from repro_torch.serving.sampler import sample  # noqa: F401
