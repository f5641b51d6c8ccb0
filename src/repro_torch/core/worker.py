"""ServerlessFunction — the Lambda analogue that actually runs inference.

Lifecycle faithful to the platform the paper targets:
  * COLD invoke: runtime init + model fetch from the ArtifactStore (EFS
    analogue; time = bytes / store bandwidth) + compile, then compute.
  * WARM invoke: the container (here: loaded params + compiled executable)
    is reused — compute only.

``LatencyModel`` carries the platform constants so the same worker code
backs both the real executor (measured compute on the engine's device) and the
calibrated simulator (modeled compute at paper scale).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.core.job import BatchJob, Chunk, InvokeOutcome
from repro_torch.core.store import ArtifactStore


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Platform timing constants (defaults ≈ AWS Lambda).

    ``per_item_s`` selects the compute-time mode everywhere this model
    is consumed (worker invokes, router rounds):

      * ``None`` — MEASURED: real compute on this host, wall-clock
        timed. This is also the required setting when the router runs
        under a fitted ``router.calibrate.CalibratedLatencyModel``
        (the calibration carries the per-item term; supplying both
        raises in ``Router``).
      * a float — MODELED serial work: seconds per item (chunk item or
        active decode slot). The router additionally applies
        ``RouterConfig.round_overhead_s``/``prefill_token_factor``
        around it; ``router/calibrate.py`` fits all three constants
        from measured serving rows instead of hand-setting them — see
        docs/COST_MODEL.md for the model before/after calibration.
    """

    cold_start_s: float = 2.5        # runtime/container init for an ML fn
    warm_start_s: float = 0.010
    invoke_overhead_s: float = 0.050  # orchestrator -> function dispatch
    result_write_s: float = 0.050
    per_item_s: Optional[float] = None  # None -> measured (see above)


class ServerlessFunction:
    def __init__(self, worker_id: int, store: ArtifactStore,
                 latency: LatencyModel, engine=None, params_ref: str = "",
                 ram_mb: float = 848.0):
        self.worker_id = worker_id
        self.store = store
        self.latency = latency
        self.engine = engine
        self.params_ref = params_ref
        self.ram_mb = ram_mb
        self.warm = False
        self._params = None
        self.invocations = 0

    @property
    def params(self):
        """The parameters this function loaded on its cold start."""
        return self._params

    # ------------------------------------------------------------------
    def _cold_load(self) -> float:
        """Fetch model from the store; returns modeled load seconds."""
        load_s = 0.0
        if self.params_ref and self.store.exists(self.params_ref):
            n_bytes = self.store.size(self.params_ref)
            load_s = self.store.read_time_s(n_bytes)
            if self.engine is not None:
                # onto the engine's device on load — the serving hot path
                # then never moves params per invocation
                self._params = self.engine.place_params(
                    self.store.get_tree(self.params_ref))
        return load_s

    def invoke(self, job: BatchJob, chunk: Chunk,
               data: Optional[Dict[str, np.ndarray]] = None
               ) -> InvokeOutcome:
        """Process one chunk. Returns timing + payload.

        Real mode (engine + data): compute is *measured* on this host;
        ``Engine.classify`` ends in a device-to-host copy, which waits for
        the device, so ``compute_s`` covers the device work.
        Sim mode (latency.per_item_s set): compute is modeled.
        """
        lat = self.latency
        self.invocations += 1
        cold = not self.warm
        start_s = lat.cold_start_s if cold else lat.warm_start_s
        load_s = self._cold_load() if cold else 0.0
        self.warm = True

        payload = None
        if lat.per_item_s is not None:
            compute_s = chunk.n_items * lat.per_item_s
            payload = {"digest": (chunk.chunk_id, chunk.n_items)}
        else:
            assert self.engine is not None and data is not None, (
                "real-mode worker needs an engine and chunk data")
            t0 = time.perf_counter()
            preds = self.engine.classify(
                self._params, data["tokens"][chunk.start:chunk.end])
            # on a multi-rank mesh every rank takes the slowest rank's time,
            # so the orchestrator's time-driven decisions (speculation,
            # timeouts) agree and the ranks' collectives stay in step
            compute_s = self.engine.agree(time.perf_counter() - t0)
            payload = {"predictions": preds}

        duration = (lat.invoke_overhead_s + start_s + load_s + compute_s
                    + lat.result_write_s)
        return InvokeOutcome(
            duration_s=duration, payload=payload, cold_start=cold,
            max_ram_mb=self.ram_mb, compute_s=compute_s, load_s=load_s)
