"""Inference engine: batched classification on one device.

Counterpart of the classify path of ``repro.serving.engine.Engine``: the
compute payload that the paper's "serverless functions" invoke
(``core/worker.py``).

Shape-bucket contract, as in the reference: every call routes through one
cache keyed by (kind, input shape bucket), and ``compile_count`` counts the
distinct buckets seen. PyTorch runs eagerly, so a bucket holds the forward
function rather than a compiled executable, but the counts read the same
as the reference's and ``warm`` flips at the same call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.common import RunConfig
from repro_torch.models.model_zoo import Model
from repro_torch.tree import tree_map


def _shape_key(tokens: np.ndarray) -> tuple:
    """Hashable shape/dtype bucket of an input array."""
    return (tuple(tokens.shape), tokens.dtype.name)


@dataclasses.dataclass
class Engine:
    """Serving engine over one built model.

    Args:
      model: ``models.build(cfg)`` facade.
      run: runtime knobs; ``run.attn_impl="pallas"`` runs attention
        through the hand-written CUDA kernel on a CUDA device.
      device: where params and activations live (``"cuda"`` unless the
        caller asks for the CPU).
    """

    model: Model
    run: RunConfig = RunConfig()
    device: Any = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self._exec: Dict[Any, Any] = {}
        self.compile_count = 0

    def place_params(self, params):
        """``params`` moved onto the engine's device."""
        return tree_map(lambda t: t.to(self.device), params)

    # ------------------------------------------------------------------
    # Shape buckets
    # ------------------------------------------------------------------

    def _get_exec(self, kind: str, key: tuple, build):
        fn = self._exec.get((kind, key))
        if fn is None:
            fn = build()
            self._exec[(kind, key)] = fn
            self.compile_count += 1
        return fn

    @property
    def warm(self) -> bool:
        """True once at least one shape bucket has been served."""
        return bool(self._exec)

    def _classify_fn(self):
        def _classify(params, tokens):
            logits, _ = self.model.forward(self.run, params,
                                           {"tokens": tokens})
            return logits
        return _classify

    # ------------------------------------------------------------------
    # Classification (the paper's sentiment inference)
    # ------------------------------------------------------------------

    def classify(self, params, tokens) -> np.ndarray:
        """Batched classification. tokens: (B, S) int32 -> (B,) labels."""
        return np.argmax(self.classify_logits(params, tokens),
                         axis=-1).astype(np.int32)

    def classify_logits(self, params, tokens) -> np.ndarray:
        """(B, S) token ids -> (B, num_labels) fp32 logits on the host.

        The final copy to the host waits for the device, so a caller's
        clock around this call covers the device work.
        """
        tokens = np.asarray(tokens)
        vocab = self.model.cfg.vocab_size
        if tokens.size and (tokens.min() < 0 or tokens.max() >= vocab):
            raise ValueError(f"token ids must lie in [0, {vocab})")
        fn = self._get_exec("classify", _shape_key(tokens),
                            self._classify_fn)
        with torch.inference_mode():
            logits = fn(params, torch.as_tensor(tokens).to(
                self.device, torch.long))
            return logits.cpu().numpy()
