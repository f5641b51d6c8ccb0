"""Inference engine on one device: classify / prefill / decode / generate.

Counterpart of ``repro.serving.engine.Engine`` without a mesh (the port
has no ``dist/`` yet, ROADMAP Queue 1 #8): the compute payload that the
paper's "serverless functions" invoke (``core/worker.py``) and the device
half of continuous batching (``serving/batching.py``).

The shared-batched-cache admission path (``new_cache`` -> ``prefill_into``
-> ``decode`` -> ``free_row``) serves continuous batching: one
(n_slots, max_len, ...) cache whose per-row ``lengths`` make the decode
batch ragged, so one decode call serves every slot at its own depth. The
reference donates the cache to each of these calls; here they write the
caller's cache IN PLACE and return it, so no round copies it.

Shape-bucket contract, as in the reference: every entry point routes
through one cache keyed by (kind, input shape bucket), with the
reference's keys, and ``compile_count`` counts the distinct buckets seen.
PyTorch runs eagerly, so a bucket holds the function rather than a
compiled executable, but the counts read the same as the reference's
(flat across admit/evict churn) and ``warm`` flips at the same call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.decode_attention.fused_sampling import fused_sample
from repro_torch.models.common import RunConfig
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import Cache
from repro_torch.serving.sampler import sample
from repro_torch.tree import tree_map


def _leaf_key(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype).removeprefix("torch."))
    x = np.asarray(x)
    return (tuple(x.shape), x.dtype.name)


def _shape_key(tree) -> tuple:
    """Hashable shape/dtype bucket of an input: an array or tensor, a dict
    of them, or a decode ``Cache`` (whose type takes part in the key, as
    the reference's treedef does)."""
    if isinstance(tree, Cache):
        return ("Cache",) + tuple(_leaf_key(t) for t in tree.tensors())
    if isinstance(tree, dict):
        return tuple((k, _shape_key(v)) for k, v in sorted(tree.items()))
    return _leaf_key(tree)


def _check_prompt(s: int, max_len: int):
    if max_len <= 0:
        raise ValueError(f"max_len must be positive, got {max_len}")
    if s > max_len:
        raise ValueError(
            f"prompt of {s} tokens exceeds the cache's capacity of "
            f"{max_len} — allocate new_cache with a larger max_len")


@dataclasses.dataclass
class Engine:
    """Serving engine over one built model.

    Args:
      model: ``models.build(cfg)`` facade.
      run: runtime knobs; ``run.attn_impl="pallas"`` runs attention
        through the hand-written CUDA kernels on a CUDA device (CPU
        tensors take their plain versions). ``kv_dtype="int8"`` is not
        ported yet (ROADMAP Queue 1 #5).
      device: where params, caches and activations live (``"cuda"``
        unless the caller asks for the CPU).
    """

    model: Model
    run: RunConfig = RunConfig()
    device: Any = "cuda"

    def __post_init__(self):
        if self.run.kv_dtype == "int8":
            raise NotImplementedError(
                "kv_dtype='int8' is not ported yet (ROADMAP.md Queue 1 #5)")
        if self.run.kv_dtype != "bf16":
            raise ValueError(f"kv_dtype={self.run.kv_dtype!r} not in "
                             f"('bf16', 'int8')")
        self.device = torch.device(self.device)
        self._exec: Dict[Any, Any] = {}
        self.compile_count = 0

    def place_params(self, params):
        """``params`` moved onto the engine's device."""
        return tree_map(lambda t: t.to(self.device), params)

    def _tokens_in(self, tokens) -> torch.Tensor:
        """Token ids (array or tensor) as a long tensor on the device;
        host arrays are range-checked first (an id past the vocabulary
        would be a device-side fault on CUDA)."""
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device, torch.long)
        tokens = np.asarray(tokens)
        vocab = self.model.cfg.vocab_size
        if tokens.size and (tokens.min() < 0 or tokens.max() >= vocab):
            raise ValueError(f"token ids must lie in [0, {vocab})")
        return torch.tensor(tokens, dtype=torch.long, device=self.device)

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

    def _prefill_fn(self, max_len: int):
        def _prefill(params, batch):
            return self.model.prefill(self.run, params, batch,
                                      max_len=max_len)
        return _prefill

    def _decode_fn(self, sample_kw: Optional[dict] = None):
        def _decode(params, cache, token, generator=None):
            logits, cache = self.model.decode_step(self.run, params, cache,
                                                   {"token": token})
            if sample_kw is not None:  # fused epilogue: (B,) tokens out
                return fused_sample(logits, generator, **sample_kw), cache
            return logits, cache
        return _decode

    def _prefill_into_fn(self, max_len: int,
                         sample_kw: Optional[dict] = None):
        def _prefill_into(params, cache, batch, row, generator=None):
            logits, small = self.model.prefill(self.run, params, batch,
                                               max_len=max_len)
            for big, sm in zip(cache.layers, small.layers):
                for name, t in sm.items():
                    big[name][row, :t.shape[1]].copy_(t[0])
            cache.lengths[row] = small.lengths[0]
            if sample_kw is not None:  # fused epilogue: (1,) token out
                return fused_sample(logits, generator, **sample_kw), cache
            return logits, cache
        return _prefill_into

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
        device_tokens = self._tokens_in(tokens)
        fn = self._get_exec("classify", _shape_key(tokens),
                            self._classify_fn)
        with torch.inference_mode():
            return fn(params, device_tokens).cpu().numpy()

    # ------------------------------------------------------------------
    # Prefill / decode
    # ------------------------------------------------------------------

    def prefill(self, params, tokens, *, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, S) -> (last-token logits (B, V), populated cache of
        capacity ``max_len``, default S + ``run.cache_pad``)."""
        tokens = self._tokens_in(tokens)
        b, s = tokens.shape
        if max_len is None:
            max_len = s + self.run.cache_pad
        _check_prompt(s, max_len)
        batch = {"tokens": tokens}
        fn = self._get_exec("prefill", (_shape_key(batch), max_len),
                            lambda: self._prefill_fn(max_len))
        with torch.no_grad():
            return fn(params, batch)

    def decode(self, params, cache: Cache, token
               ) -> Tuple[torch.Tensor, Cache]:
        """One decode step, (B, 1) tokens -> ((B, V) logits, cache). The
        batch is RAGGED (each row at its own ``cache.lengths[b]``) and the
        cache is updated in place."""
        token = self._tokens_in(token)
        fn = self._get_exec("decode", _shape_key(cache), self._decode_fn)
        with torch.no_grad():
            return fn(params, cache, token)

    # ------------------------------------------------------------------
    # Shared batched cache: allocation / row admission / row free
    # ------------------------------------------------------------------

    def new_cache(self, batch: int, max_len: int) -> Cache:
        """Allocate an EMPTY shared batched decode cache (all lengths 0)
        on the engine's device: the backing store of continuous batching,
        admitted into by :meth:`prefill_into`, freed by :meth:`free_row`.
        """
        if batch <= 0 or max_len <= 0:
            raise ValueError(
                f"new_cache needs positive batch/max_len, got "
                f"batch={batch} max_len={max_len}")
        return self.model.init_cache(batch, max_len,
                                     kv_dtype=self.run.kv_dtype,
                                     device=self.device)

    def _row_len(self, cache: Cache, s: int, max_len: Optional[int]) -> int:
        """The prefill length of an admission: ``max_len``, default the
        shared cache's capacity (axis 1 of the port's per-layer
        (B, T, KV, hd) leaves, where the reference reads axis 2 of its
        stacked leaves)."""
        cap = (cache.layers[0]["k"].shape[1] if cache.layers
               else s + self.run.cache_pad)
        max_len = cap if max_len is None else max_len
        if max_len > cap:
            raise ValueError(f"max_len={max_len} exceeds the shared "
                             f"cache's capacity of {cap}")
        _check_prompt(s, max_len)
        return max_len

    def prefill_into(self, params, cache: Cache, row: int, tokens, *,
                     max_len: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Cache]:
        """Admit one request into row ``row`` of a shared batched cache.

        tokens: (1, S). Prefills against the cache's capacity ``max_len``
        (inferred from the cache when omitted), then writes the KV rows
        and ``lengths[row] = S`` into the shared cache in place. One
        bucket per (cache, prompt shape), not per slot. Returns
        (last-token logits (1, V), cache).
        """
        tokens = self._tokens_in(tokens)
        s = tokens.shape[1]
        max_len = self._row_len(cache, s, max_len)
        batch = {"tokens": tokens}
        fn = self._get_exec(
            "prefill_into", (_shape_key(cache), _shape_key(batch)),
            lambda: self._prefill_into_fn(max_len))
        with torch.no_grad():
            return fn(params, cache, batch, int(row))

    def _free_fn(self):
        def _free(cache, row):
            cache.lengths[row] = 0
            return cache
        return _free

    def free_row(self, cache: Cache, row: int) -> Cache:
        """Evict row ``row``: reset its length to 0 (the per-row masks make
        a zero-length row inert; its stale KV is overwritten by the next
        :meth:`prefill_into`). In place; returns the cache."""
        fn = self._get_exec("free_row", _shape_key(cache), self._free_fn)
        return fn(cache, int(row))

    # ------------------------------------------------------------------
    # Fused sampling (token ids out of the decode call: no separate
    # sampler step over the (B, V) logits)
    # ------------------------------------------------------------------

    def decode_sample(self, params, cache: Cache, token,
                      generator: Optional[torch.Generator], *,
                      temperature: float = 0.0,
                      top_k: Optional[int] = None,
                      top_p: Optional[float] = None
                      ) -> Tuple[torch.Tensor, Cache]:
        """:meth:`decode` with the sampler fused in: returns ((B,) int32
        tokens, cache). From the same generator state the tokens equal
        ``sample`` over :meth:`decode`'s logits (on the card up to top-p
        cutoff near-ties). Sampling params are part of the bucket key."""
        token = self._tokens_in(token)
        kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        fn = self._get_exec(
            "decode_sample", (_shape_key(cache), (temperature, top_k,
                                                  top_p)),
            lambda: self._decode_fn(sample_kw=kw))
        with torch.no_grad():
            return fn(params, cache, token, generator)

    def prefill_into_sample(self, params, cache: Cache, row: int, tokens,
                            generator: Optional[torch.Generator], *,
                            temperature: float = 0.0,
                            top_k: Optional[int] = None,
                            top_p: Optional[float] = None,
                            max_len: Optional[int] = None
                            ) -> Tuple[torch.Tensor, Cache]:
        """:meth:`prefill_into` with the first sampled token fused in.
        Returns ((1,) int32 token, cache)."""
        tokens = self._tokens_in(tokens)
        s = tokens.shape[1]
        max_len = self._row_len(cache, s, max_len)
        batch = {"tokens": tokens}
        kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        fn = self._get_exec(
            "prefill_into_sample",
            (_shape_key(cache), _shape_key(batch),
             (temperature, top_k, top_p)),
            lambda: self._prefill_into_fn(max_len, sample_kw=kw))
        with torch.no_grad():
            return fn(params, cache, batch, int(row), generator)

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------

    def generate(self, params, tokens, *, max_new_tokens: int = 16,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 max_len: Optional[int] = None,
                 fused_sampling: bool = False) -> np.ndarray:
        """Greedy/temperature generation. tokens: (B, S) -> (B, S+new).

        Prefill, then one decode call per new token; sampled tokens stay
        on the device until the final concatenation. The noise comes from
        one ``torch.Generator`` seeded with ``seed``, one draw per token
        in both modes, so at the same seed ``fused_sampling=True``
        (:meth:`decode_sample`) emits the host path's stream (on the card
        up to top-p cutoff near-ties).
        """
        prompt = self._tokens_in(tokens)
        kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        logits, cache = self.prefill(params, prompt, max_len=max_len)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.no_grad():
            if fused_sampling:
                tok = fused_sample(logits, gen, **kw)[:, None]
            else:
                tok = sample(logits, gen, **kw)[:, None]
        outs = [prompt.to(torch.int32)]
        for _ in range(max_new_tokens - 1):
            outs.append(tok)
            if fused_sampling:
                toks, cache = self.decode_sample(params, cache, tok, gen,
                                                 **kw)
                tok = toks[:, None]
            else:
                logits, cache = self.decode(params, cache, tok)
                with torch.no_grad():
                    tok = sample(logits, gen, **kw)[:, None]
        outs.append(tok)
        return torch.cat(outs, dim=1).cpu().numpy()
