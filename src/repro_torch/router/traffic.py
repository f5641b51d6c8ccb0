"""Synthetic arrival processes for the online router.

Counterpart of ``repro.router.traffic``: the same numpy draws, so both
packages make the same arrivals and prompts at the same seed.

Three generators, all deterministic given the seed:

  * ``poisson``  — constant-rate Poisson (the steady-state baseline);
  * ``bursty``   — low base rate with periodic high-rate bursts (the
    regime where autoscaling pays: a fixed pool either over-provisions
    the troughs or drowns in the bursts);
  * ``diurnal``  — a smooth sin² ramp up to a peak and back down within
    the horizon (one compressed "day" of traffic).

Non-constant rates are sampled by thinning: draw a Poisson process at
the max rate, keep each arrival with probability ``rate(t)/max_rate``.

``make_requests`` turns arrival times into serving ``Request`` objects.
Prompts all share ONE length so the whole scenario stays in a single
``prefill_into`` shape bucket — request diversity comes from the arrival
process, not from shape churn that would conflate autoscaling with
recompilation.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.batching import Request


def _thinned(rate_fn: Callable[[float], float], max_rate: float,
             horizon_s: float, seed: int) -> np.ndarray:
    if max_rate <= 0 or horizon_s <= 0:
        return np.asarray([], dtype=np.float64)   # no traffic, not a crash
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    while True:
        t += rng.exponential(1.0 / max_rate)
        if t >= horizon_s:
            break
        if rng.random() < rate_fn(t) / max_rate:
            out.append(t)
    return np.asarray(out, dtype=np.float64)


def poisson_arrivals(rate_rps: float, horizon_s: float,
                     seed: int = 0) -> np.ndarray:
    """Constant-rate Poisson arrivals in [0, horizon_s)."""
    return _thinned(lambda t: rate_rps, rate_rps, horizon_s, seed)


def bursty_arrivals(rate_rps: float, horizon_s: float, seed: int = 0, *,
                    base_frac: float = 0.1, burst_every_s: float = 4.0,
                    burst_len_s: float = 1.0) -> np.ndarray:
    """Bursts at ``rate_rps`` for ``burst_len_s`` out of every
    ``burst_every_s``; ``base_frac * rate_rps`` in between."""
    base = base_frac * rate_rps

    def rate(t: float) -> float:
        return rate_rps if (t % burst_every_s) < burst_len_s else base

    return _thinned(rate, max(rate_rps, base), horizon_s, seed)


def diurnal_arrivals(rate_rps: float, horizon_s: float, seed: int = 0, *,
                     floor_frac: float = 0.1) -> np.ndarray:
    """sin² ramp: ``floor_frac * rate_rps`` at the edges of the horizon,
    ``rate_rps`` at the midpoint peak."""

    def rate(t: float) -> float:
        x = math.sin(math.pi * t / horizon_s) ** 2
        return rate_rps * (floor_frac + (1.0 - floor_frac) * x)

    return _thinned(rate, rate_rps, horizon_s, seed)


# name -> generator(rate_rps, horizon_s, seed) — the CLI / bench registry
TRAFFIC: Dict[str, Callable[..., np.ndarray]] = {
    "poisson": poisson_arrivals,
    "bursty": bursty_arrivals,
    "diurnal": diurnal_arrivals,
}


def make_requests(arrivals: Sequence[float], *, prompt_len: int = 16,
                  max_new_tokens: int = 8, vocab: int = 256, seed: int = 0,
                  deadline_s: Optional[float] = None) -> List[Request]:
    """One ``Request`` per arrival time (fresh objects — requests are
    mutated in flight, so build a new list per router run)."""
    rng = np.random.default_rng(seed)
    return [
        Request(rid=i,
                prompt=rng.integers(1, vocab, size=(prompt_len,),
                                    dtype=np.int32),
                max_new_tokens=max_new_tokens,
                arrival_t=float(t), deadline_s=deadline_s)
        for i, t in enumerate(arrivals)
    ]
