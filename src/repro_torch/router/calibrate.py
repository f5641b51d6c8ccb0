"""Calibrate the router's round-time model from MEASURED serving rows.

Counterpart of ``repro.router.calibrate``; the rounds it times end with
``torch.cuda.synchronize`` on the engine's device (nothing on the CPU).

The router's modeled round time is

    round_s = round_overhead_s
              + per_item_s * (prefill_tokens * prefill_token_factor
                              + active_slots)

The hand-set default is pure serial token-work (``round_overhead_s=0``),
which is wrong on real accelerators: a batched decode
round is closer to FLAT latency per dispatch (the whole point of the
one-dispatch-per-round cache), so the overhead term dominates at small
batch and the serial term only takes over as slots fill. FSD-Inference
(Oakley & Ferhatosmanoglu, 2024) makes the same point for serverless
workers: once workers stop sharing compute the latency model must be
*measured*, not assumed.

This module closes the loop. ``fit_round_model`` solves the linear
least-squares problem

    seconds ≈ a + b * prefill_tokens + c * active_slots

over measured ``RoundSample`` rows and reports
``round_overhead_s = a``, ``per_item_s = c``,
``prefill_token_factor = b / c`` plus the fit residuals. Samples come
from either

  * ``samples_from_bench`` — parse a recorded ``serving_bench`` payload
    (``BENCH_3.json``): ``prefill_b{B}_s{S}`` rows become pure-prefill
    samples and ``decode_step_b{B}`` rows pure-decode samples (the
    bench sweeps B so the overhead-vs-per-item split is determined); or
  * ``measure_round_samples`` — run real prefill/decode dispatches on a
    live engine and time them (what ``launch.serve --calibrate``
    does).

The fitted ``CalibratedLatencyModel`` is a JSON artifact
(``save``/``load``); hand it to ``RouterConfig(calibration=...)`` —
which errors loudly if hand-set round params are ALSO supplied — and
pair it with ``to_latency_model()`` so the pool's ``per_item_s`` stays
``None``. Fit a device's model from that device's own samples only.
"""
from __future__ import annotations

import dataclasses
import json
import re
import time
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.worker import LatencyModel

# serving_bench row names that are calibration samples
_PREFILL_RE = re.compile(r"prefill_b(\d+)_s(\d+)$")
_DECODE_RE = re.compile(r"decode_step_b(\d+)$")


@dataclasses.dataclass(frozen=True)
class RoundSample:
    """One measured scheduling round: how many prefill tokens and
    active decode slots it served, and how long it took."""

    prefill_tokens: int
    active_slots: int
    seconds: float
    source: str = ""


@dataclasses.dataclass(frozen=True)
class CalibratedLatencyModel:
    """Fitted round-time parameters + fit provenance (a JSON artifact).

    ``round_overhead_s`` is the flat per-dispatch cost (trace/launch/
    host sync — what real accelerators charge every round regardless of
    batch), ``per_item_s`` the marginal cost of one active decode slot,
    and ``prefill_token_factor`` the cost of one prefill token relative
    to one decode slot-step.
    """

    round_overhead_s: float
    per_item_s: float
    prefill_token_factor: float
    n_samples: int = 0
    rmse_s: float = 0.0
    max_abs_err_s: float = 0.0
    backend: str = ""
    device_count: int = 0
    source: str = ""

    def round_seconds(self, prefill_tokens: float,
                      active_slots: float) -> float:
        """The calibrated model evaluated at one round's work."""
        return (self.round_overhead_s
                + self.per_item_s * (prefill_tokens
                                     * self.prefill_token_factor
                                     + active_slots))

    # -- artifact I/O ---------------------------------------------------

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "CalibratedLatencyModel":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "CalibratedLatencyModel":
        with open(path) as f:
            return cls.from_json(json.load(f))

    # -- wiring into the router ----------------------------------------

    def to_router_config(self, **overrides) -> "RouterConfig":
        """A ``RouterConfig`` driving the calibrated model. Do NOT also
        hand-set ``round_overhead_s``/``prefill_token_factor`` — the
        config errors loudly on that conflict."""
        from repro_torch.router.router import RouterConfig
        return RouterConfig(calibration=self, **overrides)

    def to_latency_model(self, **overrides) -> LatencyModel:
        """A pool ``LatencyModel`` compatible with this calibration:
        ``per_item_s`` stays ``None`` (the calibration carries the
        per-item term; setting both is the loud-error case)."""
        overrides.setdefault("per_item_s", None)
        if overrides["per_item_s"] is not None:
            raise ValueError(
                "per_item_s is supplied by the calibration; a hand-set "
                "value here would silently disagree with it")
        return LatencyModel(**overrides)

    def summary(self) -> str:
        return (f"round_overhead={self.round_overhead_s * 1e3:.3f}ms "
                f"per_item={self.per_item_s * 1e3:.3f}ms "
                f"prefill_factor={self.prefill_token_factor:.4f} "
                f"(n={self.n_samples} rmse={self.rmse_s * 1e3:.3f}ms "
                f"on {self.backend or '?'})")


def fit_round_model(samples: Sequence[RoundSample], *, backend: str = "",
                    device_count: int = 0,
                    source: str = "") -> CalibratedLatencyModel:
    """Least-squares fit of (overhead, per_item, prefill_factor).

    The model is linear in ``a = round_overhead_s``,
    ``b = per_item_s * prefill_token_factor`` and ``c = per_item_s``, so
    ordinary least squares on the design matrix
    ``[1, prefill_tokens, active_slots]`` solves it exactly. Negative
    fitted coefficients (possible on noisy, near-degenerate sample sets)
    are clamped to zero — latencies are nonnegative — and the residuals
    are reported against the clamped model. Adding consistent sample
    rows can only constrain the fit further, never degrade it.
    """
    if len(samples) < 3:
        raise ValueError(
            f"need >= 3 measured rows to fit 3 parameters, got "
            f"{len(samples)} — sweep more (prefill_tokens, active_slots) "
            f"shapes (serving_bench's decode sweep provides them)")
    A = np.array([[1.0, s.prefill_tokens, s.active_slots] for s in samples],
                 dtype=np.float64)
    y = np.array([s.seconds for s in samples], dtype=np.float64)
    (a, b, c), *_ = np.linalg.lstsq(A, y, rcond=None)
    a, b, c = max(a, 0.0), max(b, 0.0), max(c, 0.0)
    per_item = float(c)
    factor = float(b / c) if c > 0 else 0.0
    # residuals against the model AS STORED (what round_seconds will
    # evaluate): when c clamps to 0 the artifact cannot express a
    # prefill-only cost (factor collapses to 0 too), and the reported
    # error must say so rather than flatter the fit
    pred = a + per_item * (A[:, 1] * factor + A[:, 2])
    resid = pred - y
    return CalibratedLatencyModel(
        round_overhead_s=float(a),
        per_item_s=per_item,
        prefill_token_factor=factor,
        n_samples=len(samples),
        rmse_s=float(np.sqrt(np.mean(resid ** 2))),
        max_abs_err_s=float(np.max(np.abs(resid))),
        backend=backend, device_count=device_count, source=source)


def samples_from_bench(record: dict) -> List[RoundSample]:
    """Extract calibration samples from a ``serving_bench`` record.

    ``prefill_b{B}_s{S}`` rows are pure-prefill rounds
    (``prefill_tokens = B*S``, no active slots); ``decode_step_b{B}``
    rows are pure-decode rounds (``active_slots = B``). Other rows
    (generate, continuous-batching, scheduler) mix phases and are
    skipped. serving_bench sweeps the decode batch size precisely so the
    resulting design matrix has full rank — a single decode point cannot
    separate flat overhead from per-item work.
    """
    out = []
    for row in record.get("rows", []):
        name, us = row["name"], float(row["us_per_call"])
        m = _PREFILL_RE.search(name)
        if m:
            b, s = int(m.group(1)), int(m.group(2))
            out.append(RoundSample(prefill_tokens=b * s, active_slots=0,
                                   seconds=us * 1e-6, source=name))
            continue
        m = _DECODE_RE.search(name)
        if m:
            out.append(RoundSample(prefill_tokens=0,
                                   active_slots=int(m.group(1)),
                                   seconds=us * 1e-6, source=name))
    return out


def measure_round_samples(engine, params, *,
                          slot_counts: Iterable[int] = (1, 2, 4, 8),
                          prompt_lens: Iterable[int] = (16, 32),
                          prefill_batch: int = 4, n_steps: int = 8,
                          max_len: Optional[int] = None
                          ) -> List[RoundSample]:
    """Measure real prefill/decode calls on ``engine`` (its device).

    One sample per prompt length (a pure-prefill round at
    ``prefill_batch`` rows) and one per slot count (a pure-decode round
    averaged over ``n_steps`` warm calls — the steady-state decode
    cadence the router models). Each shape is run once before timing so
    first-call costs (kernel build, allocator growth) never leak into
    the fit; what remains is the per-call overhead + per-item work the
    round model splits.
    """
    def sync():
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    samples = []
    for s in prompt_lens:
        prompt = np.ones((prefill_batch, s), np.int32)
        engine.prefill(params, prompt, max_len=max_len)  # warm
        sync()
        t0 = time.perf_counter()
        engine.prefill(params, prompt, max_len=max_len)
        sync()
        samples.append(RoundSample(
            prefill_tokens=prefill_batch * s, active_slots=0,
            seconds=time.perf_counter() - t0,
            source=f"measured:prefill_b{prefill_batch}_s{s}"))
    for b in slot_counts:
        prompt = np.ones((b, max(prompt_lens)), np.int32)
        _, cache = engine.prefill(params, prompt, max_len=max_len)
        tok = np.ones((b, 1), np.int32)
        _, cache = engine.decode(params, cache, tok)  # warm
        sync()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            _, cache = engine.decode(params, cache, tok)
        sync()
        samples.append(RoundSample(
            prefill_tokens=0, active_slots=b,
            seconds=(time.perf_counter() - t0) / n_steps,
            source=f"measured:decode_step_b{b}"))
    return samples
