"""repro_torch.obs — live observability: metrics registry + request tracing.

Counterpart of ``repro.obs``: the same instruments, names and help text,
so the two packages render the same Prometheus text.

One ``Observability`` object carries everything the instrumented
layers need: a ``MetricsRegistry`` (Counter/Gauge/Histogram with
Prometheus text exposition — see registry.py) and an optional
``TraceRecorder`` (per-request JSONL spans — see trace.py). The
instruments themselves are pre-created here so the metric CATALOG has
exactly one definition and
call sites pay one attribute lookup + one dict update per event.

The contract that makes the layer safe to leave on: it is INERT.
``RouterCore(obs=None)`` (the default everywhere except the HTTP front
door) skips every hook; with obs on, the hooks only *read* state the
hot path already computed — never the engine, PRNG, or clock — so
token streams and summaries are bit-identical on vs. off at the same
seed (pinned by tests/test_torch_event_router.py for the sync and
event loops, dense and paged).
"""
from __future__ import annotations

from typing import Optional

from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       DEFAULT_BUCKETS, log_buckets)
from .trace import (TraceRecorder, SPAN_EVENTS, TERMINAL_EVENTS,
                    load_jsonl, spans_of)
from .promlint import lint_prometheus

__all__ = [
    "Observability", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "TraceRecorder", "DEFAULT_BUCKETS", "log_buckets",
    "lint_prometheus", "SPAN_EVENTS", "TERMINAL_EVENTS",
    "load_jsonl", "spans_of",
]

OUTCOMES = ("completed", "cancelled", "expired", "rejected")


class Observability:
    """Registry + instruments (+ optional tracer) for one serving run.

    ``tracer=None`` means metrics-only; pass ``TraceRecorder()`` to
    also collect spans. The object is cheap to construct and owns no
    threads, files, or clocks.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[TraceRecorder] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        r = self.registry

        # -- request lifecycle (RouterCore) --
        self.m_requests = r.counter(
            "repro_requests_total",
            "Requests reaching a terminal state, by outcome.",
            labelnames=("outcome",))
        self.m_admitted = r.counter(
            "repro_admitted_total", "Requests admitted into a replica.")
        self.m_tokens = r.counter(
            "repro_tokens_total", "Decode tokens emitted.")
        self.m_ttft = r.histogram(
            "repro_ttft_seconds", "Time from arrival to first token.")
        self.m_tpot = r.histogram(
            "repro_tpot_seconds",
            "Per-request mean time per output token.")
        self.m_queue_depth = r.gauge(
            "repro_queue_depth", "Arrival-queue depth after last round.")

        # -- rounds (RouterCore <- ContinuousBatcher) --
        self.m_round = r.histogram(
            "repro_round_seconds", "Wall/virtual seconds per replica round.")
        self.m_bucket_s = r.counter(
            "repro_round_bucket_seconds_total",
            "Round seconds attributed to BENCH_8 buckets.",
            labelnames=("bucket",))
        self.m_decode_dispatches = r.counter(
            "repro_decode_dispatches_total",
            "Batched decode dispatches (one per active round).")
        self.m_sampler_dispatches = r.counter(
            "repro_sampler_dispatches_total",
            "Host sampler dispatches (0 when fused_sampling).")
        self.m_compile_misses = r.counter(
            "repro_compile_misses_total",
            "Engine executable-cache misses (compile events).")
        self.m_on_token_errors = r.counter(
            "repro_on_token_errors_total",
            "Exceptions raised (and contained) by on_token subscribers.")

        # -- pool (ReplicaPool) --
        self.m_replicas = r.gauge(
            "repro_replicas", "Replicas by lifecycle state.",
            labelnames=("state",))
        self.m_cold_starts = r.counter(
            "repro_cold_starts_total", "Replica cold starts begun.")
        self.m_crashes = r.counter(
            "repro_crashes_total", "Replica crashes (injected or real).")
        self.m_busy_s = r.counter(
            "repro_busy_seconds_total",
            "Billable busy replica-seconds accumulated.")
        self.m_scale_events = r.counter(
            "repro_scale_events_total", "Autoscaler resize decisions.",
            labelnames=("direction",))

        # -- paged KV pool (ContinuousBatcher(paged=True)) --
        self.m_pages = r.gauge(
            "repro_page_pool_pages", "Physical KV pages by state.",
            labelnames=("state",))

        # -- batch DAG (repro_torch.batch.BatchDagRunner) --
        self.m_dag_tasks = r.gauge(
            "repro_dag_tasks", "Batch-DAG tasks by scheduler state.",
            labelnames=("state",))
        self.m_preemptions = r.counter(
            "repro_preemptions_total",
            "Spot/chaos kills that fired and preempted a DAG task.")
        self.m_stage_s = r.counter(
            "repro_dag_stage_seconds_total",
            "Billed busy seconds attributed to DAG stages.",
            labelnames=("stage",))

        # -- HTTP front door --
        self.m_http_inflight = r.gauge(
            "repro_http_inflight", "HTTP requests currently being served.")
        self.m_http_disconnects = r.counter(
            "repro_http_disconnects_total",
            "Client disconnects that cancelled an in-flight request.")

        # -- run-level --
        self.m_clock_s = r.gauge(
            "repro_clock_seconds", "Router clock at last round.")
        self.m_cost_usd = r.gauge(
            "repro_cost_usd", "Billed cost so far (busy-seconds model).")

    # Tracing helper: no-op unless a tracer is attached, so call sites
    # can emit unconditionally behind a single `if self.obs` guard.
    # Builds the record inline (same shape/key order as
    # TraceRecorder.emit) — one fewer call frame per event on the
    # per-token hot path.
    def trace(self, event: str, t: float, rid=None, **fields) -> None:
        tr = self.tracer
        if tr is None:
            return
        rec = {"t": float(t), "event": event}
        if rid is not None:
            rec["rid"] = rid
        if fields:
            rec.update(fields)
        tr.events.append(rec)
