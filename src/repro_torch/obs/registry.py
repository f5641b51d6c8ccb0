"""Metrics registry: Counter / Gauge / Histogram + Prometheus text.

Counterpart of ``repro.obs.registry``. Every
number the router, batcher, pool, and HTTP front door expose at scrape
time lives in ONE ``MetricsRegistry`` so ``GET /metrics`` is a render
of pre-aggregated state — no percentile math over completed-request
lists on the hot path (the bug ``EventRouter.live_stats`` used to
have).

Design constraints:

  * O(1) observe — counters/gauges are one dict update; histograms
    bisect a FIXED bucket-bound tuple (log-spaced, ~20 entries) so an
    observe costs one binary search + two adds, never a resize or a
    percentile pass.
  * snapshot without locking the hot path — ``snapshot()`` and
    ``render()`` copy plain dicts/lists under the GIL; writers never
    block on readers (no locks anywhere), and a scrape racing a round
    sees a consistent-enough point-in-time copy, never corruption.
  * label support — each metric owns its label NAMES; a child time
    series exists per label-VALUES tuple, created on first touch.
  * Prometheus text exposition — ``render()`` emits the v0.0.4 text
    format (HELP/TYPE preambles, escaped label values, cumulative
    ``_bucket{le=...}`` series with ``+Inf``, ``_sum``/``_count``).
    ``repro_torch.obs.promlint.lint_prometheus`` parses it back as the
    format lint.

Histogram quantile reads (``Histogram.quantile``) are bucket-boundary
estimates — O(n_buckets), good enough for a live dashboard; exact
percentiles stay where they always were, in ``RouterReport`` at end of
run.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple


def log_buckets(lo: float = 1e-4, hi: float = 100.0,
                per_decade: int = 3) -> Tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds covering [lo, hi]: exactly
    ``per_decade`` bounds per decade, so TTFT (~1e-1 s) and a decode
    round (~1e-3 s) land with the same relative resolution."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    bounds = []
    import math
    k = math.ceil(math.log10(lo) * per_decade)
    while True:
        b = 10.0 ** (k / per_decade)
        bounds.append(round(b, 12))
        if b >= hi:
            break
        k += 1
    return tuple(bounds)


DEFAULT_BUCKETS = log_buckets()


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _labels_str(names: Sequence[str], values: Sequence) -> str:
    if not names:
        return ""
    pairs = ", ".join(f'{n}="{_escape(v)}"'
                      for n, v in zip(names, values))
    return "{" + pairs + "}"


def _fmt(x: float) -> str:
    """Prometheus sample value: integers render bare, floats repr()."""
    if x == float("inf"):
        return "+Inf"
    if float(x).is_integer() and abs(x) < 1e15:
        return str(int(x))
    return repr(float(x))


class _Metric:
    """Shared child bookkeeping: one time series per label-values
    tuple. Metrics with no label names have exactly one child, ``()``."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)

    def _key(self, labels: dict) -> tuple:
        # fast path: unlabeled metrics (most of the catalog) skip the
        # set comparison — this is on the per-token hot path
        if not labels and not self.labelnames:
            return ()
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        return tuple(labels[n] for n in self.labelnames)


class Counter(_Metric):
    """Monotone non-decreasing count. ``inc`` is one dict add."""

    kind = "counter"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up "
                             f"(inc {amount})")
        # inline the unlabeled fast path — per-token hot path
        key = (() if not labels and not self.labelnames
               else self._key(labels))
        self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def samples(self) -> List[tuple]:
        return [(self.name, key, v)
                for key, v in sorted(self._values.items())]


class Gauge(_Metric):
    """Point-in-time value; ``set`` replaces, ``inc``/``dec`` adjust."""

    kind = "gauge"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        key = (() if not labels and not self.labelnames
               else self._key(labels))
        self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = (() if not labels and not self.labelnames
               else self._key(labels))
        self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def samples(self) -> List[tuple]:
        return [(self.name, key, v)
                for key, v in sorted(self._values.items())]


class Histogram(_Metric):
    """Fixed-bucket histogram: per-bucket counts + running sum/count.

    ``observe`` bisects the FIXED upper-bound tuple (O(log n_buckets)
    over ~20 entries — constant for any practical purpose) and
    increments one bucket counter; the +Inf bucket is implicit as
    ``count``. Rendering emits CUMULATIVE ``_bucket{le=...}`` series
    per the exposition format; the in-memory counts stay per-bucket so
    observes never touch more than one slot.
    """

    kind = "histogram"

    def __init__(self, name, help, labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(f"{self.name}: bucket bounds must be "
                             f"strictly increasing")
        self.bounds = bounds
        # per child: [counts per bound] + overflow, sum, count
        self._counts: Dict[tuple, List[int]] = {}
        self._sum: Dict[tuple, float] = {}
        self._n: Dict[tuple, int] = {}

    def _child(self, key: tuple) -> List[int]:
        if key not in self._counts:
            self._counts[key] = [0] * (len(self.bounds) + 1)
            self._sum[key] = 0.0
            self._n[key] = 0
        return self._counts[key]

    def observe(self, value: float, **labels) -> None:
        key = (() if not labels and not self.labelnames
               else self._key(labels))
        counts = self._child(key)
        counts[bisect_left(self.bounds, value)] += 1
        self._sum[key] += value
        self._n[key] += 1

    def count(self, **labels) -> int:
        return self._n.get(self._key(labels), 0)

    def sum(self, **labels) -> float:
        return self._sum.get(self._key(labels), 0.0)

    def cumulative(self, **labels) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs ending at (+Inf, n)."""
        key = self._key(labels)
        counts = self._counts.get(key, [0] * (len(self.bounds) + 1))
        out, c = [], 0
        for b, n in zip(self.bounds, counts):
            c += n
            out.append((b, c))
        out.append((float("inf"), c + counts[-1]))
        return out

    def quantile(self, q: float, **labels) -> float:
        """Bucket-boundary estimate of the q-quantile (0..1): the upper
        bound of the first bucket whose cumulative count covers q — the
        O(n_buckets) read ``live_stats`` serves scrapes from. NaN when
        empty; the last finite bound stands in for the +Inf bucket."""
        n = self.count(**labels)
        if n == 0:
            return float("nan")
        target = q * n
        for b, c in self.cumulative(**labels):
            if c >= target:
                return b if b != float("inf") else self.bounds[-1]
        return self.bounds[-1]

    def samples(self) -> List[tuple]:
        out = []
        for key in sorted(self._counts):
            for b, c in self.cumulative(
                    **dict(zip(self.labelnames, key))):
                out.append((self.name + "_bucket",
                            key + (("le", _fmt(b)),), c))
            out.append((self.name + "_sum", key, self._sum[key]))
            out.append((self.name + "_count", key, self._n[key]))
        return out


class MetricsRegistry:
    """Create-or-get metric factory + the Prometheus text renderer."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name, help, labelnames, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if type(m) is not cls or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-registered as {cls.__name__}"
                    f"{tuple(labelnames)} but exists as "
                    f"{type(m).__name__}{m.labelnames}")
            return m
        m = cls(name, help, labelnames, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name, help, labelnames=()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name, help, labelnames=()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name, help, labelnames=(),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames,
                         buckets=buckets)

    def get(self, name) -> Optional[_Metric]:
        return self._metrics.get(name)

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict copy of every time series — what ``live_stats``
        and tests read without touching render()."""
        out = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out[name] = {
                    "kind": m.kind,
                    "series": {key: {"count": m._n[key],
                                     "sum": m._sum[key],
                                     "counts": list(m._counts[key])}
                               for key in m._counts}}
            else:
                out[name] = {"kind": m.kind,
                             "series": dict(m._values)}
        return out

    def render(self) -> str:
        """Prometheus text exposition format v0.0.4."""
        lines = []
        for name, m in sorted(self._metrics.items()):
            lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for sample_name, key, value in m.samples():
                if key and isinstance(key[-1], tuple):  # histogram le
                    base, le = key[:-1], key[-1]
                    names = m.labelnames + (le[0],)
                    values = base + (le[1],)
                else:
                    names, values = m.labelnames, key
                lines.append(f"{sample_name}"
                             f"{_labels_str(names, values)} "
                             f"{_fmt(value)}")
        return "\n".join(lines) + "\n"
