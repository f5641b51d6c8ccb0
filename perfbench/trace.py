"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

The profiler records the card's activity (CUPTI) over the window. At the
window's start and after each job the benchmark launches one marker
kernel (``torch.cuda._sleep``), so the trace cuts itself into jobs on the
device's own timeline: the window counted is [first marker, the marker
after the last job that ended within ``--seconds``). Busy time is the
union of every device operation's interval (kernels, copies, sets) in it;
idle gaps are labelled with the innermost host span (``harness.Probes``)
open at their middle, mapped onto the trace's clock through the first
marker.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional

MARKER = "spin_kernel"


class Tracer:
    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.marks: List[int] = []  # host ns just before each marker

    def start(self) -> None:
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def mark(self) -> None:
        if not self.on:
            return
        import torch
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter_ns())
        torch.cuda._sleep(1000)

    def stop(self) -> None:
        if not self.on:
            return
        import torch
        torch.cuda.synchronize()
        self.prof.stop()

    def read(self, n_counted: int, spans: List[tuple]) -> Optional[dict]:
        """Busy and window seconds, seconds by device op and idle seconds
        by host span over the counted window; None if the trace holds no
        device operation."""
        evs = []
        for e in self.prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                evs.append((e.start_ns(), e.end_ns(), e.name()))
        self.prof = None
        marks = sorted(s for s, _, n in evs if MARKER in n)
        if len(marks) <= n_counted:
            return None
        lo, hi = marks[0], marks[n_counted]
        ops = sorted((s, e, n) for s, e, n in evs
                     if MARKER not in n and e > lo and s < hi)
        if not ops:
            return None
        by_name: Dict[str, float] = {}
        busy, gaps, cur_s, cur_e = 0, [], None, None
        for s, e, n in ops:
            s, e = max(s, lo), min(e, hi)
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                else:
                    gaps.append((lo, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        gaps.append((cur_e, hi))
        return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9,
                "by_name": by_name,
                "idle_by_span": _label_gaps(gaps, spans,
                                            lo - self.marks[0])}


def _label_gaps(gaps, spans, offset: int) -> Dict[str, float]:
    """Idle seconds summed by the innermost host span open at each gap's
    middle ("harness" outside every span). Spans of one label never
    overlap each other; those of different labels nest (a job holds its
    calls). ``offset`` maps host ns onto the trace's clock."""
    by_label: Dict[str, list] = {}
    for name, t0, t1, _ in spans:
        by_label.setdefault(name, []).append((t0 + offset, t1 + offset))
    tables = []
    for name, ss in by_label.items():
        ss.sort()
        tables.append((name, [s for s, _ in ss], [e for _, e in ss]))
    out: Dict[str, float] = {}
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        label, width = "harness", None
        for name, starts, ends in tables:
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and ends[i] >= mid:
                w = ends[i] - starts[i]
                if width is None or w < width:
                    label, width = name, w
        out[label] = out.get(label, 0.0) + (g1 - g0) / 1e9
    return out


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
