"""Per-request trace spans as a structured JSONL event log.

Counterpart of ``repro.obs.trace``.

Every request's lifecycle is a span sequence

    queued -> admitted -> prefill -> decode_round* -> first_token
           -> finish | cancel | expire          (or: queued -> reject)

plus one ``round`` event per replica round carrying the round's
time-attribution buckets (prefill / decode_attention / sampler /
host_scheduler). The recorder itself never reads a clock — callers
stamp every event with *their* clock's time, so:

  * under ``VirtualClock`` the timestamps are the deterministic
    simulated times and two same-seed runs produce byte-identical
    trace files;
  * under ``WallClock`` the same call sites stamp host monotonic time.

Events are dicts ``{"t": float, "event": str, ...}`` appended to an
in-memory list (O(1) per event, no I/O on the hot path) and flushed to
JSONL by ``dump()``/``dumps()``. ``repro_torch.tools.trace_report``
turns the file back into a per-request waterfall and a per-round bucket
table; ``spans()`` groups events per request.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

# Request-lifecycle event names, in legal order of first occurrence.
SPAN_EVENTS = ("queued", "admitted", "prefill", "decode_round",
               "first_token", "finish", "cancel", "expire", "reject")
TERMINAL_EVENTS = ("finish", "cancel", "expire", "reject")
# Non-request events: per-round attribution + pool/scaling transitions.
SYSTEM_EVENTS = ("round", "replica_start", "replica_ready",
                 "replica_crash", "replica_retire", "scale")


class TraceRecorder:
    """Append-only trace sink. Callers stamp times; we never clock."""

    def __init__(self) -> None:
        self.events: List[dict] = []

    def emit(self, event: str, t: float, rid: Optional[int] = None,
             **fields) -> None:
        rec: Dict = {"t": float(t), "event": event}
        if rid is not None:
            rec["rid"] = rid
        if fields:
            rec.update(fields)
        self.events.append(rec)

    def __len__(self) -> int:
        return len(self.events)

    # ---- serialization ------------------------------------------------

    def dumps(self) -> str:
        """One JSON object per line; key order fixed by insertion so
        same-seed virtual runs serialize byte-identically."""
        return "".join(json.dumps(e, separators=(",", ":")) + "\n"
                       for e in self.events)

    def dump(self, path: str) -> int:
        """Write JSONL to ``path``; returns the number of events."""
        with open(path, "w") as f:
            f.write(self.dumps())
        return len(self.events)

    # ---- span reads ---------------------------------------------------

    def spans(self) -> Dict[int, List[dict]]:
        """Events grouped per rid, preserving emit order."""
        out: Dict[int, List[dict]] = {}
        for e in self.events:
            if "rid" in e:
                out.setdefault(e["rid"], []).append(e)
        return out

    def terminal(self, rid: int) -> Optional[str]:
        """The request's terminal event name, or None if still open."""
        for e in reversed(self.events):
            if e.get("rid") == rid and e["event"] in TERMINAL_EVENTS:
                return e["event"]
        return None


def load_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def spans_of(events: Iterable[dict]) -> Dict[int, List[dict]]:
    """`TraceRecorder.spans` over an already-loaded event list."""
    out: Dict[int, List[dict]] = {}
    for e in events:
        if "rid" in e:
            out.setdefault(e["rid"], []).append(e)
    return out
