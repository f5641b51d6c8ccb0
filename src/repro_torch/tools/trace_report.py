"""Render a repro_torch.obs trace (JSONL) as waterfall + bucket tables.

Counterpart of the repo's ``tools/trace_report.py``, with the same
output. Input is the event log ``TraceRecorder.dump()`` writes (one JSON
object per line; ``python -m repro_torch.launch.serve --http --trace
FILE`` produces one). Output:

  * **per-request waterfall** — one row per rid, columns for the span
    timestamps (queued / admitted / first_token / terminal) plus
    derived TTFT, total latency, decode-round count, and outcome; an
    ASCII timeline bar shows queue-wait vs. in-flight time on a shared
    time axis.
  * **per-round time attribution** — the batcher's bucket taxonomy
    (prefill / decode_attention / sampler / host_scheduler) summed
    over ``round`` events, with per-bucket share-of-total and the
    unattributed residual.

    python -m repro_torch.tools.trace_report TRACE.jsonl [--width 48] [--limit N]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

# the batcher's round buckets (serving.batching.BUCKETS)
BUCKETS = ("prefill", "decode_attention", "sampler", "host_scheduler")
TERMINALS = ("finish", "cancel", "expire", "reject")


def load(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def spans_of(events: List[dict]) -> Dict[int, List[dict]]:
    out: Dict[int, List[dict]] = {}
    for e in events:
        if "rid" in e:
            out.setdefault(e["rid"], []).append(e)
    return out


def _first(span: List[dict], name: str):
    for e in span:
        if e["event"] == name:
            return e
    return None


def _fmt_s(t) -> str:
    return "      -" if t is None else f"{t:7.3f}"


def waterfall(events: List[dict], width: int = 48,
              limit: int = 0) -> List[str]:
    spans = spans_of(events)
    if not spans:
        return ["(no request spans in trace)"]
    t0 = min(e["t"] for e in events)
    t1 = max(e["t"] for e in events)
    scale = (width - 1) / max(t1 - t0, 1e-9)

    lines = [
        f"{'rid':>5} {'queued':>7} {'admit':>7} {'first':>7} "
        f"{'end':>7} {'ttft':>7} {'total':>7} {'rounds':>6} "
        f"{'outcome':<9} timeline (.=queued #=in-flight)",
    ]
    rids = sorted(spans)
    if limit:
        rids = rids[:limit]
    for rid in rids:
        span = spans[rid]
        tq = (_first(span, "queued") or {}).get("t")
        ta = (_first(span, "admitted") or {}).get("t")
        tf = (_first(span, "first_token") or {}).get("t")
        terminal = next((e for e in reversed(span)
                         if e["event"] in TERMINALS), None)
        te = terminal["t"] if terminal else None
        outcome = terminal["event"] if terminal else "open"
        n_rounds = sum(1 for e in span if e["event"] == "decode_round")
        ttft = (tf - tq) if (tf is not None and tq is not None) else None
        total = (te - tq) if (te is not None and tq is not None) else None

        bar = [" "] * width
        if tq is not None:
            i0 = int((tq - t0) * scale)
            i1 = int(((ta if ta is not None else te if te is not None
                       else tq) - t0) * scale)
            for i in range(i0, max(i1, i0) + 1):
                bar[i] = "."
            if ta is not None:
                iend = int(((te if te is not None else t1) - t0) * scale)
                for i in range(i1, max(iend, i1) + 1):
                    bar[i] = "#"
        lines.append(
            f"{rid:>5} {_fmt_s(tq)} {_fmt_s(ta)} {_fmt_s(tf)} "
            f"{_fmt_s(te)} {_fmt_s(ttft)} {_fmt_s(total)} "
            f"{n_rounds:>6} {outcome:<9} |{''.join(bar)}|")
    if limit and len(spans) > limit:
        lines.append(f"  ... {len(spans) - limit} more requests "
                     f"(--limit {limit})")
    return lines


def bucket_table(events: List[dict]) -> List[str]:
    rounds = [e for e in events if e["event"] == "round"]
    if not rounds:
        return ["(no round events in trace)"]
    total_s = sum(e.get("round_s", 0.0) for e in rounds)
    by_bucket = {b: 0.0 for b in BUCKETS}
    for e in rounds:
        for b, s in (e.get("buckets") or {}).items():
            by_bucket[b] = by_bucket.get(b, 0.0) + s
    attributed = sum(by_bucket.values())
    residual = total_s - attributed

    lines = [
        f"rounds: {len(rounds)}   total {total_s * 1e3:.3f} ms   "
        f"attributed {attributed * 1e3:.3f} ms "
        f"({100 * attributed / max(total_s, 1e-12):.1f}%)",
        f"{'bucket':<18} {'seconds':>12} {'share':>8}",
    ]
    for b in sorted(by_bucket, key=by_bucket.get, reverse=True):
        lines.append(f"{b:<18} {by_bucket[b]:>12.6f} "
                     f"{100 * by_bucket[b] / max(total_s, 1e-12):>7.1f}%")
    lines.append(f"{'(residual)':<18} {residual:>12.6f} "
                 f"{100 * residual / max(total_s, 1e-12):>7.1f}%")
    return lines


def report(events: List[dict], width: int = 48, limit: int = 0) -> str:
    out = ["== per-request waterfall =="]
    out += waterfall(events, width=width, limit=limit)
    out += ["", "== per-round time attribution (BENCH_8 buckets) =="]
    out += bucket_table(events)
    n_sys = sum(1 for e in events if "rid" not in e)
    out.append("")
    out.append(f"{len(events)} events ({n_sys} system), "
               f"{len(spans_of(events))} requests")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="JSONL trace file")
    ap.add_argument("--width", type=int, default=48,
                    help="timeline bar width (chars)")
    ap.add_argument("--limit", type=int, default=0,
                    help="show at most N requests (0 = all)")
    args = ap.parse_args(argv)
    events = load(args.trace)
    if not events:
        print("empty trace", file=sys.stderr)
        return 1
    print(report(events, width=args.width, limit=args.limit))
    return 0


if __name__ == "__main__":
    sys.exit(main())
