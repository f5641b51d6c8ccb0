"""The chaos harness: deterministic preemption at DAG stage boundaries.

Counterpart of ``repro.batch.chaos``.

The invariant under test: **any prefix of kills
yields the same final outputs as the kill-free run** — task effects are
exactly-once under retries, so preemption changes the timeline and the
bill, never the answer.

The ladder builds kill schedules *incrementally* so every scheduled
kill provably fires: rung 0 is the kill-free run; rung k+1 takes rung
k's timeline, finds the first round after the last kill whose stage
hasn't been hit yet, and schedules a kill mid-that-round. Because the
runs are deterministic and the schedules agree on everything before the
new kill, the timeline up to that instant is IDENTICAL in rung k and
rung k+1 — the new kill lands exactly in the intended round (asserted
via ``n_preemptions == k``). Each rung's schedule is a strict prefix of
the next, so the ladder is literally the "any prefix of kills" quantifier
at every stage boundary.

``run_fn`` rebuilds the whole stack (fresh pools, fresh store, fresh
VirtualClock) for each rung — only the kill schedule differs.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.batch.runner import DagReport

# one kill = (group_idx, worker_id, t): feeds WorkerGroup construction
# as a FaultInjector ``crash_at_s`` entry for that group's pool
Kill = Tuple[int, int, float]


def kills_by_group(kills: List[Kill]) -> Dict[int, Tuple[Tuple[int, float],
                                                         ...]]:
    """Regroup a flat kill list into per-pool ``crash_at_s`` tuples."""
    out: Dict[int, List[Tuple[int, float]]] = {}
    for g, w, t in kills:
        out.setdefault(g, []).append((w, t))
    return {g: tuple(v) for g, v in out.items()}


def next_boundary_kill(timeline: List[dict], after_t: float,
                       killed_stages: set, frac: float = 0.5
                       ) -> Optional[Tuple[str, Kill]]:
    """First round after ``after_t`` in a stage not yet killed; the
    kill is placed ``frac`` of the way into that round."""
    for ev in sorted(timeline, key=lambda e: (e["t"], e.get("task", ""))):
        if ev["kind"] != "round" or ev.get("crashed"):
            continue
        if ev["t"] <= after_t + 1e-9 or ev["stage"] in killed_stages:
            continue
        g, w = ev["worker"]
        return ev["stage"], (g, w, ev["t"] + frac * ev["round_s"])
    return None


def chaos_ladder(run_fn: Callable[[Dict[int, Tuple[Tuple[int, float], ...]]],
                                  DagReport],
                 max_kills: Optional[int] = None
                 ) -> Tuple[List[DagReport], List[Kill]]:
    """Run the kill-free rung, then one more rung per un-killed stage.

    Returns ``(reports, kills)`` where ``reports[k]`` ran with
    ``kills[:k]`` — every prefix of the final schedule. Callers assert
    ``reports[k].digest == reports[0].digest`` (parity) and
    ``reports[k].n_preemptions == k`` (every kill fired).
    """
    reports = [run_fn({})]
    kills: List[Kill] = []
    killed: set = set()
    last_t = -1.0
    while max_kills is None or len(kills) < max_kills:
        nxt = next_boundary_kill(reports[-1].timeline, last_t, killed)
        if nxt is None:
            break
        stage, kill = nxt
        killed.add(stage)
        kills.append(kill)
        last_t = kill[2]
        reports.append(run_fn(kills_by_group(kills)))
    return reports, kills
