"""Prompt rows through ``Engine.prefill`` and ``Engine.prefill_into`` per
completed item (1 where each prompt is prefilled once)."""
from perfbench.readings import counted, done_items


def read(run):
    keep = counted(run)
    rows = sum(n for (name, job), n in run.probes.counts.items()
               if name in ("prefill_rows", "admission_rows") and job in keep)
    return rows / done_items(run) if rows else None
