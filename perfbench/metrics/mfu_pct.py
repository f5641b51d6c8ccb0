"""Model FLOPs of the completed work (one prefill a request, not the
admission's second) over the window's seconds times the bf16 peak."""
from perfbench.readings import mfu_pct


def read(run):
    return mfu_pct(run)
