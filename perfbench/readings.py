"""What the metric readers share: the window's counted jobs, their spans
and calls, and the model FLOPs of the work they completed."""
from __future__ import annotations

from perfbench import flops
from perfbench.harness import window_s


def counted(run) -> set:
    return {j.index for j in run.counted}


def spans(run, *labels):
    keep = counted(run)
    return sorted((s for s in run.probes.spans
                   if s[0] in labels and s[3] in keep), key=lambda s: s[1])


def calls(run, label: str):
    keep = counted(run)
    return [c[1:] for c in run.probes.calls.get(label, ()) if c[0] in keep]


def kernel_s(run, fragment: str):
    """Device seconds of the kernels whose name holds ``fragment`` over
    the traced window; None where none ran or nothing was traced."""
    by_name = run.summary.get("by_name", {})
    s = sum(v for k, v in by_name.items() if fragment in k)
    return s or None


def done_items(run) -> int:
    return sum(j.items - j.missing for j in run.counted)


def model_flops(run) -> float:
    """FLOPs the completed items need: one classifier pass an item, or
    one prefill and the decode steps of a generated request."""
    cfg, mix = run.driver.mcfg, run.traffic
    if "max_new_tokens" in mix:
        per = flops.generate_flops(cfg, mix["prompt_len"],
                                   mix["max_new_tokens"])
    else:
        per = flops.classify_flops(cfg, mix["seq_len"])
    return per * done_items(run)


def mfu_pct(run) -> float:
    return 100.0 * model_flops(run) / (window_s(run)
                                       * flops.PEAK_BF16_FLOPS)


def items_per_s(run) -> float:
    """Items whose results a completed job merged, over the seconds from
    the window's start to the end of the last job that ended within it."""
    return done_items(run) / window_s(run)


def flash_roofline_pct(run):
    """The flash kernel's least time (``flops.least_s`` of every call's
    operations and bytes, counted from its shapes) over its summed device
    time in the traced window."""
    device = kernel_s(run, "flash_fwd_")
    todo = calls(run, "flash")
    if not device or not todo:
        return None
    least = sum(flops.least_s(flops.flash_flops(b, s, t, h, d, causal),
                              flops.flash_bytes(b, s, t, h, kv, d))
                for b, s, t, h, kv, d, causal in todo)
    return 100.0 * least / device


def idle_pct(run):
    """Share of the traced window (the counted jobs, between marker
    kernels) in which no operation ran on the device."""
    s = run.summary
    if not s.get("window_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
