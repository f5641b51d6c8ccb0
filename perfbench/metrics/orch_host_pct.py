"""Share of the window the host spent outside ``Engine.classify_logits``
(whose device-to-host copy waits for the device): the orchestrator's,
the functions' and the store's host work between invocations' compute."""
from perfbench.harness import window_s
from perfbench.readings import spans


def read(run):
    inside = sum(t1 - t0 for _, t0, t1, _ in spans(run, "classify")) / 1e9
    return 100.0 * (1.0 - inside / window_s(run)) if inside else None
