"""Seconds from process start to the window's start: imports, weights,
the system's set-up, kernel builds and warm-up."""


def read(run):
    return run.setup_s
