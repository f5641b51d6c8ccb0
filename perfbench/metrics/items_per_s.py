"""The offline classifier's rate: items whose results a completed job
merged, over the seconds from the window's start to the end of the last
job that ended within it."""
from perfbench.readings import items_per_s


def read(run):
    return items_per_s(run)
