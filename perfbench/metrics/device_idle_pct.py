"""Share of the traced window in which no operation ran on the device
(``readings.idle_pct``)."""
from perfbench.readings import idle_pct


def read(run):
    return idle_pct(run)
