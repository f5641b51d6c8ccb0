"""The flash kernel's share of its roofline in the classifier's jobs
(``readings.flash_roofline_pct``)."""
from perfbench.readings import flash_roofline_pct


def read(run):
    return flash_roofline_pct(run)
