"""The 95th percentile of every function invocation's duration in the
window's jobs (CUDA events around ``ServerlessFunction.invoke``)."""
import numpy as np


def read(run):
    ms = run.driver.invoke_ms(run.counted)
    return float(np.percentile(ms, 95)) if ms else None
