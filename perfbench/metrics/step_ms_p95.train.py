"""The 95th percentile of the intervals between CUDA events recorded after
each step of the traced tail (one step per call of the pool step), in
milliseconds."""

import numpy as np


def read(r):
    ms = r["counters"].get("step_ms")
    return float(np.percentile(ms, 95)) if ms else None
