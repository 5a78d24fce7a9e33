"""Seconds from the process's start to the window's start: CUDA's
start-up, the kernels' load or build, data generation, featurization, the
pools, the model, the warm-up and capture and the first three steps."""


def read(r):
    return r.get("setup_s")
