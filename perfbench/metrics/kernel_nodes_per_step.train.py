"""Kernel nodes of the captured train step's CUDA graph, counted in its
DOT dump as the capture ends: the kernels one step launches."""


def read(r):
    return r["counters"].get("kernel_nodes_per_step")
