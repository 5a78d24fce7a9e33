"""Kernel nodes of the captured train step's CUDA graph, counted in its
DOT dump as the capture ends: the kernels one step launches.
As `kernel_nodes_per_step.train`, in the cells that report
`dense_train_edges_per_s`."""


def read(r):
    return r["counters"].get("kernel_nodes_per_step")
