"""1 - the union of device operations' intervals over the profiled tail
(one epoch of graphed train steps), from the profiler's trace.
As `device_idle_frac.train`, in the cells that report
`dense_train_edges_per_s`."""


def read(r):
    t = r["trace"]
    if not t.get("window_s"):
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
