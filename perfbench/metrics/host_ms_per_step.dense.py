"""Host milliseconds inside the pool step's call per step, over the
window: the batch copies and graph launches it enqueues without a wait.
Below the step's device time, the host keeps ahead.
As `host_ms_per_step.train`, in the cells that report
`dense_train_edges_per_s`."""


def read(r):
    w, c = r.get("window"), r["counters"]
    if not w or "host_step_s" not in c:
        return None
    return c["host_step_s"] / w["steps"] * 1e3
