"""1 - the union of device operations' intervals over the profiled tail
(one whole epoch: train pass, BN refresh, val and test eval), from the
profiler's trace."""


def read(r):
    t = r["trace"]
    if not t.get("window_s"):
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
