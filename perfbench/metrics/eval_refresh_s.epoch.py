"""Seconds of an epoch's BN refresh and val and test evaluation (each
ending in a read of its errors), averaged over the window's epochs."""


def read(r):
    v = r["counters"].get("eval_refresh_s")
    return sum(v) / len(v) if v else None
