"""Seconds of an epoch's train pass, from its start to its wait on the
losses, averaged over the window's epochs."""


def read(r):
    v = r["counters"].get("train_pass_s")
    return sum(v) / len(v) if v else None
