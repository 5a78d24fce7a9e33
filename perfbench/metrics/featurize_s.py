"""Seconds of the system's ESC featurization in set-up (the harness's
span around `featurize_many` over every split)."""


def read(r):
    return r["spans"].get("featurize")
